"""K1's plain version and the aggregation backward against the JAX package
on the CPU: the plain splat against the Pallas splat kernel (interpret mode)
in f32 and in the shipped bf16 ``fused_u`` rounding, against the adjoint of
``bilerp``, and the feature-map gradient of the volume aggregation under
``packed_bilerp`` "table_bf16" and "pallas" against ``jax.grad``. K1 itself
runs only on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gens_tpu.models.volume import agg_mean_var as j_agg_mean_var
from gens_tpu.ops.pallas_splat import splat_bilinear as j_splat
from gens_tpu.ops.pallas_splat import tile_grid_queries
from gens_torch.models.volume import agg_mean_var, splat_dtype
from gens_torch.ops import splat as k1
from gens_torch.ops.interp import bilerp
from gens_torch.utils.profiling import counter

from _torch_common import scene_numpy, t

H, W, C = 40, 48, 4


def _grid_queries(rng, S=2, Y=32, Z=32, dead=0.25):
    """Pixel coords of an (S, Y, Z) voxel grid's projection (a pitch of
    ~1.6 px per voxel, a margin past the image on every side) and
    cotangents with some dead (all-zero) rows."""
    ys, zs = np.meshgrid(np.arange(Y), np.arange(Z), indexing="ij")
    u = zs * (W + 12) / Z - 6 + 0.37 * ys / Y
    v = ys * (H + 12) / Y - 6 + 0.21 * zs / Z
    xy = np.stack([u, v], -1)[None] + rng.uniform(-2, 2, (S, 1, 1, 2))
    ct = rng.randn(S * Y * Z, C)
    ct[rng.uniform(size=S * Y * Z) < dead] = 0.0
    return (xy.reshape(-1, 2).astype(np.float32), ct.astype(np.float32),
            (S, Y, Z))


@pytest.fixture(scope="module")
def queries():
    return _grid_queries(np.random.RandomState(0))


def _pallas(xy, ct, grid, mm_dtype, layout):
    xy_t = tile_grid_queries(jnp.asarray(xy), grid)
    ct_t = tile_grid_queries(jnp.asarray(ct), grid)
    return np.asarray(j_splat(xy_t, ct_t, (H, W), window=48, interpret=True,
                              mm_dtype=mm_dtype, layout=layout))


def test_splat_plain_matches_pallas_f32(queries):
    xy, ct, grid = queries
    ref = _pallas(xy, ct, grid, jnp.float32, "per_channel")
    got = k1.splat_plain(t(xy), t(ct), (H, W), "float32")
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_splat_plain_matches_pallas_bf16_fused_u(queries):
    # the shipped operand rounding: bf16(hat_v) * bf16(hat_u * ct), exact
    # products summed in f32 on both sides, in another order
    xy, ct, grid = queries
    ref = _pallas(xy, ct, grid, jnp.bfloat16, "fused_u")
    got = k1.splat_plain(t(xy), t(ct), (H, W), "bfloat16")
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    exact = k1.splat_plain(t(xy), t(ct), (H, W), "float32").numpy()
    assert np.abs(got.numpy() - exact).max() > 1e-4  # the rounding shows


def test_splat_plain_is_the_bilerp_adjoint(queries):
    xy, ct, _ = queries
    img = torch.zeros((H, W, C), requires_grad=True)
    bilerp(img, t(xy)).backward(t(ct))
    got = k1.splat_plain(t(xy), t(ct), (H, W), "float32")
    np.testing.assert_allclose(got.numpy(), img.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_splat_dead_and_far_queries_add_nothing():
    xy = torch.tensor([[float("nan"), 3.0], [1e9, -1e9], [-1.0, 5.0],
                       [float(W), 2.0], [3.5, 4.25]])
    ct = torch.ones((5, C))
    ct[0] = 0.0
    got = k1.splat_plain(xy, ct, (H, W))
    # only the last query lands: its four corners carry its full mass
    assert torch.count_nonzero(got.sum(-1)) == 4
    np.testing.assert_allclose(got.sum((0, 1)).numpy(), np.ones(C),
                               rtol=1e-6)


def test_splat_wrapper_device_rule(queries):
    xy, ct, _ = queries
    before = counter("k1.launches")
    got = k1.splat_bilinear(t(xy), t(ct), (H, W))
    assert counter("k1.launches") == before  # CPU: the plain version
    torch.testing.assert_close(got, k1.splat_plain(t(xy), t(ct), (H, W)))
    with pytest.raises(ValueError):
        k1.splat_bilinear(t(xy).to("meta"), t(ct).to("meta"), (H, W))
    with pytest.raises(ValueError):
        k1.splat_bilinear(t(xy), t(ct), (H, W), "float16")


@pytest.mark.parametrize("mm,layout", [("float32", "fused_u"),
                                       ("bfloat16", "fused_u"),
                                       ("bfloat16", "per_channel")])
def test_splat_dim_changes_nothing_on_the_cpu(mm, layout):
    """``dim`` says that the queries are a dim³ voxel grid (the kernel's
    bricks): on the CPU the image is the same with and without it, and a
    count of queries that is no cube of ``dim`` is refused."""
    rng = np.random.RandomState(7)
    dim = 9
    xy = t(rng.uniform(-2, [W + 2, H + 2], (dim ** 3, 2)).astype(np.float32))
    ct = t(rng.randn(dim ** 3, C).astype(np.float32))
    got = k1.splat_bilinear(xy, ct, (H, W), mm, layout, dim)
    torch.testing.assert_close(got, k1.splat_bilinear(xy, ct, (H, W), mm,
                                                      layout),
                               rtol=0, atol=0)
    torch.testing.assert_close(got, k1.splat_plain(xy, ct, (H, W), mm,
                                                   layout), rtol=0, atol=0)
    for bad in (8, -1):
        with pytest.raises(ValueError, match="dim"):
            k1.splat_bilinear(xy, ct, (H, W), mm, layout, bad)


@pytest.mark.parametrize("mode,dim,mm,want", [
    ("pallas", 256, "bfloat16", "bfloat16"),
    ("pallas", 16, "float32", "float32"),
    ("pallas", 8, "bfloat16", "float32"),   # the JAX table_bf16 fallback
    ("table_bf16", 256, "bfloat16", "float32"),
    ("table", 256, "bfloat16", None),
    (False, 256, "bfloat16", None),
])
def test_splat_dtype_per_scale(mode, dim, mm, want):
    assert splat_dtype(mode, dim, mm) == want


@pytest.mark.parametrize("mode", ["table_bf16", "pallas"])
def test_aggregation_feature_grad_is_f32_and_matches_jax(mode):
    """The bilinear sampling of the aggregation reads bf16-rounded maps,
    but the gradient w.r.t. the f32 feature maps is the f32 adjoint, as in
    the JAX package (mixed-table tangents; the splat's custom VJP)."""
    s = scene_numpy()
    rng = np.random.RandomState(1)
    dims = (32, 16, 8)
    V = s["imgs"].shape[0]
    feats = [rng.randn(V, 64 >> i, 64 >> i, C).astype(np.float32)
             for i in range(len(dims))]
    wts = [rng.randn(d, d, d, 2 * C).astype(np.float32) for d in dims]

    def j_loss(fs):
        vols, _ = j_agg_mean_var(fs, jnp.asarray(s["intrs"]),
                                 jnp.asarray(s["c2ws"]), dims,
                                 packed_bilerp=mode, splat_window=48,
                                 splat_mm_dtype="float32")
        return sum(jnp.sum(v * w) for v, w in zip(vols, wts))

    ref = jax.jit(jax.grad(j_loss))([jnp.asarray(f) for f in feats])
    fs = [t(f).requires_grad_(True) for f in feats]
    vols, _ = agg_mean_var(fs, t(s["intrs"]), t(s["c2ws"]), dims,
                           packed_bilerp=mode, splat_mm_dtype="float32")
    sum(torch.sum(v * t(w)) for v, w in zip(vols, wts)).backward()
    for f, r in zip(fs, ref):
        assert f.grad.dtype == torch.float32
        # not rounded to bf16 on the way back
        assert (f.grad.to(torch.bfloat16).float() != f.grad).any()
        # JAX's own f32 result is ~2e-5 of max |grad| from an f64
        # evaluation (the variance E[x²] - E[x]² cancels); a bf16-rounded
        # cotangent is off by ~1e-3 of max |grad|
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4 * float(np.abs(r).max()))
