"""K2's plain version and the aggregation's ``splat_impl`` choices against
the JAX package on the CPU: the plain windowless forward against the Pallas
window kernel (interpret mode, a window that covers the image) in both
operand dtypes, its zeros for out-of-image and non-finite queries, one
cascade scale under ``packed_bilerp`` "pallas" with ``splat_impl``
"kernel2f", "kernel" and "adjoint" against ``jax.grad`` of the JAX
aggregation, and the wrapper's device rule. K2 itself runs only on the card
(tests/test_torch_cuda.py)."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gens_tpu.ops.pallas_splat as ps
from gens_tpu.models.volume import aggregate_scale as j_aggregate_scale
from gens_tpu.ops.pallas_splat import (bilerp_window_fwd as j_window_fwd,
                                       tile_grid_queries, untile_grid_queries)
from gens_torch.models.volume import aggregate_scale, splat_impl_at
from gens_torch.ops import splat as k1
from gens_torch.ops import window_fwd as k2
from gens_torch.ops.splat import resolve_splat_impl
from gens_torch.utils.profiling import counter

from _torch_common import t

H, W, C = 40, 56, 4
# a window that covers the whole (padded) image: the Pallas kernel then
# computes the windowless function on every query
FULL = (4096, 4096)


def _queries(rng, S=3, Y=32, Z=16):
    """Pixel coords of an (S, Y, Z) voxel grid's projection, with a margin
    past the image, live flags, and dead strays thrown far away. S·Y·Z/256
    = 6 tiles, which 4 tiles a step do not divide."""
    ys, zs = np.meshgrid(np.arange(Y), np.arange(Z), indexing="ij")
    u = zs * (W + 8) / Z - 4 + 0.31 * ys / Y
    v = ys * (H + 8) / Y - 4 + 0.17 * zs / Z
    xy = (np.stack([u, v], -1)[None] + rng.uniform(-2, 2, (S, 1, 1, 2))
          ).reshape(-1, 2)
    live = ((xy[:, 0] > -1) & (xy[:, 0] < W) & (xy[:, 1] > -1)
            & (xy[:, 1] < H)).astype(np.float32)
    dead = np.flatnonzero(rng.uniform(size=len(xy)) < 0.1)
    live[dead] = 0.0
    xy[dead[::2]] += rng.choice([-300.0, 300.0], size=(len(dead[::2]), 2))
    return xy.astype(np.float32), live, (S, Y, Z)


@pytest.fixture(scope="module")
def queries():
    rng = np.random.RandomState(0)
    xy, live, grid = _queries(rng)
    img = rng.randn(H, W, C).astype(np.float32)
    return img, xy, live, grid


def _pallas_window_fwd(img, xy, live, grid, mm_dtype):
    fn = jax.jit(lambda im, q, lv: untile_grid_queries(j_window_fwd(
        im, tile_grid_queries(q, grid),
        tile_grid_queries(lv[:, None], grid)[..., 0], window=FULL,
        interpret=True, mm_dtype=mm_dtype, tiles_per_step=4), grid))
    return np.asarray(fn(jnp.asarray(img), jnp.asarray(xy),
                         jnp.asarray(live)))


@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_window_fwd_plain_matches_pallas(queries, mm_dtype):
    img, xy, live, grid = queries
    jdt = jnp.bfloat16 if mm_dtype == "bfloat16" else jnp.float32
    ref = _pallas_window_fwd(img, xy, live, grid, jdt)
    got = k2.window_fwd_plain(t(img), t(xy), mm_dtype).numpy()
    keep = live > 0
    assert keep.sum() > 1000
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-5, atol=1e-6)
    if mm_dtype == "bfloat16":
        exact = k2.window_fwd_plain(t(img), t(xy), "float32").numpy()
        assert np.abs(got - exact).max() > 1e-3  # the rounding shows


def test_window_fwd_outside_and_nonfinite_give_zero():
    img = torch.randn((H, W, C))
    inf, nan = float("inf"), float("nan")
    xy = torch.tensor([[-1.0, 3.0], [float(W), 3.0], [3.0, -1.0],
                       [3.0, float(H)], [1e9, -1e9], [inf, 3.0],
                       [-inf, 3.0], [3.0, inf], [nan, 3.0], [3.0, nan],
                       [nan, nan], [-inf, inf]])
    for mm in ("float32", "bfloat16"):
        got = k2.window_fwd_plain(img, xy, mm)
        assert torch.equal(got, torch.zeros_like(got)), mm
    # just inside the border: one in-image corner, the rest zeros padding
    got = k2.window_fwd_plain(img, torch.tensor([[-0.5, 0.0]]), "float32")
    torch.testing.assert_close(got[0], 0.5 * img[0, 0], rtol=0, atol=0)


def test_window_fwd_wrapper_device_rule(queries):
    img, xy, _, _ = queries
    before = counter("k2.launches")
    got = k2.bilerp_window_fwd(t(img), t(xy), "bfloat16")
    assert counter("k2.launches") == before  # CPU: the plain version
    torch.testing.assert_close(got, k2.window_fwd_plain(t(img), t(xy),
                                                        "bfloat16"))
    with pytest.raises(ValueError):
        k2.bilerp_window_fwd(t(img).to("meta"), t(xy).to("meta"))
    with pytest.raises(ValueError):
        k2.bilerp_window_fwd(t(img), t(xy), "float16")


def test_resolve_splat_impl():
    assert resolve_splat_impl("auto") == "kernel2"
    for impl in ("kernel", "kernel2", "kernel2f", "adjoint"):
        assert resolve_splat_impl(impl) == impl
    with pytest.raises(ValueError):
        resolve_splat_impl("kernel3")
    # the JAX table_bf16 fallback at scales the kernels do not take
    assert splat_impl_at("pallas", 256, "kernel2f") == "kernel2f"
    assert splat_impl_at("pallas", 8, "kernel2f") == "adjoint"
    assert splat_impl_at("table_bf16", 256, "kernel") == "adjoint"


# -- one cascade scale through the aggregation ---------------------------------

DIM, VH, VW = 32, 48, 48


def _look_at(eye):
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
    c2w[:3, 3] = eye
    return c2w


@pytest.fixture(scope="module")
def rig():
    """Three views around the unit cube, close enough that part of the grid
    falls outside each image, random f32 feature maps, and the weights of a
    linear loss on the volume."""
    rng = np.random.RandomState(12)
    f = 40.0
    intr = np.array([[f, 0, VW / 2], [0, f, VH / 2], [0, 0, 1]], np.float32)
    c2ws = np.stack([_look_at(3.1 * np.array(
        [np.cos(a), np.sin(a), 0.3])) for a in (0.0, 2.1, 4.2)])
    return {"intrs": np.repeat(intr[None], 3, 0), "c2ws": c2ws,
            "feat": rng.randn(3, VH, VW, C).astype(np.float32),
            "w": rng.randn(DIM, DIM, DIM, 2 * C).astype(np.float32)}


def _jax_volume_and_grad(rig, impl, mm):
    patches = [mock.patch.object(ps, "splat_bilinear", functools.partial(
                   ps.splat_bilinear, interpret=True)),
               mock.patch.object(ps, "bilerp_window_fwd", functools.partial(
                   ps.bilerp_window_fwd, interpret=True))]

    def loss(feat):
        vol, _ = j_aggregate_scale(
            feat, jnp.asarray(rig["intrs"]), jnp.asarray(rig["c2ws"]), DIM,
            0, packed_bilerp="pallas", splat_window=FULL, splat_impl=impl,
            splat_mm_dtype=mm)
        return jnp.sum(vol * rig["w"]), vol

    with patches[0], patches[1]:
        (_, vol), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jnp.asarray(rig["feat"]))
    return np.asarray(vol), np.asarray(g)


def _port_volume_and_grad(rig, impl, mm):
    feat = t(rig["feat"]).requires_grad_(True)
    vol, _ = aggregate_scale(feat, t(rig["intrs"]), t(rig["c2ws"]), DIM, 0,
                             splat_mm_dtype=mm, splat_impl=impl)
    torch.sum(vol * t(rig["w"])).backward()
    return vol.detach().numpy(), feat.grad.numpy()


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_aggregate_kernel2f_matches_jax(rig, mm):
    """The K2 forward through the aggregation. f32 operands: the volume and
    the feature-map gradient (K1 in f32). bf16 operands: the volume. The two
    packages project the voxel grid with f32 roundings in another order
    (jnp.linspace is not torch.linspace bit for bit), and bf16(hat_v) jumps
    by up to 2^-8 of its value where a last-bit change crosses a rounding
    boundary: so in bf16 at least 99% of the values agree to the f32
    tolerance and the rest within 2^-7 of max |volume| (the variance
    channels double a jump). The same xy give the same bf16 values
    (test_bilerp_agg_splat_matches_jax)."""
    jvol, jg = _jax_volume_and_grad(rig, "kernel2f", mm)
    before = counter("k2.launches")
    vol, g = _port_volume_and_grad(rig, "kernel2f", mm)
    assert counter("k2.launches") == before  # CPU: the plain version
    if mm == "float32":
        np.testing.assert_allclose(vol, jvol, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g, jg, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(jg).max()))
        return
    err = np.abs(vol - jvol)
    close = err <= 1e-5 + 1e-4 * np.abs(jvol)
    assert close.mean() >= 0.99, close.mean()
    assert err.max() <= 2.0 ** -7 * np.abs(jvol).max(), err.max()


# -- the sampling function itself, on the same xy ------------------------------


@pytest.fixture(scope="module")
def agg_queries(queries):
    """The module's grid queries on an f32 map, the in-image mask as
    ``live``, and a cotangent with dead rows, as the aggregation gives."""
    img, xy, live, grid = queries
    rng = np.random.RandomState(3)
    ct = rng.randn(len(xy), C).astype(np.float32) * live[:, None]
    return img, xy, live, grid, ct


def _jax_bas(img, xy, live, grid, ct, impl, mm):
    from gens_tpu.ops.interp import pack_supercell2d

    packed = pack_supercell2d(jnp.asarray(img)[None])
    table_lo = packed.table[0].astype(jnp.bfloat16)
    jmm = jnp.bfloat16 if mm == "bfloat16" else jnp.float32

    def loss(im):
        vals = ps.bilerp_agg_splat(packed.dims, grid, FULL, impl, jmm, im,
                                   table_lo, jnp.asarray(xy),
                                   jnp.asarray(live))
        return jnp.sum(vals * ct), vals

    with mock.patch.object(ps, "splat_bilinear", functools.partial(
            ps.splat_bilinear, interpret=True)), \
         mock.patch.object(ps, "bilerp_window_fwd", functools.partial(
             ps.bilerp_window_fwd, interpret=True)):
        (_, vals), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jnp.asarray(img))
    return np.asarray(vals), np.asarray(g)


@pytest.mark.parametrize("impl", ["kernel2f", "kernel", "adjoint", "kernel2"])
def test_bilerp_agg_splat_matches_jax(agg_queries, impl):
    """bf16 operands on the same xy: the forward (K2's rounding under
    "kernel2f", the bf16 table elsewhere) and the image gradient (K1 in the
    fused_u rounding under "kernel2f" and "kernel2", the per_channel one
    under "kernel", the exact f32 adjoint under "adjoint"), each on every
    live query and pixel. The rounding of one impl is not another's."""
    img, xy, live, grid, ct = agg_queries
    jvals, jg = _jax_bas(img, xy, live, grid, ct, impl, "bfloat16")
    im = t(img).requires_grad_(True)
    vals = k1.bilerp_agg_splat(im, t(xy), "bfloat16", impl)
    torch.sum(vals * t(ct)).backward()
    keep = live > 0
    np.testing.assert_allclose(vals.detach().numpy()[keep], jvals[keep],
                               rtol=1e-5, atol=1e-6)
    scale = float(np.abs(jg).max())
    np.testing.assert_allclose(im.grad.numpy(), jg, rtol=1e-5,
                               atol=1e-6 * scale)
    others = {"kernel2f": "adjoint", "kernel": "kernel2",
              "adjoint": "kernel2", "kernel2": "kernel"}
    im2 = t(img).requires_grad_(True)
    torch.sum(k1.bilerp_agg_splat(im2, t(xy), "bfloat16", others[impl])
              * t(ct)).backward()
    assert np.abs(im2.grad.numpy() - jg).max() > 1e-4 * scale


def test_aggregate_adjoint_grad_matches_jax(rig):
    """"adjoint" through the whole aggregation scale: the exact f32 adjoint
    whatever splat_mm_dtype says (K1 in its bf16 rounding is ~1e-3 of max
    |grad| away)."""
    _, jg = _jax_volume_and_grad(rig, "adjoint", "bfloat16")
    _, g = _port_volume_and_grad(rig, "adjoint", "bfloat16")
    np.testing.assert_allclose(g, jg, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jg).max()))
    _, fused = _port_volume_and_grad(rig, "kernel2", "bfloat16")
    assert np.abs(fused - jg).max() > 1e-4 * np.abs(jg).max()
