"""K4 (gens_torch/ops/cascade_pe.py): the SDF grid's cascade lookup +
positional encoding.

On the CPU: the plain version against ``SDFNetwork.encode`` and against
gens_tpu's ``lookup_volume_cascade_packed`` + ``positional_encoding`` on
small f32 and bf16 cascades of unequal scales, with points inside and
outside [-1, 1]³ and a ragged N; the wrapper's refusals; ``sdf_fused_fn``
against the JAX ``sdf_fused_fn`` with no kernel launch counted.

On a card (marker ``cuda``, skipped elsewhere: the kernel has no CPU mode):
K4 against its plain version at the ``gens-bmvs`` widths, f32 and bf16, and
on cascades that take its per-channel path; one 64-plane slab of a 512³
grid through ``sdf_fused_fn`` against the plain lookup + plain MLP; one
``k4.launches`` a chunk. The card tests import neither jax nor gens_tpu:

    python -m pytest --noconftest -q tests/test_torch_cascade_pe.py -m cuda
"""

import os

import numpy as np
import pytest
import torch

from gens_torch import convert
from gens_torch.config import SDFNetConfig
from gens_torch.mesh.extract import eval_sdf_grid
from gens_torch.models.sdf_net import SDFNetwork
from gens_torch.ops import cascade_pe as k4
from gens_torch.ops import fused_mlp as fm
from gens_torch.ops.interp import trilerp
from gens_torch.utils.profiling import counter

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "quality_gen_r05_sharpen.pkl")
# unequal scales, no dimension equal to another
SHAPES = [(9, 7, 6, 4), (5, 4, 3, 4), (3, 2, 4, 4)]
SMALL = dict(d_out=17, d_hidden=48, n_layers=4, skip_in=(2,), multires=4,
             feat_channels=12, feat_multires=2, scale=1.5)
# gens-bmvs: a 256³ … 16³ cascade of 4 channels, multires 4 and 2
BMVS = [(d, d, d, 4) for d in (256, 128, 64, 32, 16)]
# the kernel's limit against its plain version: the same arithmetic, so
# bit-equal is expected; an ulp of a value near 8 is 9.5e-7
K4_ATOL = 1e-6
# K3's limits: f32 on both sides, sums in another order
RTOL, ATOL = 1e-4, 1e-5


def _cascade(shapes, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand(s, generator=g) * 4 - 2).to(dtype) for s in shapes]


def _points(n, seed, reach=1.3):
    """n points uniform in [-reach, reach]³, then the corners and faces of
    [-1, 1]³ on the first rows."""
    g = torch.Generator().manual_seed(seed)
    pts = (torch.rand((n, 3), generator=g) * 2 - 1) * reach
    edge = torch.tensor([[-1., -1., -1.], [1., 1., 1.], [1., -1., 0.],
                         [0., 0., 1.], [-1., 0.5, 1.]])
    pts[:len(edge)] = edge[:n]
    return pts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_encode(dtype):
    net = SDFNetwork(SDFNetConfig(**SMALL, volume_dtype=dtype))
    vols = _cascade(SHAPES, 0)
    pts = _points(77, 1)
    with torch.no_grad():
        ref = net.encode(pts, vols)
        got = k4.cascade_pe(pts, [v.to(getattr(torch, dtype)) for v in vols],
                            SMALL["scale"], SMALL["multires"],
                            SMALL["feat_multires"])
    assert got[0].shape == (77, 27) and got[1].shape == (77, 60)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert torch.equal(g, r)


def test_plain_takes_any_channel_count():
    vols = _cascade([(4, 5, 3, 3), (2, 3, 2, 1)], 2)
    pts = _points(33, 3)
    x_pe, feats_pe = k4.cascade_pe(pts, vols, 1.0, 0, 1)
    assert torch.equal(x_pe, pts)
    feats = torch.cat([trilerp(v, pts) for v in vols], -1)
    assert torch.equal(feats_pe, torch.cat(
        [feats, torch.sin(feats), torch.cos(feats)], -1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_packed(dtype):
    import jax.numpy as jnp

    from gens_tpu.models.embedder import positional_encoding
    from gens_tpu.ops.interp import lookup_volume_cascade_packed, pack_cascade

    vols = _cascade(SHAPES, 4, getattr(torch, dtype))
    pts = _points(77, 5)
    jvols = [jnp.asarray(v.float().numpy()).astype(getattr(jnp, dtype))
             for v in vols]
    flat, shapes, offsets = pack_cascade(jvols)
    jp = jnp.asarray(pts.numpy())
    feats = lookup_volume_cascade_packed(flat, shapes, offsets, jp)
    ref = (positional_encoding(jp * SMALL["scale"], SMALL["multires"]),
           positional_encoding(feats.astype(jnp.float32),
                               SMALL["feat_multires"]))
    got = k4.cascade_pe(pts, vols, SMALL["scale"], SMALL["multires"],
                        SMALL["feat_multires"])
    # XLA sums the 8 corners as a reduction, and its sin/cos are its own
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r, np.float32),
                                   rtol=1e-5, atol=2e-6)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


REFUSALS = {
    "scales": (lambda: (_meta((8, 3)), [_meta((2, 2, 2, 4))] * 9), "scales"),
    "no_scales": (lambda: (_meta((8, 3)), []), "scales"),
    "f16_volume": (lambda: (_meta((8, 3)), [_meta((2, 2, 2, 4),
                                                  torch.float16)]), "bf16"),
    "mixed_dtypes": (lambda: (_meta((8, 3)), [
        _meta((2, 2, 2, 4)), _meta((2, 2, 2, 4), torch.bfloat16)]), "bf16"),
    "f64_points": (lambda: (_meta((8, 3), torch.float64),
                            [_meta((2, 2, 2, 4))]), "points"),
    "strided_points": (lambda: (_meta((3, 8)).t(), [_meta((2, 2, 2, 4))]),
                       "points"),
    "strided_volume": (lambda: (_meta((8, 3)), [
        _meta((4, 2, 2, 2)).permute(1, 2, 3, 0)]), "contiguous"),
    "volume_rank": (lambda: (_meta((8, 3)), [_meta((8, 4))]), "contiguous"),
    "mixed_devices": (lambda: (torch.zeros((8, 3)), [_meta((2, 2, 2, 4))]),
                      "devices"),
    "other_device": (lambda: (_meta((8, 3)), [_meta((2, 2, 2, 4))]),
                     "devices"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses(case):
    make, match = REFUSALS[case]
    pts, vols = make()
    before = counter("k4.launches")
    with pytest.raises(ValueError, match=match):
        k4.cascade_pe(pts, vols, 1.0, 4, 2)
    assert counter("k4.launches") == before


def test_wrapper_refuses_wide_multires():
    with pytest.raises(ValueError, match="multires"):
        k4.cascade_pe(_meta((8, 3)), [_meta((2, 2, 2, 4))], 1.0,
                      k4.MAX_MULTIRES + 1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_fn_cpu_matches_jax(dtype):
    import jax
    import jax.numpy as jnp

    from gens_tpu.config import SDFNetConfig as JSDFCfg
    from gens_tpu.models.sdf_net import SDFNetwork as JSDF
    from gens_tpu.ops.pallas_mlp import sdf_fused_fn as j_fused_fn

    kw = dict(SMALL, feat_channels=8, scale=1.0)
    rng = np.random.RandomState(0)
    vols = [rng.rand(8 >> i, 7 >> i, 6 >> i, 4).astype(np.float32)
            for i in range(2)]
    pts = rng.uniform(-1.1, 1.1, (64, 3)).astype(np.float32)
    jnet = JSDF(JSDFCfg(**kw))
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                       [jnp.asarray(v) for v in vols])
    net = SDFNetwork(SDFNetConfig(**kw, volume_dtype=dtype))
    net.load_state_dict(convert.sdf_state(jax.tree.map(np.asarray, params),
                                          prefix=""), strict=True)
    # the JAX function looks the cascade up in the dtype it is given
    jvols = [jnp.asarray(v).astype(getattr(jnp, dtype)) for v in vols]
    ref = np.asarray(j_fused_fn(params, jnet.cfg, jvols, tile=32,
                                interpret=True)(jnp.asarray(pts[:50])))
    before = (counter("k3.launches"), counter("k4.launches"))
    got = fm.sdf_fused_fn(net, [torch.from_numpy(v) for v in vols])(
        torch.from_numpy(pts[:50]))
    assert got.shape == (50,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (counter("k3.launches"), counter("k4.launches")) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_fn_cpu_equals_encode_path(dtype):
    """The CPU ``sdf_fused_fn`` computes what ``encode`` + the plain MLP
    computed before K4, bit for bit."""
    net = SDFNetwork(SDFNetConfig(**dict(SMALL, feat_channels=12),
                                  volume_dtype=dtype))
    vols = _cascade(SHAPES, 6)
    pts = _points(45, 7)
    folded = fm.fold_sdf_mlp(net)
    with torch.no_grad():
        x_pe, f_pe = net.encode(pts, vols)
        ref = fm.sdf_mlp_plain(folded, x_pe, f_pe)[:, 0] / SMALL["scale"]
        got = fm.sdf_fused_fn(net, vols, folded)(pts)
    assert torch.equal(got, ref)


# -- on the card --------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _check_kernel(vols, pts, scale=1.0, multires=4, feat_multires=2):
    before = counter("k4.launches")
    got = k4.cascade_pe(pts, vols, scale, multires, feat_multires)
    torch.cuda.synchronize()
    assert counter("k4.launches") == before + 1
    ref = k4.cascade_pe_plain(pts, vols, scale, multires, feat_multires)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert float((g - r).abs().max()) <= K4_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_bmvs(card, dtype):
    vols = [v.to(card) for v in _cascade(BMVS, 8, getattr(torch, dtype))]
    r = torch.linspace(-1, 1, 512, device=card)
    gx, gy, gz = torch.meshgrid(r[300:301], r, r, indexing="ij")
    grid = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    pts = torch.cat([grid, _points(1077, 9).to(card)]).contiguous()
    _check_kernel(vols, pts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000])
def test_kernel_other_channels_and_ragged(card, dtype, n):
    """C = 3 and 1 take the per-channel path, as does a C = 4 scale whose
    base is not aligned for one load a row; unequal scales, points outside
    the volume, multires 0."""
    dt = getattr(torch, dtype)
    vols = [v.to(card) for v in _cascade(
        [(9, 7, 6, 3), (5, 4, 3, 1), (3, 2, 4, 4)], n, dt)]
    buf = torch.empty(vols[2].numel() + 1, dtype=dt, device=card)
    buf[1:] = vols[2].reshape(-1)
    vols.append(buf[1:].view(vols[2].shape))
    pts = _points(n, n + 1).to(card)
    _check_kernel(vols, pts, scale=1.5, multires=0, feat_multires=3)


@pytest.fixture(scope="module")
def sdf_net(card):
    net = SDFNetwork(SDFNetConfig())
    tree = convert.load_checkpoint(ARTIFACT)["params"]["sdf"]
    net.load_state_dict(convert.sdf_state(tree, prefix=""), strict=True)
    return net.to(card)


@pytest.mark.cuda
def test_fused_fn_slab_matches_plain(card, sdf_net):
    """One 64-plane slab of a 512³ grid: ``sdf_fused_fn`` (K4, then K3)
    against the plain lookup + plain MLP, one K4 and one K3 launch a
    64³ chunk."""
    vols = [v.to(card) for v in _cascade(BMVS, 10)]
    folded = fm.fold_sdf_mlp(sdf_net, device=card)
    scale = sdf_net.cfg.scale

    def plain_sdf(p):
        x_pe, f_pe = sdf_net.encode(p, vols)
        return fm.sdf_mlp_plain(folded, x_pe, f_pe)[:, 0] / scale

    before = (counter("k3.launches"), counter("k4.launches"))
    with torch.no_grad():
        got = eval_sdf_grid(fm.sdf_fused_fn(sdf_net, vols, folded),
                            [-1] * 3, [1] * 3, 512, card, x_range=(256, 320))
        ref = eval_sdf_grid(plain_sdf, [-1] * 3, [1] * 3, 512, card,
                            x_range=(256, 320))
    chunks = 64 * 512 * 512 // 64 ** 3
    assert (counter("k3.launches"), counter("k4.launches")) == (
        before[0] + chunks, before[1] + chunks)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
