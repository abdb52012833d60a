"""The host side of K3's tensor-core design (gens_torch/ops/fused_mlp.py),
on the CPU (the kernels' build is tested in tests/test_torch_libraries.py).

K3 multiplies in 3xTF32: hi = tf32_rna(v), lo = tf32_rna(v - hi), the
product hi·hi + hi·lo + lo·hi. These tests hold the TF32 rounding to
``cvt.rna.tf32.f32`` (to nearest, ties away from zero), the split of the
folded weights, the packed K-major tiles the kernel streams, and -- by a
float64 emulation of the three products -- that the design meets the
kernel's limits against ``sdf_mlp_plain`` before any card runs it. The
kernel itself runs in tests/test_torch_cuda.py."""

import os

import numpy as np
import pytest
import torch

from gens_torch import convert
from gens_torch.config import SDFNetConfig
from gens_torch.models.sdf_net import SDFNetwork
from gens_torch.ops import fused_mlp as fm

import _torch_common  # noqa: E402,F401  (one torch thread per worker)

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "quality_gen_r05_sharpen.pkl")
SMALL = dict(d_out=17, d_hidden=48, n_layers=4, skip_in=(2,), multires=4,
             feat_channels=8, feat_multires=2)
# the kernel's limits against its plain version
RTOL, ATOL = 1e-4, 1e-5


def _bits(x):
    return torch.tensor(x, dtype=torch.float32).view(torch.int32).item() \
        & 0xFFFFFFFF


def _rna_ref(x: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, ties away from zero, in float64."""
    m, e = np.frexp(x.astype(np.float64))  # |m| in [0.5, 1)
    scale = np.ldexp(1.0, 11 - e)
    return (np.sign(x) * np.floor(np.abs(x) * scale + 0.5) / scale
            ).astype(np.float32)


@pytest.mark.parametrize("x,want", [
    (1 + 2.0 ** -11, 1 + 2.0 ** -10),          # a tie goes away from zero
    (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),
    (1 + 2.0 ** -11 - 2.0 ** -23, 1.0),        # just below the tie
    (1 + 3 * 2.0 ** -11, 1 + 2.0 ** -9),       # a tie above an odd value
    (2 - 2.0 ** -11, 2.0),                     # the carry into the exponent
    (2.0 ** -136, 2.0 ** -136),                # the least TF32 subnormal
    (2.0 ** -137, 2.0 ** -136),                # a subnormal tie
    (3 * 2.0 ** -140, 0.0),                    # below half of it
    (0.0, 0.0), (1.5, 1.5)])
def test_tf32_rna_ties(x, want):
    got = fm.tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want and _bits(got.item()) & 0x1FFF == 0


def test_tf32_rna_keeps_sign_of_zero_inf_and_nan():
    x = torch.tensor([-0.0, float("inf"), -float("inf"), float("nan")])
    got = fm.tf32_rna(x)
    assert torch.equal(got.view(torch.int32)[:3], x.view(torch.int32)[:3])
    assert torch.isnan(got[3])


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (-1e-20, 1e-20),
                                   (-1e30, 1e30)])
def test_tf32_rna_matches_round_half_away(lo, hi):
    x = np.random.RandomState(0).uniform(lo, hi, 100_000).astype(np.float32)
    got = fm.tf32_rna(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), _rna_ref(x))
    assert int((got.view(torch.int32) & 0x1FFF).abs().max()) == 0


def _net(kind):
    torch.manual_seed(0)
    if kind == "small":
        return SDFNetwork(SDFNetConfig(**SMALL))
    net = SDFNetwork(SDFNetConfig())
    if kind == "artifact":
        tree = convert.load_checkpoint(ARTIFACT)["params"]["sdf"]
        net.load_state_dict(convert.sdf_state(tree, prefix=""), strict=True)
    return net


@pytest.fixture(scope="module", params=["small", "full", "artifact"])
def folded(request):
    return fm.fold_sdf_mlp(_net(request.param))


def test_split_rebuilds_every_weight(folded):
    for w, _ in folded.weights:
        hi, lo = fm.split_tf32(w)
        assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
        assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
        err = (hi.double() + lo.double() - w.double()).abs()
        assert bool((err <= 2.0 ** -22 * w.double().abs()).all())


def test_packed_tiles_and_biases_unpack_to_the_weights(folded):
    tc = folded.tc
    n_t = fm.TC_N
    assert tc.shape == (2 * len(folded.weights) * n_t,
                        fm.tc_k_alloc(folded.weights))
    assert tc.shape[1] % fm.TC_KS == 0 and tc.dtype == torch.float32
    covered = torch.zeros_like(tc, dtype=torch.bool)
    for l, (w, _) in enumerate(folded.weights):
        k, n = w.shape
        hi = tc[2 * l * n_t:2 * l * n_t + n, :k].t()
        lo = tc[(2 * l + 1) * n_t:(2 * l + 1) * n_t + n, :k].t()
        assert torch.equal(hi, fm.tf32_rna(w))
        assert torch.equal(lo, fm.tf32_rna(w - hi))
        err = (hi.double() + lo.double() - w.double()).abs()
        assert bool((err <= 2.0 ** -22 * w.double().abs()).all())
        covered[2 * l * n_t:2 * l * n_t + n, :k] = True
        covered[(2 * l + 1) * n_t:(2 * l + 1) * n_t + n, :k] = True
    # the padding is exactly zero (+0.0)
    assert int(tc.view(torch.int32)[~covered].abs().max()) == 0
    # the biases, (L, TC_N), zero padded
    assert folded.bias.shape == (len(folded.weights), n_t)
    for l, (_, b) in enumerate(folded.weights):
        assert torch.equal(folded.bias[l, :b.numel()], b)
        pad = folded.bias[l, b.numel():]
        assert pad.numel() == 0 or int(pad.view(torch.int32).abs().max()) == 0


def _emulate_3xtf32(f, x_pe, feats_pe):
    """K3's arithmetic on the CPU: every product split into hi·hi + hi·lo +
    lo·hi (float64 sums), the epilogue in f32 as the kernel does it."""
    h = x_pe
    n = len(f.weights)
    for l, (w, b) in enumerate(f.weights):
        if f.skip[l]:
            h = torch.cat([h, x_pe], dim=-1) * fm._INV_SQRT2
        if 0 < l:
            h = torch.cat([h, feats_pe], dim=-1)
        ah, al = (v.double() for v in fm.split_tf32(h))
        wh, wl = (v.double() for v in fm.split_tf32(w))
        h = (ah @ wh + ah @ wl + al @ wh).float() + b
        if l < n - 1:
            z = h * 100.0
            h = (torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-z.abs()))
                 ) / 100.0
    return h


def test_three_products_meet_the_kernel_limits(folded):
    rng = np.random.RandomState(3)
    x_pe = torch.from_numpy(rng.uniform(
        -1, 1, (2048, folded.d_x)).astype(np.float32))
    feats_pe = torch.from_numpy(rng.uniform(
        -1, 1, (2048, folded.d_feat)).astype(np.float32))
    got = _emulate_3xtf32(folded, x_pe, feats_pe)
    torch.testing.assert_close(got, fm.sdf_mlp_plain(folded, x_pe, feats_pe),
                               rtol=RTOL, atol=ATOL)


def test_fold_leaves_wide_layers_to_no_kernel():
    torch.manual_seed(0)
    net = SDFNetwork(SDFNetConfig(**dict(SMALL, d_hidden=fm.TC_N + 8)))
    f = fm.fold_sdf_mlp(net)
    assert f.tc is None and f.bias is None
