"""K3, K1, K2 and P1-P3 on the card: each CUDA kernel against its plain
PyTorch version (K3 on the trained weights, K1 and K2 on random queries,
P1-P3 on random tables), including ragged sizes (K3 at one 128-row tile
and one row either side, P3 at widths 8 and 136), K1's all-dead queries,
both of its bf16 roundings and its voxel-grid path (pile-ups, bricks that
overflow the shared tile, ragged grids, queries outside the frustum), K2's
out-of-image and non-finite queries, P1/P2's clamped and P3's zero rows for
indices outside the table, and the wrappers' input checks.
Imports neither jax nor gens_tpu, so it runs on a machine with only PyTorch
and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Skipped where there is no CUDA device (the kernel has no CPU mode)."""

import os

import pytest
import torch

from gens_torch import convert
from gens_torch.config import SDFNetConfig
from gens_torch.models.sdf_net import SDFNetwork
from gens_torch.ops import fused_mlp as fm
from gens_torch.ops import gather as gk
from gens_torch.ops import splat as k1
from gens_torch.ops import window_fwd as k2
from gens_torch.utils.profiling import counter

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "quality_gen_r05_sharpen.pkl")
# f32 on both sides, sums in another order
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def folded():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    net = SDFNetwork(SDFNetConfig())
    tree = convert.load_checkpoint(ARTIFACT)["params"]["sdf"]
    net.load_state_dict(convert.sdf_state(tree, prefix=""), strict=True)
    return fm.fold_sdf_mlp(net, device=torch.device("cuda"))


def _inputs(n, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 27), generator=g) * 2 - 1
    f = torch.rand((n, 100), generator=g) * 2 - 1
    return x.cuda(), f.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 127, 128, 129, 1000, 65537, 262144])
def test_kernel_matches_plain(folded, n):
    x, f = _inputs(n, n)
    before = counter("k3.launches")
    got = fm.sdf_mlp_fused(folded, x, f)
    torch.cuda.synchronize()
    assert counter("k3.launches") == before + 1
    torch.testing.assert_close(got, fm.sdf_mlp_plain(folded, x, f),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_wrapper_checks_inputs(folded):
    x, f = _inputs(8, 0)
    with pytest.raises(ValueError):
        fm.sdf_mlp_fused(folded, x.double(), f)
    with pytest.raises(ValueError):
        fm.sdf_mlp_fused(folded, x[:, :20], f)
    with pytest.raises(ValueError):
        fm.sdf_mlp_fused(folded, x.t().contiguous().t(), f)


# K1 against its plain version, as a fraction of max |plain|: both add each
# pixel's terms with float atomics in a run-dependent order
K1_TOL = 1e-4


def _queries(n, hw, c, seed, dead=0.3):
    g = torch.Generator().manual_seed(seed)
    H, W = hw
    # a margin beyond the image on every side exercises the zeros padding
    xy = torch.rand((n, 2), generator=g) * torch.tensor([W + 4.0, H + 4.0]) - 2
    ct = torch.randn((n, c), generator=g)
    ct[torch.rand((n,), generator=g) < dead] = 0.0
    return xy.cuda(), ct.cuda()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16",
                                      "bfloat16-per_channel"])
@pytest.mark.parametrize("n,hw,c", [(1, (30, 40), 4), (255, (30, 40), 4),
                                    (100003, (120, 160), 4),
                                    (4097, (60, 80), 3)])
def test_splat_matches_plain(card, mm_dtype, n, hw, c):
    mm_dtype, _, layout = mm_dtype.partition("-")
    layout = layout or "fused_u"
    xy, ct = _queries(n, hw, c, n)
    before = counter("k1.launches")
    got = k1.splat_bilinear(xy, ct, hw, mm_dtype, layout)
    torch.cuda.synchronize()
    assert counter("k1.launches") == before + 1
    ref = k1.splat_plain(xy, ct, hw, mm_dtype, layout)
    assert got.shape == (hw[0], hw[1], c)
    assert float((got - ref).abs().max()) <= K1_TOL * float(ref.abs().max())


@pytest.mark.cuda
def test_splat_all_dead_queries_add_nothing(card):
    xy, ct = _queries(5000, (30, 40), 4, 0)
    # dead queries may carry any coordinates, non-finite ones included
    xy[::2] = float("nan")
    got = k1.splat_bilinear(xy, torch.zeros_like(ct), (30, 40))
    torch.cuda.synchronize()
    assert torch.count_nonzero(got) == 0


@pytest.mark.cuda
def test_bilerp_agg_splat_backward_on_card(card):
    xy, _ = _queries(20000, (30, 40), 4, 1, dead=0.0)
    img = torch.randn((30, 40, 4), generator=torch.Generator().manual_seed(2))
    ct = torch.randn((20000, 4), generator=torch.Generator().manual_seed(3))
    grads = []
    for dev in ("cpu", "cuda"):
        im = img.detach().to(dev).requires_grad_(True)
        out = k1.bilerp_agg_splat(im, xy.to(dev), "float32")
        out.backward(ct.to(dev))
        grads.append(im.grad.cpu())
    assert float((grads[0] - grads[1]).abs().max()) <= K1_TOL * float(
        grads[0].abs().max())


@pytest.mark.cuda
def test_splat_wrapper_checks_inputs(card):
    xy, ct = _queries(64, (30, 40), 4, 0)
    with pytest.raises(ValueError):
        k1.splat_bilinear(xy.double(), ct, (30, 40))
    with pytest.raises(ValueError):
        k1.splat_bilinear(xy, ct.t().contiguous().t(), (30, 40))
    with pytest.raises(ValueError):
        k1.splat_bilinear(xy, ct, (30, 40), "float16")


def _grid_queries(dim, hw, c, seed, shift=0.0, nan_rows=0):
    """The dim³ voxel grid of [-1, 1]³ (x-major, z fastest) seen by a pinhole
    camera 3.5 away along a seeded direction, filling about half the
    image's height (every 8³ brick's footprint then fits the shared tile);
    ``shift`` moves the principal point by that share of the width (part
    of the grid then falls outside the frustum); ``nan_rows`` live queries
    get NaN coordinates."""
    g = torch.Generator().manual_seed(seed)
    H, W = hw
    r = torch.linspace(-1.0, 1.0, dim)
    pts = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        -1, 3)
    rot, _ = torch.linalg.qr(torch.randn((3, 3), generator=g))
    cam = pts @ rot.T
    f = 0.4 * H
    z = cam[:, 2] + 3.5
    xy = torch.stack([f * cam[:, 0] / z + W * (0.5 + shift),
                      f * cam[:, 1] / z + H / 2], -1)
    ct = torch.randn((dim ** 3, c), generator=g)
    rows = torch.randperm(dim ** 3, generator=g)[:nan_rows]
    xy[rows] = float("nan")
    return xy.contiguous().cuda(), ct.cuda()


def _pile_up(dim, hw, c, seed):
    """Every query of a dim³ grid within 2 px of one pixel."""
    g = torch.Generator().manual_seed(seed)
    centre = torch.tensor([hw[1] * 0.4 + 0.3, hw[0] * 0.6 + 0.7])
    xy = centre + (torch.rand((dim ** 3, 2), generator=g) * 4 - 2)
    return xy.cuda(), torch.randn((dim ** 3, c), generator=g).cuda()


# K1's voxel-grid cases: (xy and ct for C channels, the image, the dim passed
# to the kernel, whether every live brick must fit the shared tile (True),
# overflow it (False) or either (None))
K1_CASES = {
    "pile_up": (lambda c: _pile_up(16, (30, 40), c, 5), (30, 40), 16, True),
    # one brick spread over the whole image: its box overflows the tile
    "overflow": (lambda c: _queries(8 ** 3, (120, 160), c, 6, dead=0.0),
                 (120, 160), 8, False),
    "grid_20": (lambda c: _grid_queries(20, (120, 160), c, 8), (120, 160),
                20, True),
    "grid_17": (lambda c: _grid_queries(17, (120, 160), c, 9), (120, 160),
                17, True),
    "unstructured": (lambda c: _queries(70001, (120, 160), c, 10),
                     (120, 160), 0, None),
    "frustum_nan": (lambda c: _grid_queries(24, (120, 160), c, 11, shift=0.4,
                                            nan_rows=500), (120, 160), 24,
                    None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 3])
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16",
                                      "bfloat16-per_channel"])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_splat_bricks_match_plain(card, case, mm_dtype, c):
    """K1 on the voxel-grid path (``dim``): a pile-up onto one pixel, a brick
    whose footprint overflows the shared tile, grids that are no multiple
    of the brick, unstructured ``xy``, and a grid partly outside the image
    with NaN coordinates."""
    mm_dtype, _, layout = mm_dtype.partition("-")
    layout = layout or "fused_u"
    make, hw, dim, fits = K1_CASES[case]
    xy, ct = make(c)
    k1.brick_counts()
    got = k1.splat_bilinear(xy, ct, hw, mm_dtype, layout, dim)
    live, direct = k1.brick_counts()
    ref = k1.splat_plain(xy, ct, hw, mm_dtype, layout)
    assert float(ref.abs().max()) > 0
    assert float((got - ref).abs().max()) <= K1_TOL * float(ref.abs().max())
    assert live > 0
    if fits is not None:
        assert (direct == 0) if fits else (direct == live), (live, direct)


@pytest.mark.cuda
def test_splat_dim_checks(card):
    xy, ct = _grid_queries(8, (30, 40), 4, 0)
    with pytest.raises(ValueError):
        k1.splat_bilinear(xy, ct, (30, 40), dim=7)


# K2 against its plain version, as a fraction of max |plain|: the same
# operand rounding, products and sums in the same order, but nvcc may
# contract a multiply-add into an FMA
K2_TOL = 1e-5


def _image(hw, c, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((hw[0], hw[1], c), generator=g).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,hw,c", [(1, (30, 40), 4), (255, (30, 40), 4),
                                    (100003, (120, 160), 4),
                                    (100003, (60, 80), 3)])
def test_window_fwd_matches_plain(card, mm_dtype, n, hw, c):
    xy, _ = _queries(n, hw, 1, n)
    img = _image(hw, c, n + 1)
    before = counter("k2.launches")
    got = k2.bilerp_window_fwd(img, xy, mm_dtype)
    torch.cuda.synchronize()
    assert counter("k2.launches") == before + 1
    ref = k2.window_fwd_plain(img, xy, mm_dtype)
    assert got.shape == (n, c) and got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= K2_TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 3])
def test_window_fwd_outside_and_nonfinite_give_zero(card, c):
    inf, nan = float("inf"), float("nan")
    H, W = 30, 40
    xy = torch.tensor([[-1.0, 3.0], [float(W), 3.0], [3.0, -1.0],
                       [3.0, float(H)], [1e9, -1e9], [inf, 3.0],
                       [-inf, 3.0], [3.0, inf], [nan, 3.0], [3.0, nan],
                       [nan, nan], [-inf, inf]] * 100).cuda()
    img = _image((H, W), c, 0)
    for mm in ("float32", "bfloat16"):
        got = k2.bilerp_window_fwd(img, xy, mm)
        torch.cuda.synchronize()
        assert torch.count_nonzero(got) == 0, mm


@pytest.mark.cuda
def test_window_fwd_wrapper_checks_inputs(card):
    xy, _ = _queries(64, (30, 40), 1, 0)
    img = _image((30, 40), 4, 0)
    with pytest.raises(ValueError):
        k2.bilerp_window_fwd(img, xy.double())
    with pytest.raises(ValueError):
        k2.bilerp_window_fwd(img, xy.t().contiguous().t())
    with pytest.raises(ValueError):
        k2.bilerp_window_fwd(img[0], xy)
    with pytest.raises(ValueError):
        k2.bilerp_window_fwd(img, xy, "float16")
    with pytest.raises(ValueError):
        k2.bilerp_window_fwd(img.cpu(), xy)


# P1-P3 against their plain versions: exact (a copy, and a one-hot product
# with one nonzero term summed in f32)
GATHERS = {"take": gk.row_gather_take, "take_along": gk.row_gather_take_along,
           "onehot": gk.onehot_gather}
GATHER_COUNTERS = {"take": "p1.launches", "take_along": "p2.launches",
                   "onehot": "p3.launches"}


def _gather_inputs(n, rows, width, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((rows, width), generator=g).to(dtype).cuda()
    idx = torch.randint(0, rows, (n,), generator=g, dtype=torch.int32)
    return table, idx.cuda()


def _plain(probe, table, idx):
    if probe == "onehot":
        return gk.onehot_gather_plain(table, idx)
    return gk.row_gather_plain(table, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,width", [(729, 108), (729, 128),
                                        (35937, 108), (35937, 128)])
@pytest.mark.parametrize("n", [1, 255, 100003])
@pytest.mark.parametrize("probe", sorted(GATHERS))
def test_gather_probe_matches_plain(card, probe, n, rows, width, dtype):
    table, idx = _gather_inputs(n, rows, width, dtype, n + rows + width)
    wrapper = GATHERS[probe]
    before = counter(GATHER_COUNTERS[probe])
    got = wrapper(table, idx)
    torch.cuda.synchronize()
    assert counter(GATHER_COUNTERS[probe]) == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (n, width)
    assert torch.equal(got, _plain(probe, table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,width", [(729, 8), (729, 136), (35937, 8),
                                        (35937, 136)])
@pytest.mark.parametrize("n", [1, 255, 100003])
def test_onehot_narrow_and_two_column_tiles(card, n, rows, width, dtype):
    """P3 at a width under one k-step of padding (8) and over one column
    tile (136: a second, mostly padded tile of 128)."""
    table, idx = _gather_inputs(n, rows, width, dtype, n + rows + width)
    got = gk.onehot_gather(table, idx)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (n, width)
    assert torch.equal(got, gk.onehot_gather_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("probe", sorted(GATHERS))
def test_gather_probe_outside_the_table(card, probe, dtype):
    table, _ = _gather_inputs(1, 729, 108, dtype, 0)
    idx = torch.tensor([-5, -1, 0, 728, 729, 735, 736, 10 ** 9] * 40,
                       dtype=torch.int32).cuda()
    got = GATHERS[probe](table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, _plain(probe, table, idx))
    if probe == "onehot":  # an index outside the table gives a zero row
        outside = (idx < 0) | (idx >= 729)
        assert torch.count_nonzero(got[outside]) == 0
    else:  # the row gather clamps
        assert torch.equal(got[0], table[0]) and torch.equal(got[4], table[728])


@pytest.mark.cuda
def test_gather_probe_wrappers_check_inputs(card):
    table, idx = _gather_inputs(64, 729, 108, torch.float32, 0)
    for wrapper in GATHERS.values():
        with pytest.raises(ValueError):
            wrapper(table.double(), idx)
        with pytest.raises(ValueError):
            wrapper(table, idx.long())
        with pytest.raises(ValueError):
            wrapper(table.cpu(), idx)
