"""K5 (gens_torch/ops/isosurface.py) on the card: the isosurface of a grid on
the device against the native host code (``marching_tetrahedra``,
native/isosurface.cpp) on the same values, vertices and triangles equal bit
for bit and in order: a sphere grid with an exact-zero plateau, a seeded
normal grid of odd unequal sides, exact zeros and -0.0, grids all on one
side (an empty mesh), a single cube, and the 512³ grid of a synthetic val
scene on the trained weights through ``eval_sdf_grid`` -> ``grid_to_mesh``.
Also: ``k5.launches`` and ``isosurface.host`` per path, a tagged grid
changed in place is meshed as changed, and the wrapper's refusals. The grid
``eval_sdf_grid`` returns for the card is pinned, counts its slabs in
``grid.pinned_slabs``, equals a plain per-slab ``.cpu()`` evaluation
(``test_torch_isosurface.plain_grid``) bit for bit, and is meshed as edited
after its return. Imports neither jax nor gens_tpu:

    python -m pytest --noconftest -q tests/test_torch_isosurface_cuda.py

Skipped where there is no CUDA device (the kernel has no CPU mode)."""

import os

import numpy as np
import pytest
import torch

from gens_torch.config import load_config
from gens_torch.convert import load_params
from gens_torch.data.synthetic import SyntheticDataset
from gens_torch.mesh.extract import (eval_sdf_grid, grid_to_mesh,
                                     isosurface_of)
from gens_torch.mesh.isosurface import marching_tetrahedra
from gens_torch.models.gens import GenSModel
from gens_torch.ops import isosurface as k5
from gens_torch.utils.profiling import counter
from test_torch_isosurface import plain_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "artifacts", "quality_gen_r05_sharpen.pkl")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def sphere_grid(n=40):
    """The benchmark's isosurface test grid: a wavy ellipsoid with an
    exact-zero plateau."""
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    g = (0.5 - np.sqrt(x ** 2 + y ** 2 + (1.3 * z) ** 2)
         + 0.05 * np.sin(7 * x) * np.cos(5 * y)).astype(np.float32)
    g[10:12, 20:22, 5:7] = 0.0
    return g


def zeros_grid():
    g = np.random.default_rng(3).standard_normal((21, 18, 25)).astype(
        np.float32)
    pick = np.random.default_rng(4).random(g.shape)
    g[pick < 0.3] = 0.0
    g[pick > 0.8] = -0.0
    return g


GRIDS = {
    "sphere_plateau": sphere_grid,
    "normal_33x47x29": lambda: np.random.default_rng(1).standard_normal(
        (33, 47, 29)).astype(np.float32),
    "zeros_and_negative_zeros": zeros_grid,
    "all_positive": lambda: np.full((9, 10, 11), 0.5, np.float32),
    "all_negative": lambda: np.full((9, 10, 11), -0.5, np.float32),
    "one_cube": lambda: np.random.default_rng(2).standard_normal(
        (2, 2, 2)).astype(np.float32),
}


def analytic_sdf(seed):
    """A seeded wavy sphere, float32 on the points' device."""
    r = np.random.default_rng(seed)
    c = torch.tensor(r.uniform(-0.05, 0.05, 3), dtype=torch.float32)
    a, w = float(r.uniform(0.03, 0.06)), float(r.uniform(5.0, 9.0))

    def f(p):
        q = p - c.to(p.device)
        return (q.norm(dim=-1) - 0.9
                + a * torch.sin(w * q[:, 0]) * torch.cos(w * q[:, 1]))
    return f


def assert_same_mesh(got, want):
    (gv, gt), (wv, wt) = got, want
    assert gv.dtype == wv.dtype == np.float32
    assert gt.dtype == wt.dtype == np.int32
    assert gv.shape == wv.shape and gt.shape == wt.shape, (
        gv.shape, wv.shape, gt.shape, wt.shape)
    assert np.array_equal(gv.view(np.int32), wv.view(np.int32))
    assert np.array_equal(gt, wt)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRIDS))
def test_kernel_equals_the_host_code(card, name):
    g = GRIDS[name]()
    before = counter("k5.launches")
    got = k5.marching_tetrahedra_cuda(torch.from_numpy(g).to(card))
    assert counter("k5.launches") == before + 1
    want = marching_tetrahedra(g, 0.0)
    assert_same_mesh(got, want)
    if name.startswith("all_"):
        assert got[0].shape == (0, 3) and got[1].shape == (0, 3)
    else:
        assert len(got[1]) > 0


@pytest.mark.cuda
def test_paths_and_counters(card):
    """A grid tagged with the card and a CUDA tensor take K5; a plain array,
    a copy that lost the tag and a CPU tensor take the host code."""
    g = eval_sdf_grid(lambda p: p.norm(dim=-1) - 0.5, [-1] * 3, [1] * 3, 32,
                      card, block=16)
    assert g.torch_device.type == "cuda"
    want = marching_tetrahedra(np.asarray(g), 0.0)
    cases = [(g, 1, 0), (torch.from_numpy(np.asarray(g)).to(card), 1, 0),
             (np.asarray(g), 0, 1), (np.ascontiguousarray(g), 0, 1),
             (torch.from_numpy(np.asarray(g)), 0, 1)]
    for grid, n_k5, n_host in cases:
        before = (counter("k5.launches"), counter("isosurface.host"))
        assert_same_mesh(isosurface_of(grid), want)
        assert (counter("k5.launches") - before[0],
                counter("isosurface.host") - before[1]) == (n_k5, n_host)


@pytest.mark.cuda
def test_a_changed_tagged_grid_is_meshed_as_changed(card):
    g = eval_sdf_grid(lambda p: p.norm(dim=-1) - 0.5, [-1] * 3, [1] * 3, 32,
                      card, block=16)
    assert torch.from_numpy(np.asarray(g)).is_pinned()
    first = grid_to_mesh(g, [-1] * 3, [1] * 3)
    g[:8] += 0.05
    g[g.shape[0] // 2:] = 0.0
    before = counter("k5.launches")
    got = grid_to_mesh(g, [-1] * 3, [1] * 3)
    assert counter("k5.launches") == before + 1
    want = grid_to_mesh(np.asarray(g), [-1] * 3, [1] * 3)
    assert_same_mesh(got, want)
    assert len(got[1]) != len(first[1])


@pytest.mark.cuda
@pytest.mark.parametrize("block,x_range", [(64, None), (64, (64, 128)),
                                           (16, None)],
                         ids=["whole", "x64_128", "block16"])
def test_pinned_grid_equals_a_plain_evaluation(card, block, x_range):
    """128³ in slabs of ``block`` planes; block 16 takes each of the two
    device slabs four times."""
    sdf = analytic_sdf(7)
    before = counter("grid.pinned_slabs")
    g = eval_sdf_grid(sdf, [-1] * 3, [1] * 3, 128, card, block=block,
                      x_range=x_range)
    x0, x1 = x_range or (0, 128)
    assert counter("grid.pinned_slabs") == before + (x1 - x0) // block
    assert torch.from_numpy(np.asarray(g)).is_pinned()
    assert g.torch_device.type == "cuda"
    want = plain_grid(sdf, [-1] * 3, [1] * 3, 128, block, card, x_range)
    assert g.shape == want.shape == (x1 - x0, 128, 128)
    assert np.array_equal(np.asarray(g).view(np.int32), want.view(np.int32))


@pytest.mark.cuda
def test_wrapper_checks_inputs(card):
    g = torch.zeros((4, 4, 4), device=card)
    for bad in (g.double(), g[None], g.transpose(0, 2), g.cpu()):
        with pytest.raises(ValueError):
            k5.marching_tetrahedra_cuda(bad)


@pytest.mark.cuda
def test_val_scene_grid_512(card):
    """The 512³ grid of a synthetic val scene (3 views at 480x640,
    confs/dtu.yaml's model on the trained weights), copied to the host in 8
    pinned slabs and meshed by K5 and by the host code."""
    cfg = load_config(os.path.join(REPO, "confs", "dtu.yaml"))
    model = GenSModel(cfg.model)
    load_params(model, ARTIFACT)
    model = model.to(card).eval()
    raw = SyntheticDataset(1, 3, (480, 640), val_res_level=4)[0]
    x = {k: torch.from_numpy(raw[k]).to(card)
         for k in ("imgs", "intrs", "c2ws")}
    slabs = counter("grid.pinned_slabs")
    with torch.no_grad():
        scene = model.build_scene(x["imgs"], x["intrs"], x["c2ws"])
        grid = eval_sdf_grid(
            model.renderer.sdf_fn_for_extraction(scene.volumes),
            raw["bound_min"], raw["bound_max"], 512, card)
    assert counter("grid.pinned_slabs") - slabs == 8  # 512 / 64 x-slabs
    before = (counter("k5.launches"), counter("isosurface.host"))
    got = grid_to_mesh(grid, raw["bound_min"], raw["bound_max"])
    assert (counter("k5.launches") - before[0],
            counter("isosurface.host") - before[1]) == (1, 0)
    want = grid_to_mesh(np.asarray(grid), raw["bound_min"], raw["bound_max"])
    assert len(want[1]) > 100_000
    assert_same_mesh(got, want)
