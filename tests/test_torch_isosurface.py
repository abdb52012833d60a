"""Where ``grid_to_mesh`` meshes (gens_torch/mesh/extract.py), on the CPU:
``eval_sdf_grid`` returns its host array tagged with the device it was
evaluated on (``SdfGrid``), and the tag takes K5 only for a CUDA device. A
grid evaluated on the CPU, a plain array, a copy that lost the tag and a
CPU tensor take the native host code (``isosurface.host`` counts,
``k5.launches`` does not), bit-equal to ``marching_tetrahedra``; a grid
evaluated on the CPU is plain memory (not pinned, ``grid.pinned_slabs``
unmoved) with the values of a plain per-slab evaluation; the tagged array
behaves as numpy; K5's wrapper and the dispatch refuse what has no path.
The kernel itself is held to the host code on the card in
tests/test_torch_isosurface_cuda.py, which also holds the card's pinned
grid to :func:`plain_grid`."""

import numpy as np
import pytest
import torch

from gens_torch.mesh.extract import (SdfGrid, eval_sdf_grid, grid_to_mesh,
                                     isosurface_of)
from gens_torch.mesh.isosurface import marching_tetrahedra
from gens_torch.ops import isosurface as k5
from gens_torch.utils.profiling import counter

BOUNDS = ([-1.0, -0.5, -1.0], [1.0, 1.5, 0.5])


def _sdf(p):
    return torch.linalg.norm(p * torch.tensor([1.0, 1.3, 0.9]), dim=-1) - 0.6


@pytest.fixture(scope="module")
def grid():
    return eval_sdf_grid(_sdf, *BOUNDS, 24, "cpu", block=8)


def plain_grid(sdf_fn, bmin, bmax, res, block, device="cpu", x_range=None):
    """``-sdf`` on ``device`` slab by slab, each copied to the host with
    ``.cpu()``."""
    bmin, bmax = np.float32(bmin), np.float32(bmax)
    axes = [torch.from_numpy(np.linspace(bmin[i], bmax[i], res,
                                         dtype=np.float32)).to(device)
            for i in range(3)]
    x0, x1 = x_range or (0, res)
    slabs = []
    for xs in range(x0, x1, block):
        g = torch.meshgrid(axes[0][xs:xs + block], axes[1], axes[2],
                           indexing="ij")
        pts = torch.stack(g, dim=-1).reshape(-1, 3)
        vals = torch.cat([sdf_fn(pts[i:i + block ** 3])
                          for i in range(0, len(pts), block ** 3)])
        slabs.append((-vals).reshape(block, res, res).cpu().numpy())
    return np.concatenate(slabs)


def _counts():
    return counter("k5.launches"), counter("isosurface.host")


def _host_mesh(g):
    """``grid_to_mesh``'s rescale of the host code's mesh."""
    v, t = marching_tetrahedra(np.asarray(g), 0.0)
    bmin, bmax = (np.asarray(b, np.float32) for b in BOUNDS)
    return v / (g.shape[0] - 1.0) * (bmax - bmin)[None] + bmin[None], t


def _same(got, want):
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert np.array_equal(got[0].view(np.int32), want[0].view(np.int32))
    assert np.array_equal(got[1], want[1])


def test_grid_evaluated_on_the_cpu_is_tagged_and_meshed_on_the_host(grid):
    assert isinstance(grid, SdfGrid) and grid.dtype == np.float32
    assert grid.torch_device == torch.device("cpu")
    before = _counts()
    got = grid_to_mesh(grid, *BOUNDS)
    assert _counts() == (before[0], before[1] + 1)
    assert len(got[1]) > 100
    _same(got, _host_mesh(grid))


@pytest.mark.parametrize("x_range", [None, (8, 16)], ids=["whole", "x8_16"])
def test_grid_evaluated_on_the_cpu_is_plain_memory(x_range):
    before = counter("grid.pinned_slabs")
    g = eval_sdf_grid(_sdf, *BOUNDS, 24, "cpu", block=8, x_range=x_range)
    assert counter("grid.pinned_slabs") == before
    assert not torch.from_numpy(np.asarray(g)).is_pinned()
    assert g.torch_device == torch.device("cpu")
    want = plain_grid(_sdf, *BOUNDS, 24, 8, x_range=x_range)
    assert g.shape == want.shape
    assert np.array_equal(np.asarray(g).view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("form", ["ndarray", "ascontiguousarray", "copy_cpu",
                                  "cpu_tensor"])
def test_untagged_grids_take_the_host_path(grid, form):
    g = {"ndarray": lambda: np.asarray(grid),
         "ascontiguousarray": lambda: np.ascontiguousarray(grid),
         "copy_cpu": lambda: grid.copy(),
         "cpu_tensor": lambda: torch.from_numpy(np.asarray(grid))}[form]()
    assert getattr(g, "torch_device", None) in (None, torch.device("cpu"))
    before = _counts()
    got = grid_to_mesh(g, *BOUNDS)
    assert _counts() == (before[0], before[1] + 1)
    _same(got, _host_mesh(grid))


def test_tagged_array_behaves_as_numpy(grid):
    plain = np.asarray(grid)
    assert type(plain) is np.ndarray and type(np.ascontiguousarray(grid)) \
        is np.ndarray
    cuda = plain.copy().view(SdfGrid)
    assert cuda.torch_device is None
    cuda.torch_device = torch.device("cuda", 1)
    for view in (cuda[3:9], cuda[:, ::2], cuda.copy(), cuda.reshape(-1)):
        assert isinstance(view, SdfGrid)
        assert view.torch_device == torch.device("cuda", 1)
    assert np.array_equal(cuda[3:9], plain[3:9])
    assert np.array_equal(cuda.reshape(-1)[[5, 7, 11]],
                          plain.reshape(-1)[[5, 7, 11]])
    assert np.array_equal(-cuda + 0.25, -plain + 0.25)
    assert np.array_equal(np.abs(cuda - plain[::-1]),
                          np.abs(plain - plain[::-1]))
    assert float(cuda.min()) == float(plain.min())
    assert float(-cuda.max()) == float(-plain.max())
    assert bool(np.isfinite(cuda).all())
    cuda[:2] += 1.0
    assert np.array_equal(cuda[:2], plain[:2] + np.float32(1.0))
    assert np.array_equal(cuda[2:], plain[2:])


@pytest.mark.parametrize("case", ["meta_tag", "meta_tensor",
                                  "k5_cpu_tensor", "k5_meta_tensor"])
def test_grids_with_no_path_raise(grid, case):
    plain = np.asarray(grid)
    before = _counts()
    with pytest.raises(ValueError):
        if case == "meta_tag":
            g = plain.view(SdfGrid)
            g.torch_device = torch.device("meta")
            isosurface_of(g)
        elif case == "meta_tensor":
            isosurface_of(torch.empty((4, 4, 4), device="meta"))
        elif case == "k5_cpu_tensor":
            k5.marching_tetrahedra_cuda(torch.from_numpy(plain))
        else:
            k5.marching_tetrahedra_cuda(torch.empty((4, 4, 4),
                                                    device="meta"))
    assert _counts() == before
