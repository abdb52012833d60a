"""K5: the isosurface of an SDF grid on the card -- marching tetrahedra in the
CUDA kernel ``csrc/isosurface.cu``, bit-equal to the native host code.

:func:`marching_tetrahedra_cuda` takes an (nx, ny, nz) float32 grid on a
CUDA device and returns what ``mesh/isosurface.py::marching_tetrahedra``
(``native/isosurface.cpp``, its plain version) returns on the same values:
the (V, 3) float32 vertices in grid-index space and the (T, 3) int32
triangles, in the same order and with the same winding, as host arrays. It
launches a count pass and a scan, reads back the two totals, sizes the
outputs, launches the emit pass and copies the outputs to the host once.
Any other tensor raises. The counter ``k5.launches``
(``utils/profiling.py``) counts the isosurfaces it extracts.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from gens_torch.utils import libraries
from gens_torch.utils.profiling import count

_GRID = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float]
LIBRARY = libraries.Library("gens_torch/csrc/isosurface.cu", {
    "isosurface_count": (ctypes.c_int, _GRID + [ctypes.c_void_p] * 3),
    "isosurface_emit": (ctypes.c_int, _GRID + [ctypes.c_void_p] * 5),
    "isosurface_tile": (ctypes.c_int, [])})


def check_grid(grid: torch.Tensor) -> None:
    """Raise ValueError on what the kernel does not take."""
    if grid.device.type != "cuda":
        raise ValueError(f"K5 has no path for device {grid.device}: a grid "
                         f"on a CUDA device")
    if (grid.dtype != torch.float32 or grid.dim() != 3
            or not grid.is_contiguous()):
        raise ValueError(f"K5 takes a contiguous f32 (nx, ny, nz) grid, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    cubes = 1
    for n in grid.shape:
        cubes *= max(n - 1, 0)
    if cubes >= 1 << 31:
        raise ValueError(f"K5 takes fewer than 2^31 cubes, got {cubes}")


def extract_on_device(grid: torch.Tensor, iso: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (V, 3) f32 vertices and (T, 3) int32 triangles of ``grid``'s
    ``iso`` level, left on its device (one host read of the totals)."""
    check_grid(grid)
    lib = libraries.load(LIBRARY)
    nx, ny, nz = grid.shape
    cubes = max(nx - 1, 0) * max(ny - 1, 0) * max(nz - 1, 0)
    tile = lib.isosurface_tile()
    n_tiles = -(-cubes // tile)
    dev = grid.device
    prefix = torch.empty(cubes, dtype=torch.int16, device=dev)
    offs = torch.empty((n_tiles + 1, 2), dtype=torch.int64, device=dev)
    stream = libraries.stream(dev)
    libraries.check_launch("K5 count", lib.isosurface_count(
        grid.data_ptr(), nx, ny, nz, iso, prefix.data_ptr(), offs.data_ptr(),
        stream))
    n_verts, n_tris = (int(n) for n in offs[n_tiles].cpu())
    if n_verts >= 1 << 31 or n_tris >= 1 << 31:
        raise ValueError(f"K5 indexes vertices and triangles in int32, got "
                         f"{n_verts} and {n_tris}")
    verts = torch.empty((n_verts, 3), dtype=torch.float32, device=dev)
    tris = torch.empty((n_tris, 3), dtype=torch.int32, device=dev)
    if n_tris:
        libraries.check_launch("K5 emit", lib.isosurface_emit(
            grid.data_ptr(), nx, ny, nz, iso, prefix.data_ptr(),
            offs.data_ptr(), verts.data_ptr(), tris.data_ptr(), stream))
    count("k5.launches")
    return verts, tris


def marching_tetrahedra_cuda(grid: torch.Tensor, iso: float = 0.0
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """``marching_tetrahedra`` of a grid on a CUDA device, bit for bit:
    (vertices (V, 3) float32 in grid-index space, triangles (T, 3) int32)
    as host arrays."""
    verts, tris = extract_on_device(grid, iso)
    return verts.cpu().numpy(), tris.cpu().numpy()
