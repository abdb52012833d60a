"""SDF-grid evaluation on the device, chunked, then the native isosurface on
the host (counterpart of ``eval_sdf_grid`` and ``extract_geometry`` in
gens_tpu/mesh/extract.py; the runner times the two halves apart).

The grid is evaluated in x-slabs of ``block`` planes, each in sub-chunks of
``block**3`` points (the reference's 64³ chunk), so device memory stays
O(chunk). Vertices are rescaled to ``[bound_min, bound_max]``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from gens_torch.mesh.isosurface import marching_tetrahedra
from gens_torch.utils.profiling import span


def eval_sdf_grid(sdf_fn: Callable[[torch.Tensor], torch.Tensor], bound_min,
                  bound_max, resolution: int, device, block: int = 64,
                  x_range: Tuple[int, int] = None) -> np.ndarray:
    """Evaluate ``-sdf`` on a dense ``resolution³`` grid (interiors
    positive, as the reference marches). ``x_range`` (start, stop) limits
    the evaluation to those x planes (multiples of ``block``). Returns a
    float32 numpy array of shape (stop - start, res, res)."""
    if resolution % block and resolution >= block:
        raise ValueError(f"resolution {resolution} is not a multiple of "
                         f"block {block}")
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    axes = [torch.from_numpy(np.linspace(bmin[i], bmax[i], resolution,
                                         dtype=np.float32)).to(device)
            for i in range(3)]
    block = min(block, resolution)
    chunk = block ** 3
    x0, x1 = x_range if x_range is not None else (0, resolution)
    out = np.empty((x1 - x0, resolution, resolution), np.float32)
    with span("gens/mesh/grid"):
        for xs in range(x0, x1, block):
            gx, gy, gz = torch.meshgrid(axes[0][xs:xs + block], axes[1],
                                        axes[2], indexing="ij")
            pts = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
            vals = torch.cat([sdf_fn(pts[i:i + chunk])
                              for i in range(0, pts.shape[0], chunk)])
            with span("gens/mesh/copy"):
                out[xs - x0:xs - x0 + block] = (-vals).reshape(
                    block, resolution, resolution).cpu().numpy()
    return out


def grid_to_mesh(grid: np.ndarray, bound_min, bound_max
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Marching tetrahedra on a full -sdf grid at level 0, vertices rescaled
    to the bounds. Returns (vertices (V, 3) float32, triangles (T, 3))."""
    resolution = grid.shape[0]
    with span("gens/mesh/isosurface"):
        verts, tris = marching_tetrahedra(grid, 0.0)
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    if len(verts):
        verts = verts / (resolution - 1.0) * (bmax - bmin)[None] + bmin[None]
    return verts, tris

