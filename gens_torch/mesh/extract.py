"""SDF-grid evaluation on the device, chunked, then the isosurface
(counterpart of ``eval_sdf_grid`` and ``extract_geometry`` in
gens_tpu/mesh/extract.py; the runner times the two halves apart).

The grid is evaluated in x-slabs of ``block`` planes, each in sub-chunks of
``block**3`` points (the reference's 64³ chunk), so device memory stays
O(slab). It comes back as a host array tagged with the device it was
evaluated on (:class:`SdfGrid`), and :func:`grid_to_mesh` meshes where the
grid lives: K5 (``ops/isosurface.py``) on the card for a grid tagged with a
CUDA device or a CUDA tensor, the native host code for anything else, with
one result. Vertices are rescaled to ``[bound_min, bound_max]``.

On the card the host grid is pinned memory from torch's caching host
allocator, and each slab's copy into it runs on a copy stream while the next
slab is evaluated (``grid.pinned_slabs`` counts those copies); the copies
are waited for once, at the end. K5's upload of the same grid then reads
page-locked memory too.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from gens_torch.mesh.isosurface import marching_tetrahedra
from gens_torch.ops.isosurface import marching_tetrahedra_cuda
from gens_torch.utils.profiling import count, span


class SdfGrid(np.ndarray):
    """The float32 host grid of :func:`eval_sdf_grid`, tagged with the
    ``torch.device`` it was evaluated on (``torch_device``; None when
    viewed from a plain array). Views and copies keep the tag;
    ``np.asarray`` and ``np.ascontiguousarray`` drop it."""

    torch_device: Optional[torch.device] = None

    def __array_finalize__(self, obj):
        self.torch_device = getattr(obj, "torch_device", None)


def eval_sdf_grid(sdf_fn: Callable[[torch.Tensor], torch.Tensor], bound_min,
                  bound_max, resolution: int, device, block: int = 64,
                  x_range: Tuple[int, int] = None) -> SdfGrid:
    """Evaluate ``-sdf`` on a dense ``resolution³`` grid (interiors
    positive, as the reference marches). ``x_range`` (start, stop) limits
    the evaluation to those x planes (multiples of ``block``). Returns a
    float32 host array of shape (stop - start, res, res), an
    :class:`SdfGrid` tagged with ``device``; pinned for a CUDA device."""
    if resolution % block and resolution >= block:
        raise ValueError(f"resolution {resolution} is not a multiple of "
                         f"block {block}")
    device = torch.device(device)
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    axes = [torch.from_numpy(np.linspace(bmin[i], bmax[i], resolution,
                                         dtype=np.float32)).to(device)
            for i in range(3)]
    block = min(block, resolution)
    chunk = block ** 3
    x0, x1 = x_range if x_range is not None else (0, resolution)
    on_card = device.type == "cuda"
    host = torch.empty((x1 - x0, resolution, resolution),
                       dtype=torch.float32, pin_memory=on_card)
    out = host.numpy().view(SdfGrid)
    out.torch_device = device
    if on_card:
        # two device slabs in turn: one is copied out while the next is written
        slabs = [torch.empty(block * resolution ** 2, device=device)
                 for _ in range(2)]
        compute = torch.cuda.current_stream(device)
        copier = torch.cuda.Stream(device)
        copied = [torch.cuda.Event(), torch.cuda.Event()]
    with span("gens/mesh/grid"):
        for k, xs in enumerate(range(x0, x1, block)):
            dst = host[xs - x0:xs - x0 + block].view(-1)
            slab = slabs[k % 2] if on_card else dst
            if on_card and k >= 2:
                compute.wait_event(copied[k % 2])
            gx, gy, gz = torch.meshgrid(axes[0][xs:xs + block], axes[1],
                                        axes[2], indexing="ij")
            pts = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
            for i in range(0, pts.shape[0], chunk):
                torch.neg(sdf_fn(pts[i:i + chunk]), out=slab[i:i + chunk])
            if on_card:
                with span("gens/mesh/copy"):
                    copier.wait_stream(compute)
                    with torch.cuda.stream(copier):
                        dst.copy_(slab, non_blocking=True)
                    copied[k % 2].record(copier)
                count("grid.pinned_slabs")
        if on_card:
            copier.synchronize()
    return out


def isosurface_of(grid) -> Tuple[np.ndarray, np.ndarray]:
    """Marching tetrahedra at level 0 where the grid lives: the current
    values of a grid tagged with a CUDA device (copied there) or of a CUDA
    tensor through K5 (``k5.launches``), any other array or tensor through
    the native host code (``isosurface.host``). Both give the same
    (vertices (V, 3) float32 in grid-index space, triangles (T, 3) int32).
    A grid on or tagged with another device raises."""
    if isinstance(grid, torch.Tensor):
        device = grid.device
    else:
        device = getattr(grid, "torch_device", None)
    if device is None or device.type == "cpu":
        count("isosurface.host")
        return marching_tetrahedra(grid, 0.0)
    if device.type != "cuda":
        raise ValueError(f"no isosurface for a grid on device {device}")
    if not isinstance(grid, torch.Tensor):
        grid = torch.from_numpy(np.ascontiguousarray(grid, np.float32)).to(
            device)
    return marching_tetrahedra_cuda(grid.contiguous(), 0.0)


def grid_to_mesh(grid, bound_min, bound_max
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Marching tetrahedra on a full -sdf grid at level 0
    (:func:`isosurface_of`), vertices rescaled to the bounds. Returns
    (vertices (V, 3) float32, triangles (T, 3))."""
    resolution = grid.shape[0]
    with span("gens/mesh/isosurface"):
        verts, tris = isosurface_of(grid)
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    if len(verts):
        verts = verts / (resolution - 1.0) * (bmax - bmin)[None] + bmin[None]
    return verts, tris

