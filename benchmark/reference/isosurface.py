"""Plain marching tetrahedra in PyTorch: the vertex count, the triangle
count and the surface area of the ``grid == iso`` isosurface, by the
6-tetrahedra cube decomposition around the main diagonal (corner
c = dx·4 + dy·2 + dz), with one vertex per crossed edge.

A tetrahedron with one corner apart from the other three (below the level
or not) gives one triangle on the three edges of that corner; one with two
and two gives the quad (a,c1) (a,c2) (b,c2) (b,c1), split along its
(a,c1)-(b,c2) diagonal, where a < b are the corners below the level and
c1 < c2 the others, in the tetrahedron's corner order. A crossing lies at
t = (iso - v_a) / (v_b - v_a), clamped to [0, 1] (0.5 where v_a = v_b).
Vertices are rescaled from grid indices to [bound_min, bound_max].
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

TETS = ((0, 5, 1, 7), (0, 1, 3, 7), (0, 3, 2, 7),
        (0, 2, 6, 7), (0, 6, 4, 7), (0, 4, 5, 7))


def _edge_point(pa, va, pb, vb, iso):
    denom = vb - va
    t = torch.where(denom == 0, torch.full_like(va, 0.5),
                    (iso - va) / torch.where(denom == 0,
                                             torch.ones_like(denom), denom))
    t = t.clamp(0.0, 1.0)[..., None]
    return pa + t * (pb - pa)


def _area(a, b, c) -> torch.Tensor:
    return 0.5 * torch.linalg.norm(torch.cross((b - a).double(),
                                               (c - a).double(), dim=-1),
                                   dim=-1)


def isosurface_stats(grid: torch.Tensor, bound_min: Sequence[float],
                     bound_max: Sequence[float], iso: float = 0.0,
                     slab: int = 16) -> Dict[str, float]:
    """{"n_verts", "n_tris", "area"} of the isosurface of an (nx, ny, nz)
    float32 grid, walked in x-slabs of ``slab`` cube layers."""
    nx, ny, nz = grid.shape
    dev = grid.device
    n_nodes = nx * ny * nz
    res = torch.tensor([nx - 1.0, ny - 1.0, nz - 1.0], device=dev)
    bmin = torch.tensor(list(bound_min), dtype=torch.float32, device=dev)
    bmax = torch.tensor(list(bound_max), dtype=torch.float32, device=dev)
    offs = torch.tensor([[(c >> 2) & 1, (c >> 1) & 1, c & 1]
                         for c in range(8)], device=dev)
    tets = torch.tensor(TETS, device=dev)
    keys, n_tris, area = [], 0, torch.zeros((), dtype=torch.float64,
                                             device=dev)
    for x0 in range(0, nx - 1, slab):
        x1 = min(x0 + slab, nx - 1)
        g = grid[x0:x1 + 1]
        corners = torch.stack([g[dx:dx + x1 - x0, dy:dy + ny - 1,
                                 dz:dz + nz - 1]
                               for dx, dy, dz in offs.tolist()], dim=-1)
        below = corners < iso
        mixed = below.any(dim=-1) & (~below).any(dim=-1)
        cube = mixed.nonzero()
        if cube.shape[0] == 0:
            continue
        vals = corners[mixed][:, tets]                     # (M, 6, 4)
        base = cube + torch.tensor([x0, 0, 0], device=dev)
        pos = (base[:, None, None, :] + offs[tets][None]).float()
        node = (pos[..., 0].long() * ny + pos[..., 1].long()) * nz \
            + pos[..., 2].long()
        vals, pos, node = (vals.reshape(-1, 4), pos.reshape(-1, 4, 3),
                           node.reshape(-1, 4))
        ins = vals < iso
        n_in = ins.sum(dim=-1)
        idx = torch.arange(4, device=dev)

        def point(rows, i, j):
            r = torch.arange(rows.shape[0], device=dev)
            return _edge_point(pos[rows][r, i], vals[rows][r, i],
                               pos[rows][r, j], vals[rows][r, j], iso)

        def key(rows, i, j):
            r = torch.arange(rows.shape[0], device=dev)
            a, b = node[rows][r, i], node[rows][r, j]
            return torch.minimum(a, b) * n_nodes + torch.maximum(a, b)

        def world(p):
            return p / res * (bmax - bmin) + bmin

        lone_rows = ((n_in == 1) | (n_in == 3)).nonzero()[:, 0]
        if lone_rows.numel():
            lin = ins[lone_rows]
            # the corner alone on its side, then the other three in order
            odd = torch.where((n_in[lone_rows] == 1)[:, None], lin, ~lin)
            order = torch.argsort((~odd).int() * 4 + idx, dim=-1)
            lone, others = order[:, 0], order[:, 1:]
            pts = [world(point(lone_rows, lone, others[:, k]))
                   for k in range(3)]
            area += _area(*pts).sum()
            keys += [key(lone_rows, lone, others[:, k]) for k in range(3)]
            n_tris += int(lone_rows.numel())
        quad_rows = (n_in == 2).nonzero()[:, 0]
        if quad_rows.numel():
            order = torch.argsort((~ins[quad_rows]).int() * 4 + idx, dim=-1)
            a, b, c1, c2 = order.unbind(-1)
            q0 = world(point(quad_rows, a, c1))
            q1 = world(point(quad_rows, a, c2))
            q2 = world(point(quad_rows, b, c2))
            q3 = world(point(quad_rows, b, c1))
            area += _area(q0, q1, q2).sum() + _area(q0, q2, q3).sum()
            keys += [key(quad_rows, a, c1), key(quad_rows, a, c2),
                     key(quad_rows, b, c2), key(quad_rows, b, c1)]
            n_tris += 2 * int(quad_rows.numel())
    n_verts = int(torch.unique(torch.cat(keys)).numel()) if keys else 0
    return {"n_verts": n_verts, "n_tris": n_tris, "area": float(area)}


def mesh_stats(verts, tris) -> Dict[str, float]:
    """The same statistics of a triangle mesh (numpy arrays)."""
    import numpy as np

    v = np.asarray(verts, np.float64)
    t = np.asarray(tris, np.int64)
    if len(t) == 0:
        return {"n_verts": int(len(v)), "n_tris": 0, "area": 0.0}
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1).sum()
    return {"n_verts": int(len(v)), "n_tris": int(len(t)),
            "area": float(area)}
