"""A validation render split over a group of ranks (counterpart of
``Runner._render_chunk_jit`` and ``_render_chunked`` in gens_tpu/runner.py,
whose ``shard_map`` splits a scene's rays over a process's devices with
the params and the scene replicated).

The group's leader holds the scene and broadcasts it with the rays
(:func:`broadcast_scene`). The rays are padded with copies of the last ray
to a multiple of ``chunk`` × G (G ranks), and rank j renders chunk j of
every step of ``chunk`` × G rays, as device j of the JAX mesh does
(:func:`chunk_rows`). Every chunk has the shape and the rays of the
one-process render's, so the gathered image is that render bit for bit
where the kernels are deterministic.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gens_torch.models.renderer import Scene
from gens_torch.parallel.distributed import (ValGroup, broadcast_tensors,
                                             gather_rows)

RENDER_KEYS = ("color_fine", "normal", "sdf_depth", "render_depth")
RAY_KEYS = ("rays_o", "rays_d", "near", "far")


def chunk_rows(n: int, chunk: int, size: int, index: int) -> np.ndarray:
    """Rank ``index``'s rows of the padded ray array of a group of
    ``size``: chunk ``index`` of every step of ``chunk * size`` rows. Rows
    from ``n`` on are padding (copies of ray n - 1)."""
    step = chunk * size
    starts = np.arange(index * chunk, n + (-n) % step, step)
    return (starts[:, None] + np.arange(chunk)).reshape(-1)


def render_chunk(renderer, scene: Scene, rays_o, rays_d, near, far
                 ) -> Dict[str, torch.Tensor]:
    """One chunk's validation outputs, with the weighted normal restricted
    to the unit sphere."""
    out = renderer.render(rays_o, rays_d, near, far, scene,
                          cos_anneal_ratio=1.0)
    out["normal"] = torch.sum(
        out["gradients"] * out["weights"][..., None]
        * out["inside_sphere"][..., None], dim=1)
    return {k: out[k] for k in RENDER_KEYS}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def split_render(renderer, scene: Scene, rays: Dict[str, torch.Tensor],
                 chunk: int = 512, group: Optional[ValGroup] = None
                 ) -> Tuple[Optional[Dict[str, np.ndarray]], Dict]:
    """Render ``rays`` (``RAY_KEYS``) of ``scene`` in fixed-size chunks,
    this rank's share of them when ``group`` has several ranks (every
    member calls it). Returns the float32 outputs on the host, whole, on
    the leader (None on the others), and this rank's seconds: ``render_s``
    of its chunks, ``gather_s`` of the gather, and its ``rays`` (padding
    left out)."""
    size = 1 if group is None else group.size
    index = 0 if group is None else group.index
    rays_o, rays_d = rays["rays_o"], rays["rays_d"]
    n = rays_o.shape[0]
    rows = chunk_rows(n, chunk, size, index)
    take = torch.from_numpy(np.minimum(rows, n - 1)).to(rays_o.device)
    ro, rd = rays_o[take], rays_d[take]
    device = rays_o.device
    _sync(device)
    t0 = time.perf_counter()
    parts, widths = [], None
    for i in range(0, ro.shape[0], chunk):
        out = render_chunk(renderer, scene, ro[i:i + chunk], rd[i:i + chunk],
                           rays["near"], rays["far"])
        flat = [out[k].float().reshape(chunk, -1) for k in RENDER_KEYS]
        widths = [(f.shape[1], tuple(out[k].shape[1:]))
                  for f, k in zip(flat, RENDER_KEYS)]
        parts.append(torch.cat(flat, dim=1))
    mine = torch.cat(parts)
    _sync(device)
    st = {"render_s": time.perf_counter() - t0,
          "rays": int(np.count_nonzero(rows < n))}
    t0 = time.perf_counter()
    if size > 1:
        gathered = gather_rows(mine, group)
        st["gather_s"] = time.perf_counter() - t0
        if gathered is None:
            return None, st
        # (rank, step, chunk) -> (step, rank, chunk): the padded order
        full = torch.stack(gathered).reshape(
            size, -1, chunk, mine.shape[1]).transpose(0, 1).reshape(
            -1, mine.shape[1])
    else:
        full = mine
    full = full[:n].cpu()
    cols = torch.split(full, [w for w, _ in widths], dim=1)
    return {k: c.reshape((n,) + shape).contiguous().numpy()
            for k, c, (_, shape) in zip(RENDER_KEYS, cols, widths)}, st


def broadcast_scene(scene: Optional[Scene],
                    rays: Optional[Dict[str, torch.Tensor]], info,
                    group: ValGroup, device: torch.device
                    ) -> Tuple[Scene, Dict[str, torch.Tensor], object, int]:
    """The leader's scene, rays (``RAY_KEYS``) and picklable ``info`` on
    every member of ``group`` (collective; the others pass None), in one
    buffer: the volumes, mask volumes, features, match features (sent once
    when they are the features), images, cameras and the combined mask.
    Returns (scene, rays, info, bytes broadcast)."""
    tensors = None
    if group.is_leader:
        same = scene.match_features is scene.features
        lists = [scene.volumes, scene.mask_volumes, scene.features,
                 [] if same else scene.match_features,
                 [scene.imgs, scene.intrs, scene.c2ws],
                 [] if scene.mask_any is None else [scene.mask_any],
                 [rays[k] for k in RAY_KEYS]]
        tensors = [t for part in lists for t in part]
        info = (info, [len(part) for part in lists], same)
    tensors, (info, sizes, same), nbytes = broadcast_tensors(
        tensors, info, group, device)
    parts: List[List[torch.Tensor]] = []
    for s in sizes:
        parts.append(tensors[:s])
        tensors = tensors[s:]
    volumes, masks, feats, match, cams, mask_any, ray_t = parts
    out = Scene(volumes=volumes, mask_volumes=masks, features=feats,
                match_features=feats if same else match, imgs=cams[0],
                intrs=cams[1], c2ws=cams[2],
                mask_any=mask_any[0] if mask_any else None)
    return out, dict(zip(RAY_KEYS, ray_t)), info, nbytes
