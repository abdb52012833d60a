"""Phase ft of the quality protocol (scripts/quality_synthetic.py:646-784):
the per-scene finetune of a generalizable checkpoint on the held-out
sphere, run by ``python -m gens_torch.eval.quality_train --phase ft``.

The script's recipe: ``--gen-ckpt`` (either package's checkpoint; fp16
leaves widen exactly to f32) loads into the model of ``build_cfg(steps_ft)``
with the anneal ending at ``max(steps_ft // 8, 1)``, no warmup,
``sparse_weight`` 0, ``smooth_weight`` 5e-4 and ``pseudo_depth_weight`` 0.
``pseudo_sdf_weight`` stays 1 and every batch carries 512 analytic surface
points as ``pseudo_pts``: the script finetunes with the exact surface as a
label, and so does this phase. One ``init_volumes`` on the held-out
scene's ``eval_views`` views (seed 123; the runner's ``filter_volume`` is
not applied, as in the script) gives the volumes, masks and features; the
mesh of those volumes is scored as ``ft_init_*``. 64 batches are drawn
from one ``RandomState(7)`` in the script's order (a batch's pixel x, its
pixel y, then its 1200 surface samples), batch ``b`` from view ``b %
eval_views`` with the views rolled so it comes first. ``FinetuneStep``
trains the volumes and the sdf, blending and variance modules for
``steps_ft`` steps (step ``s`` on batch ``s % 64`` with a CPU generator
seeded with ``s``; a curve row of ``loss``, ``psnr``, ``eikonal_loss`` and
``color_loss`` every 100 steps and at the last), then the mesh is scored
again as ``ft_*`` and ``runs/quality_ft.ckpt`` (or ``--ckpt-out``) is
written in the script's layout: ``{epoch: 0, step, params}`` with the
params ``sdf``, ``blending``, ``variance``, ``volumes``, ``mask_volumes``
and ``features``.

The script's phase has no in-flight checkpoint; this one has, as phase a
and b have (``<runs-dir>/<--out's stem>_ft_inflight.ckpt``: the finetune
params, the optimizer state as numpy (bfloat16 as float32), the
scheduler, the curve and the segments; written every
``--inflight-every`` steps and where ``--stop-at`` ends a segment,
removed when the run is done), so ``--stop-at`` segments a run.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from gens_torch.config import Config
from gens_torch.eval.quality import mesh_metrics, scene_params
from gens_torch.eval.quality_train import (_sync, build_cfg, ckpt_path, frame,
                                           inflight_path, record_run,
                                           summary, train_segment)
from gens_torch.utils.profiling import counter

FT_CURVE_EVERY = 100
FT_CURVE_KEYS = ("loss", "psnr", "eikonal_loss", "color_loss")
FT_BATCHES = 64
FT_SEED = 7
FT_SCENE = -1


def ft_cfg(args) -> Config:
    """Phase ft's configuration (scripts/quality_synthetic.py:662-667)."""
    cfg = build_cfg(args, args.steps_ft)
    cfg.train.anneal_end = max(args.steps_ft // 8, 1)
    cfg.train.warmup = 0
    cfg.train.loss.sparse_weight = 0.0
    cfg.train.loss.smooth_weight = 5e-4
    cfg.train.loss.pseudo_depth_weight = 0.0
    return cfg


def ft_batches(base: Dict, scene_kw: Dict, hw, n_rays: int, device,
               n_batches: int = FT_BATCHES, seed: int = FT_SEED
               ) -> List[Dict]:
    """The script's ``ft_batch`` for b = 0 … n_batches - 1 from one shared
    ``RandomState(seed)``. The rolled view stacks (one per reference view)
    go on ``device`` once and are shared by the batches."""
    from gens_torch.data.synthetic import shape_spheres, shape_surface_samples

    def dev(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device, dtype) if dtype else t.to(device)

    n_views = base["imgs"].shape[0]
    H, W = hw
    prng = np.random.RandomState(seed)
    intr_inv = np.linalg.inv(base["intrs"][0])
    dist = float(np.linalg.norm(base["c2ws"][0][:3, 3]))
    near = dev(np.full((1, 1), 0.95 * (dist - 1.0), np.float32))
    far = dev(np.full((1, 1), 1.05 * (dist + 1.0), np.float32))
    centers, radii = shape_spheres(scene_kw.get("shape"), base["radius"])
    views = []
    for vid in range(n_views):
        order = np.roll(np.arange(n_views), -vid)
        views.append({"imgs": dev(base["imgs"][order]),
                      "intrs": dev(base["intrs"][order]),
                      "c2ws": dev(base["c2ws"][order]),
                      "view_ids": dev(order, torch.long)})
    batches = []
    for b in range(n_batches):
        vid = b % n_views
        px = prng.randint(0, W, n_rays).astype(np.float32)
        py = prng.randint(0, H, n_rays).astype(np.float32)
        pix = np.stack([px, py, np.ones_like(px)], -1)
        d = pix @ intr_inv.T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        c2w = base["c2ws"][vid]
        rays_d = (d @ c2w[:3, :3].T).astype(np.float32)
        rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
        color = base["imgs"][vid][py.astype(int), px.astype(int)]
        spts = shape_surface_samples(centers, radii, 1200, prng)
        spts = np.tile(spts, (-(-512 // len(spts)), 1))[:512]
        batches.append({**views[vid], "near": near, "far": far,
                        "rays_o": dev(rays_o.astype(np.float32)),
                        "rays_d": dev(rays_d),
                        "color": dev(color.astype(np.float32)),
                        "pseudo_pts": dev(spts.astype(np.float32))})
    return batches


@torch.no_grad()
def ft_mesh_metrics(model, volumes: Sequence[torch.Tensor], base: Dict,
                    scene_kw: Dict, mesh_res: int, device, tag: str) -> Dict:
    """The script's ``ft_mesh_metrics``: the SDF of ``volumes`` through K3
    on a ``mesh_res``³ grid, marching tetrahedra, cleaning by the views'
    hit masks and the geometric error; adds the grid's seconds as
    ``<tag>_mesh_grid_s``."""
    from gens_torch.mesh.extract import eval_sdf_grid, grid_to_mesh

    model.eval()
    _sync(device)
    t0 = time.perf_counter()
    grid = eval_sdf_grid(model.renderer.sdf_fn_for_extraction(list(volumes)),
                         [-1] * 3, [1] * 3, mesh_res, device, block=64)
    grid_s = time.perf_counter() - t0
    verts, tris = grid_to_mesh(grid, [-1] * 3, [1] * 3)
    out = mesh_metrics(verts, tris, scene_kw,
                       {"masks": base["view_masks"], "intrs": base["intrs"],
                        "c2ws": base["c2ws"]}, tag)
    out[f"{tag}_mesh_grid_s"] = grid_s
    return out


def _save_inflight(path, step, step_fn, curve, segments) -> None:
    from gens_torch.convert import finetune_params_to_jax
    from gens_torch.train.checkpoint import _to_numpy, save_params_checkpoint

    arrays = _arrays(step_fn)
    save_params_checkpoint(
        path, step, step_fn.model,
        params=finetune_params_to_jax(step_fn.model, arrays),
        extra={"dtypes": {k: [str(a.dtype) for a in v]
                          for k, v in arrays.items()},
               "opt_state": _to_numpy(step_fn.optimizer.state_dict()),
               "scheduler": step_fn.scheduler.state_dict(),
               "curve": curve, "segments": segments})


def _arrays(step_fn) -> Dict[str, List[torch.Tensor]]:
    return {"volumes": step_fn.volumes, "mask_volumes": step_fn.mask_volumes,
            "features": step_fn.features}


def _resume(path, model, cfg, device):
    from gens_torch.train.checkpoint import (load_finetune_checkpoint,
                                             load_optimizer_state)
    from gens_torch.train.step import FinetuneStep

    payload, arrays = load_finetune_checkpoint(model, path)
    arrays = {k: [a.to(device, getattr(torch, dt.split(".")[-1]))
                  for a, dt in zip(v, payload["dtypes"][k])]
              for k, v in arrays.items()}
    step_fn = FinetuneStep(model, cfg, arrays["volumes"],
                           arrays["mask_volumes"], arrays["features"])
    load_optimizer_state(step_fn.optimizer, model, payload["opt_state"])
    step_fn.scheduler.load_state_dict(payload["scheduler"])
    return (step_fn, int(payload["step"]), list(payload["curve"]),
            list(payload["segments"]))


def phase_ft(args, results: Dict, flush, device) -> bool:
    """The per-scene finetune of ``--gen-ckpt`` on the held-out sphere.
    Returns whether the run reached its last step. ``ft_k3_launches``
    counts K3 over both scorings, across segments."""
    from gens_torch.convert import finetune_params_to_jax, load_params
    from gens_torch.data.synthetic import make_scene
    from gens_torch.models.gens import GenSModel
    from gens_torch.train.checkpoint import save_params_checkpoint
    from gens_torch.train.step import FinetuneStep

    hw = frame(args)
    cfg = ft_cfg(args)
    model = GenSModel(cfg.model)
    load_params(model, args.gen_ckpt)
    model = model.to(device)
    kw = scene_params(FT_SCENE)
    base = make_scene(n_views=args.eval_views, hw=hw, n_rays=args.rays,
                      seed=123, spread=args.spread, **kw)
    inflight = inflight_path(args, "ft")
    k3_before = counter("k3.launches")
    if os.path.exists(inflight):
        step_fn, start, curve, segments = _resume(inflight, model, cfg,
                                                  device)
        print(f"[ft] resumed in-flight at step {start}", flush=True)
    else:
        imgs, intrs, c2ws = (torch.from_numpy(base[k]).to(device)
                             for k in ("imgs", "intrs", "c2ws"))
        _sync(device)
        t0 = time.perf_counter()
        volumes, masks, features = model.init_volumes(imgs, intrs, c2ws)
        _sync(device)
        results["ft_init_volumes_s"] = time.perf_counter() - t0
        step_fn = FinetuneStep(model, cfg, volumes, masks, features)
        start, curve, segments = 0, [], []
        results.update(ft_mesh_metrics(model, step_fn.volumes, base, kw,
                                       args.mesh_res, device, "ft_init"))
        results["ft_k3_launches"] = counter("k3.launches") - k3_before
        flush()
    batches = ft_batches(base, kw, hw, args.rays, device)
    end = args.steps_ft if args.stop_at is None else min(args.stop_at,
                                                         args.steps_ft)
    if start < end:
        segments.append(train_segment(
            lambda inputs, anneal, gen: step_fn(inputs, anneal,
                                                generator=gen),
            batches, cfg.train.anneal_end, args.steps_ft, start, end, "ft",
            device, curve, keys=FT_CURVE_KEYS, every=FT_CURVE_EVERY,
            save=lambda s: _save_inflight(inflight, s, step_fn, curve,
                                          segments),
            save_every=args.inflight_every))
        if end < args.steps_ft:
            _save_inflight(inflight, end, step_fn, curve, segments)
    done = max(start, end)
    record_run(results, "ft", {"curve": curve, "segments": segments,
                               "end": done})
    flush()
    if done < args.steps_ft:
        print(f"[ft] stopped at step {done} of {args.steps_ft}; the next "
              f"call resumes {inflight}", flush=True)
        return False
    k3_before = counter("k3.launches")
    results.update(ft_mesh_metrics(model, step_fn.volumes, base, kw,
                                   args.mesh_res, device, "ft"))
    results["ft_k3_launches"] = (results.get("ft_k3_launches", 0)
                                 + counter("k3.launches") - k3_before)
    save_params_checkpoint(ckpt_path(args, "ft"), done, model,
                           params=finetune_params_to_jax(model,
                                                         _arrays(step_fn)))
    if os.path.exists(inflight):
        os.remove(inflight)  # the finished state is the checkpoint
    flush()
    summary(results)
    return True
