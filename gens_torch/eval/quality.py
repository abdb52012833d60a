"""Quality evaluation of trained weights on the synthetic scenes: the
``--phase eval`` protocol of scripts/quality_synthetic.py on a checkpoint,
on the card.

    python -m gens_torch.eval.quality --ckpt artifacts/quality_gen_r05_sharpen.pkl \
        [--scenes heldout,heldout_union,trained] [--hw 480 640] [--dims 128] \
        [--samples 64] [--mesh-res 192] [--device cpu] [--out F]

Per scene (``heldout`` is scene -1, the held-out sphere; ``heldout_union``
-2, the held-out two-sphere union; ``trained`` 0, a training scene): build
the scene from 3 views (spread 0.5, seed 123), render view 0 at stride 2
in 1024-ray chunks and take its PSNR, extract the mesh on a ``mesh_res``³
grid in 64³ blocks through K3, clean it by the views' hit masks and the
frustum first-hit consensus, and score it against the analytic shape
(:func:`mesh_metrics`: accuracy over the observable vertices, completeness
over the camera-visible surface, their mean).

The defaults are the configuration of QUALITY_r05_sharpen_repro.json:
480x640 frames, a 128³...8³ cascade, 64+64 samples, bf16 volumes, U-Net
activations and colour maps, packed lookups and ``packed_bilerp: pallas``
(the bf16 aggregation forward).

Parameters: the artifact stores its parameters as float16. They are read as
the JAX package's checkpoint reader reads them (float16 arrays) and widened
exactly to float32, which is what the JAX model computes with too (f32
inputs promote every product). QUALITY_r05_sharpen_repro.json was scored in
its training process on the float32 parameters, before they were rounded to
float16 for the artifact. The entry point runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Sequence

import numpy as np
import torch

from gens_torch.config import Config

SCENES = {"heldout": -1, "heldout_union": -2, "trained": 0}
EVAL_VIEWS = 3
SPREAD = 0.5
RENDER_STRIDE = 2
CHUNK = 1024


def _two_sphere_shape(rng):
    """A random non-convex union of two overlapping spheres."""
    r1 = float(0.28 + 0.14 * rng.uniform())
    r2 = float(0.20 + 0.12 * rng.uniform())
    d = (r1 + r2) * float(0.55 + 0.25 * rng.uniform())  # overlapping
    ax = rng.randn(3)
    ax /= np.linalg.norm(ax)
    c1 = -ax * d * r2 / (r1 + r2)
    c2 = ax * d * r1 / (r1 + r2)
    return {"centers": [c1.tolist(), c2.tolist()], "radii": [r1, r2]}


def scene_params(i: int):
    """The protocol's scenes (scripts/quality_synthetic.py:44): -1 the
    held-out sphere, -2 the held-out two-sphere union, i >= 0 the training
    scenes (odd ones two-sphere unions), each with its camera ring offset,
    light, albedo texture and tints."""
    if i == -1:
        return dict(radius=0.45, ang0=0.9, light_dir=(0.1, 0.5, -0.85),
                    albedo_freq=7.0, albedo_phase=(0.8, 1.9),
                    tints=(0.9, 0.7, 0.95))
    if i == -2:
        return dict(radius=0.45, ang0=2.2, light_dir=(-0.2, 0.4, -0.85),
                    albedo_freq=8.0, albedo_phase=(2.1, 0.4),
                    tints=(0.95, 0.8, 0.7),
                    shape={"centers": [[-0.18, 0.0, 0.02],
                                       [0.22, 0.05, 0.08]],
                           "radii": [0.36, 0.27]})
    rng = np.random.RandomState(1000 + i)
    out = dict(
        radius=float(0.35 + 0.27 * rng.uniform()),
        ang0=float(rng.uniform(0, 2 * np.pi)),
        light_dir=tuple(
            np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5),
                      -0.85])),
        albedo_freq=float(rng.uniform(4.0, 10.0)),
        albedo_phase=(float(rng.uniform(0, 6)), float(rng.uniform(0, 6))),
        tints=tuple(rng.uniform(0.5, 1.0, 3)),
    )
    if i % 2 == 1:
        out["shape"] = _two_sphere_shape(rng)
    return out


def build_config(dims: int = 128, samples: int = 64, bf16: bool = True,
                 agg: str = "pallas") -> Config:
    """The model configuration of scripts/quality_synthetic.py:77
    (its evaluation part)."""
    cfg = Config()
    m = cfg.model
    m.volume.volume_dims = tuple(max(dims >> i, 2) for i in range(5))
    m.render.n_samples = samples
    m.render.n_importance = samples
    m.sdf_network.packed_trilerp = True
    m.color_network.packed_bilerp = True
    m.volume.packed_bilerp = agg
    if bf16:
        m.volume.dtype = "bfloat16"
        m.reg_network.dtype = "bfloat16"
        m.sdf_network.volume_dtype = "bfloat16"
        m.color_network.packed_dtype = "bfloat16"
    return cfg


def _direction_to_nearest_lobe(pts, centers, radii):
    near_k = np.argmin(np.stack([
        np.abs(np.linalg.norm(pts - c, axis=-1) - r)
        for c, r in zip(centers, radii)], -1), -1)
    dirs = np.zeros_like(pts)
    for k, (c, r) in enumerate(zip(centers, radii)):
        d = pts - c
        d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
        dirs = np.where((near_k == k)[:, None], d, dirs)
    return dirs


def _observed(pts, dirs, intrs, c2ws, hw):
    """Points facing and inside the frustum of at least one camera."""
    H, W = hw
    obs = np.zeros(len(pts), bool)
    for v in range(c2ws.shape[0]):
        cam = c2ws[v][:3, 3]
        facing = np.sum(dirs * (cam[None] - pts), axis=-1) > 0
        w2c = np.linalg.inv(c2ws[v])
        p_cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        uvw = p_cam @ intrs[v].T
        xy = uvw[:, :2] / np.maximum(uvw[:, 2:], 1e-8)
        infr = ((uvw[:, 2] > 0) & (xy[:, 0] >= 0) & (xy[:, 0] < W)
                & (xy[:, 1] >= 0) & (xy[:, 1] < H))
        obs |= facing & infr
    return obs


def mesh_metrics(verts, tris, scene_kw, raw, label) -> Dict[str, float]:
    """Mask-cleaned mesh accuracy and visible-surface completeness against
    the analytic shape (scripts/quality_synthetic.py:101).

    Cleaning: faces seen inside the masks dilated by 2 px of more than one
    view, then the frustum first-hit consensus with components of >= 100
    faces. Accuracy: the mean |distance| to the surface of the cleaned
    vertices within 0.1 of it (the GT box crop) that face and lie in the
    frustum of a camera (the ObsMask analog). Completeness: the mean
    distance from 20,000 surface samples visible from a camera to the
    nearest cleaned vertex."""
    from scipy.spatial import cKDTree

    from gens_torch.data.synthetic import (shape_distance, shape_spheres,
                                           shape_surface_samples)
    from gens_torch.mesh.clean import (clean_mesh_by_mask,
                                       clean_mesh_outside_frustum)

    centers, radii = shape_spheres(scene_kw.get("shape"),
                                   scene_kw.get("radius", 0.5))
    out = {}
    if not len(verts):
        return {f"{label}_acc_mean": float("nan")}
    masks = np.asarray(raw["masks"])
    intrs = np.asarray(raw["intrs"])
    c2ws = np.asarray(raw["c2ws"])
    hw = masks.shape[1:3]
    cverts, ctris = clean_mesh_by_mask(
        np.asarray(verts), np.asarray(tris), masks, intrs, c2ws,
        min_nb_visible=1, dilate_radius=2)
    if len(ctris):
        cverts, ctris = clean_mesh_outside_frustum(
            cverts, ctris, intrs, c2ws, hw, min_component=100)
    out[f"{label}_verts_raw"] = int(len(verts))
    out[f"{label}_verts_clean"] = int(len(cverts))
    if not len(cverts):
        return out
    signed = np.min(np.stack([
        np.linalg.norm(cverts - c, axis=-1) - r
        for c, r in zip(centers, radii)], -1), -1)
    pts = cverts[signed < 0.1]
    out[f"{label}_verts_bbox"] = int(len(pts))
    if not len(pts):
        return out
    obs = _observed(pts, _direction_to_nearest_lobe(pts, centers, radii),
                    intrs, c2ws, hw)
    scored = pts[obs] if obs.any() else pts
    out[f"{label}_verts_scored"] = int(obs.sum())
    d2s = shape_distance(scored, centers, radii)
    out[f"{label}_acc_mean"] = float(d2s.mean())
    out[f"{label}_acc_p50"] = float(np.percentile(d2s, 50))
    out[f"{label}_acc_p90"] = float(np.percentile(d2s, 90))
    d2s_all = shape_distance(cverts, centers, radii)
    out[f"{label}_acc_mean_uncropped"] = float(d2s_all.mean())

    rng = np.random.RandomState(0)
    pts = shape_surface_samples(centers, radii, 20000, rng)
    vis = _observed(pts, _direction_to_nearest_lobe(pts, centers, radii),
                    intrs, c2ws, hw)
    s2d, _ = cKDTree(cverts).query(pts[vis], k=1)
    out[f"{label}_comp_mean"] = float(np.mean(s2d))
    out[f"{label}_comp_p90"] = float(np.percentile(s2d, 90))
    out[f"{label}_overall"] = 0.5 * (out[f"{label}_acc_mean"]
                                     + out[f"{label}_comp_mean"])
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def eval_scene(model, scene_kw: Dict, tag: str, hw, device,
               mesh_res: int = 192, n_views: int = EVAL_VIEWS,
               spread: float = SPREAD) -> Dict[str, float]:
    """One-shot scene build from ``n_views`` views, full-image render at
    stride 2, K3 mesh, cleaning and the geometric error
    (scripts/quality_synthetic.py:456). Adds the phases' seconds as
    ``<tag>_<phase>_s``."""
    from gens_torch.data.synthetic import make_scene
    from gens_torch.mesh.extract import eval_sdf_grid, grid_to_mesh

    raw = make_scene(n_views=n_views, hw=hw, n_rays=16, seed=123,
                     spread=spread, **scene_kw)
    t = {k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(device)
         for k in ("imgs", "intrs", "c2ws", "near", "far")}
    secs = {}
    _sync(device)
    t0 = time.perf_counter()
    scene = model.build_scene(t["imgs"], t["intrs"], t["c2ws"])
    _sync(device)
    secs["build_scene"] = time.perf_counter() - t0

    H, W = hw
    ys, xs = np.meshgrid(np.arange(0, H, RENDER_STRIDE),
                         np.arange(0, W, RENDER_STRIDE), indexing="ij")
    pix = np.stack([xs.ravel(), ys.ravel(),
                    np.ones(xs.size)], -1).astype(np.float32)
    intr, c2w = raw["intrs"][0], raw["c2ws"][0]
    d = pix @ np.linalg.inv(intr).T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_d = (d @ c2w[:3, :3].T).astype(np.float32)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).astype(np.float32)
    gt = raw["imgs"][0][ys.ravel(), xs.ravel()]
    npad = (-len(rays_o)) % CHUNK
    ro = torch.from_numpy(np.concatenate(
        [rays_o, rays_o[-1:].repeat(npad, 0)])).to(device)
    rd = torch.from_numpy(np.concatenate(
        [rays_d, rays_d[-1:].repeat(npad, 0)])).to(device)
    t0 = time.perf_counter()
    cols = [model.renderer.render(ro[i:i + CHUNK], rd[i:i + CHUNK],
                                  t["near"], t["far"], scene,
                                  cos_anneal_ratio=1.0)["color_fine"].float()
            for i in range(0, ro.shape[0], CHUNK)]
    color = torch.cat(cols)[:len(rays_o)].cpu().numpy()
    secs["render"] = time.perf_counter() - t0
    mse = float(((color - gt) ** 2).mean())
    psnr = 20.0 * np.log10(1.0 / np.sqrt(mse + 1e-12))

    t0 = time.perf_counter()
    sdf_fn = model.renderer.sdf_fn_for_extraction(scene.volumes)
    grid = eval_sdf_grid(sdf_fn, [-1] * 3, [1] * 3, mesh_res, device,
                         block=64)
    secs["mesh_grid"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, tris = grid_to_mesh(grid, [-1] * 3, [1] * 3)
    secs["isosurface"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = mesh_metrics(verts, tris, scene_kw,
                     {"masks": raw["view_masks"], "intrs": raw["intrs"],
                      "c2ws": raw["c2ws"]}, tag)
    secs["clean_and_score"] = time.perf_counter() - t0
    m[f"{tag}_psnr"] = float(psnr)
    m[f"{tag}_rays"] = int(len(rays_o))
    m[f"{tag}_rays_per_s"] = len(rays_o) / secs["render"]
    m.update({f"{tag}_{k}_s": v for k, v in secs.items()})
    return m


def main(argv: Sequence[str] = None) -> Dict:
    p = argparse.ArgumentParser("gens_torch.eval.quality")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--scenes", default=",".join(SCENES))
    p.add_argument("--hw", type=int, nargs=2, default=(480, 640))
    p.add_argument("--dims", type=int, default=128,
                   help="finest volume-cascade resolution")
    p.add_argument("--samples", type=int, default=64,
                   help="n_samples = n_importance")
    p.add_argument("--mesh-res", type=int, default=192)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    tags = [s for s in args.scenes.split(",") if s]
    unknown = sorted(set(tags) - set(SCENES))
    if unknown:
        raise ValueError(f"unknown scenes {unknown}; choose from "
                         f"{sorted(SCENES)}")

    from gens_torch.convert import load_checkpoint, load_params
    from gens_torch.main import resolve_device
    from gens_torch.models.gens import GenSModel

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = build_config(args.dims, args.samples)
    payload = load_checkpoint(args.ckpt)
    stored = sorted({str(np.asarray(a).dtype) for a in
                     _leaves(payload["params"])})
    model = GenSModel(cfg.model)
    load_params(model, payload)
    model = model.to(device).eval()
    results = {"config": {"hw": list(args.hw), "mesh_res": args.mesh_res,
                          "samples": args.samples, "bf16": True,
                          "volume_dims": list(cfg.model.volume.volume_dims),
                          "packed": True, "eval_views": EVAL_VIEWS,
                          "spread": SPREAD, "render_stride": RENDER_STRIDE,
                          "chunk": CHUNK},
               "ckpt": args.ckpt, "ckpt_step": int(payload.get("step", 0)),
               "params_stored_dtype": stored,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")}
    for tag in tags:
        results.update(eval_scene(model, scene_params(SCENES[tag]), tag,
                                  tuple(args.hw), device, args.mesh_res))
        print(json.dumps({k: v for k, v in results.items()
                          if k.startswith(tag + "_")}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", args.out, flush=True)
    return results


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
