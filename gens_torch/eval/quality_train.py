"""The training phases of the quality protocol of
scripts/quality_synthetic.py, on the card: phase a, the single-scene
overfit.

    python -m gens_torch.eval.quality_train --phase a [--steps-a 1500] \
        [--hw 128] [--rays 512] [--dims 64] [--samples 32] [--bf16] \
        [--agg-packed table|table_bf16|pallas|diff] [--agg-remat full] \
        [--var-lr-mult 1.0] [--inflight-every 1000] [--stop-at STEP] \
        [--out QUALITY_torch.json] [--device cpu]

Phase a trains one synthetic scene (``scene_params(0)``, 5 views at
``hw``², 512 rays a step from 64 pre-generated batches) for ``steps_a``
steps from a seeded init, through the port's ``TrainStep`` with the
cosine anneal ending at ``steps_a // 4``, then evaluates the overfit
scene through ``gens_torch.eval.quality.eval_scene`` (3 views, a stride-2
render, a ``mesh_res``³ mesh through K3, cleaning and the geometric error)
and writes ``--ckpt-out`` (``runs/quality_overfit.ckpt``: ``{epoch: 0, step,
params}``, the JAX layout). ``--phase b`` (multi-scene generalization) and ``--phase ft``
(per-scene finetune) are refused: they are not ported yet.

The configuration is the script's ``build_config``: a ``dims``³ …
``max(dims >> 4, 2)``³ cascade, ``samples`` + ``samples`` samples, 512
sparse points, packed lookups, ``volume.packed_bilerp = --agg-packed``,
the four bf16 dtype keys under ``--bf16``, and the LR schedule in steps
(``epochs = steps``, ``warmup = max(steps // 20, 1)``). Under
``--agg-packed pallas`` the aggregation's backward is K1 at the scales of
a multiple of 16 (64, 32 and 16 at the defaults); the port's kernels need
no splat window, so the script's window probe is not carried over.

Step ``s`` draws its perturb noise and sparse points from a CPU generator
seeded with ``s`` (the counterpart of ``jax.random.PRNGKey(step)``), so a
run resumed from its in-flight checkpoint draws what an uninterrupted one
draws. The in-flight checkpoint (``<runs-dir>/<--out's stem>_overfit_inflight.ckpt``,
every ``--inflight-every`` steps and at a segment's end) is the port's
training checkpoint (numpy optimizer state) with the scheduler's position,
the curve so far and the segments; an existing one is resumed. A run
stopped by ``--stop-at`` writes its segment to ``--out`` and skips the
evaluation; the next call continues it. ``--skip-eval`` trains and saves
the checkpoint only.

Results merge in place into ``--out`` under the script's keys
(``overfit_curve``: rows every 25 steps and at the last step with
``loss``, ``psnr``, ``eikonal_loss``, ``color_loss``, ``mfc_loss``,
``sparse_loss`` and ``step``; ``overfit_ms_per_step``,
``overfit_compile_s``, ``overfit_psnr_first`` / ``_last`` and
``eval_scene``'s ``overfit_*``), beside the port's own
(``overfit_segments``, the launch counts, the peak device memory). The
step time is the host clock over the steps after a segment's first, with
a device synchronize at both ends; ``overfit_compile_s`` is the first
step's seconds, on the card including the build of any kernel it runs.
The file is flushed after the training and after the evaluation. The entry point runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gens_torch.config import Config
from gens_torch.eval.quality import SPREAD, eval_scene, scene_params

# training views (reference + 4 sources) on the protocol's camera ring
TRAIN_VIEWS = 5
CURVE_EVERY = 25
CURVE_KEYS = ("loss", "psnr", "eikonal_loss", "color_loss", "mfc_loss",
              "sparse_loss")
# the script's phases that are not ported yet
NOT_PORTED = ("b", "ft")


def build_config(n_steps: int, packed: bool = True, dims: int = 64,
                 samples: int = 32, bf16: bool = False,
                 agg: str = "table") -> Config:
    """scripts/quality_synthetic.py::build_config."""
    cfg = Config()
    m = cfg.model
    m.volume.volume_dims = tuple(max(dims >> i, 2) for i in range(5))
    m.render.n_samples = samples
    m.render.n_importance = samples
    m.render.n_sparse_pts = 512
    m.sdf_network.packed_trilerp = packed
    m.color_network.packed_bilerp = packed
    m.volume.packed_bilerp = agg
    if bf16:
        m.volume.dtype = "bfloat16"
        m.reg_network.dtype = "bfloat16"
        m.sdf_network.volume_dtype = "bfloat16"
        m.color_network.packed_dtype = "bfloat16"
    # the LR schedule in steps (steps_per_epoch = 1)
    cfg.train.epochs = n_steps
    cfg.train.warmup = max(n_steps // 20, 1)
    return cfg


def build_cfg(args, n_steps: int) -> Config:
    """The script's ``build_cfg`` without its splat-window probe."""
    cfg = build_config(n_steps, dims=args.dims, samples=args.samples,
                       bf16=args.bf16, agg=args.agg_packed)
    cfg.model.volume.agg_remat = args.agg_remat
    cfg.train.lr_variance_mult = args.var_lr_mult
    return cfg


def pregen_batches(scene_kw: Dict, n_batches: int, with_pseudo: bool,
                   seed0: int, hw, n_rays: int, n_views: int, spread: float,
                   device) -> tuple:
    """The script's ``pregen_batches``: the scene's images, cameras and
    bounds rendered once and put on ``device``, shared by every batch; a
    batch's pixels drawn from ``RandomState((seed0 + 7919 b) % 2³¹)`` on
    the reference view; with ``with_pseudo`` the exact ray depths and 512
    surface points (tiled from 1200 samples drawn from
    ``RandomState(seed0 + b)``). Returns (batches, radius)."""
    from gens_torch.data.synthetic import (make_scene, shape_spheres,
                                           shape_surface_samples,
                                           trace_spheres)

    base = make_scene(n_views=n_views, hw=hw, n_rays=n_rays, seed=seed0,
                      spread=spread, **scene_kw)
    radius = base["radius"]
    centers, radii = shape_spheres(scene_kw.get("shape"), radius)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    shared = {k: dev(base[k]) for k in ("imgs", "intrs", "c2ws", "near",
                                        "far")}
    H, W = hw
    imgs0 = np.asarray(base["imgs"][0])
    c2w0 = np.asarray(base["c2ws"][0])
    inv_intr_T = np.linalg.inv(np.asarray(base["intrs"][0])).T
    batches = []
    for b in range(n_batches):
        rng = np.random.RandomState((seed0 + 7919 * b) % (2 ** 31))
        px = rng.randint(0, W, size=n_rays).astype(np.float32)
        py = rng.randint(0, H, size=n_rays).astype(np.float32)
        pix = np.stack([px, py, np.ones_like(px)], -1)
        d = pix @ inv_intr_T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        rd = (d @ c2w0[:3, :3].T).astype(np.float32)
        ro = np.broadcast_to(c2w0[:3, 3], rd.shape).astype(np.float32)
        inp = dict(shared)
        inp["rays_o"] = dev(ro)
        inp["rays_d"] = dev(rd)
        inp["color"] = dev(imgs0[py.astype(int), px.astype(int)])
        if with_pseudo:
            t, hit, _ = trace_spheres(ro, rd, centers, radii)
            cam_z = (rd @ np.linalg.inv(c2w0[:3, :3]).T)[:, 2]
            inp["pseudo_depth"] = dev(
                np.where(hit, t * cam_z, 0.0).astype(np.float32))
            prng = np.random.RandomState(seed0 + b)
            pts = shape_surface_samples(centers, radii, 1200, prng)
            reps = -(-512 // len(pts))
            inp["pseudo_pts"] = dev(
                np.tile(pts, (reps, 1))[:512].astype(np.float32))
        batches.append(inp)
    return batches, radius


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _save_inflight(path, step, step_fn, curve, segments) -> None:
    from gens_torch.train.checkpoint import save_checkpoint

    save_checkpoint(path, 0, step, step_fn.model, step_fn.optimizer,
                    extra={"scheduler": step_fn.scheduler.state_dict(),
                           "curve": curve, "segments": segments})


def run_training(model, cfg: Config, batches: Sequence[Dict], n_steps: int,
                 tag: str, device, inflight_path: Optional[str] = None,
                 save_every: int = 1000, var_ramp=None,
                 stop_at: Optional[int] = None) -> Dict:
    """The script's ``run_training`` through the port's ``TrainStep``.
    ``var_ramp`` = (inv_s0, inv_s1) projects the variance parameter up to
    a log-linear ramp after each step. ``stop_at`` ends this call's
    segment at that step with an in-flight checkpoint. Returns {curve,
    segments, end}: a segment is one call's steps [start, end) with its
    ms a step, first step's seconds, K1 launches, peak device memory and
    card."""
    from gens_torch.convert import load_checkpoint, load_params
    from gens_torch.ops import splat as k1
    from gens_torch.train.checkpoint import load_optimizer_state
    from gens_torch.train.step import TrainStep

    step_fn = TrainStep(model, cfg, steps_per_epoch=1)
    start, curve, segments = 0, [], []
    if inflight_path and os.path.exists(inflight_path):
        payload = load_checkpoint(inflight_path)
        load_params(model, payload)
        load_optimizer_state(step_fn.optimizer, model, payload["opt_state"])
        step_fn.scheduler.load_state_dict(payload["scheduler"])
        start = int(payload["step"])
        curve, segments = list(payload["curve"]), list(payload["segments"])
        print(f"[{tag}] resumed in-flight at step {start}", flush=True)
    end = n_steps if stop_at is None else min(stop_at, n_steps)
    if start >= end:
        print(f"[{tag}] in-flight step {start} >= {end}: skipping training",
              flush=True)
        return {"curve": curve, "segments": segments, "end": start}
    k1_before = k1.splat_bilinear.launches
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    t_compile = 0.0
    for step in range(start, end):
        inputs = batches[step % len(batches)]
        anneal = min(1.0, step / max(cfg.train.anneal_end, 1))
        gen = torch.Generator().manual_seed(step)
        metrics = step_fn(inputs, anneal, use_match_features=False,
                          generator=gen)
        if var_ramp is not None:
            frac = (step + 1) / max(n_steps, 1)
            inv_s_floor = var_ramp[0] * (var_ramp[1] / var_ramp[0]) ** frac
            with torch.no_grad():
                v = model.variance.variance
                v.copy_(torch.clamp(v, min=math.log(inv_s_floor) / 10.0))
        if step == start:
            _sync(device)
            t_compile = time.perf_counter() - t0
            t0 = time.perf_counter()
        if step % CURVE_EVERY == 0 or step == n_steps - 1:
            row = {k: float(metrics[k]) for k in CURVE_KEYS}
            row["step"] = step
            curve.append(row)
            print(f"[{tag}] step {step}: loss {row['loss']:.4f} psnr "
                  f"{row['psnr']:.2f} eik {row['eikonal_loss']:.4f} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)
        if (inflight_path and save_every and (step + 1) % save_every == 0
                and step + 1 < end):
            _save_inflight(inflight_path, step + 1, step_fn, curve,
                           segments)
    _sync(device)
    dt = time.perf_counter() - t0
    ms_per_step = dt / max(end - 1 - start, 1) * 1e3
    k1_run = k1.splat_bilinear.launches - k1_before
    segments.append({
        "start": start, "end": end, "ms_per_step": ms_per_step,
        "compile_s": t_compile, "k1_launches": k1_run,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
        "card": card_line(device)})
    if inflight_path:
        _save_inflight(inflight_path, end, step_fn, curve, segments)
    print(f"[{tag}] steps {start}-{end} of {n_steps}, first step "
          f"{t_compile:.1f}s, {ms_per_step:.1f} ms/step", flush=True)
    return {"curve": curve, "segments": segments, "end": end}


def phase_a(args, results: Dict, flush, device) -> None:
    """The single-scene overfit (scripts/quality_synthetic.py:559)."""
    from gens_torch.models.gens import GenSModel
    from gens_torch.ops import fused_mlp as k3
    from gens_torch.train.checkpoint import save_params_checkpoint

    hw = (args.hw, args.hw)
    cfg = build_cfg(args, args.steps_a)
    cfg.train.anneal_end = args.steps_a // 4
    torch.manual_seed(args.seed)
    model = GenSModel(cfg.model).to(device)
    kw = scene_params(0)
    batches, _ = pregen_batches(kw, 64, with_pseudo=False, seed0=0, hw=hw,
                                n_rays=args.rays, n_views=TRAIN_VIEWS,
                                spread=SPREAD, device=device)
    stem = os.path.splitext(os.path.basename(args.out))[0]
    inflight = os.path.join(args.runs_dir, f"{stem}_overfit_inflight.ckpt")
    run = run_training(model, cfg, batches, args.steps_a, "overfit", device,
                       inflight_path=inflight,
                       save_every=args.inflight_every, stop_at=args.stop_at)
    curve = run["curve"]
    results["overfit_curve"] = curve
    results["overfit_segments"] = run["segments"]
    segs = run["segments"]
    if segs:
        # over the segments: the steps after each one's first, its launches
        timed = [max(g["end"] - 1 - g["start"], 1) for g in segs]
        results["overfit_ms_per_step"] = sum(
            g["ms_per_step"] * n for g, n in zip(segs, timed)) / sum(timed)
        results["overfit_compile_s"] = segs[0]["compile_s"]
        results["overfit_k1_launches_per_step"] = sum(
            g["k1_launches"] for g in segs) / sum(g["end"] - g["start"]
                                                  for g in segs)
        if device.type == "cuda":
            results["overfit_train_peak_mem_gb"] = max(
                g["peak_mem_gb"] for g in segs)
    results["overfit_steps_done"] = run["end"]
    if curve:
        results["overfit_psnr_first"] = curve[0]["psnr"]
        results["overfit_psnr_last"] = curve[-1]["psnr"]
    flush()
    if run["end"] < args.steps_a:
        print(f"[overfit] stopped at step {run['end']} of {args.steps_a}; "
              f"the next call resumes {inflight}", flush=True)
        return
    if not args.skip_eval:
        model.eval()
        k3_before = k3.sdf_mlp_fused.launches
        results.update(eval_scene(model, kw, "overfit", hw, device,
                                  args.mesh_res))
        results["overfit_k3_launches_eval"] = (k3.sdf_mlp_fused.launches
                                               - k3_before)
        flush()
    save_params_checkpoint(args.ckpt_out, args.steps_a, model)
    print(json.dumps({k: v for k, v in results.items()
                      if not k.endswith(("curve", "segments"))}, indent=1),
          flush=True)


def card_line(device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, as every number
    of a run is reported beside them; None off the card."""
    smi = shutil.which("nvidia-smi")
    if device.type != "cuda" or smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    lines = out.stdout.strip().splitlines()
    index = device.index or 0
    return lines[index] if out.returncode == 0 and len(lines) > index \
        else None


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("gens_torch.eval.quality_train")
    p.add_argument("--phase", default="a", choices=["a", "b", "ft"])
    p.add_argument("--steps-a", type=int, default=1500)
    p.add_argument("--hw", type=int, default=128)
    p.add_argument("--rays", type=int, default=512)
    p.add_argument("--dims", type=int, default=64,
                   help="finest volume-cascade resolution")
    p.add_argument("--samples", type=int, default=32,
                   help="n_samples = n_importance")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--agg-packed", default="table",
                   choices=["diff", "table", "table_bf16", "pallas"],
                   help="volume.packed_bilerp: the aggregation's gradient "
                        "(pallas: K1)")
    p.add_argument("--mesh-res", type=int, default=192)
    p.add_argument("--agg-remat", default="full",
                   choices=["full", "save_gathers", "save_gathers_proj"])
    p.add_argument("--var-lr-mult", type=float, default=1.0)
    p.add_argument("--inflight-every", type=int, default=1000,
                   help="in-flight checkpoint cadence (steps; 0: none "
                        "before the end)")
    p.add_argument("--stop-at", type=int, default=None,
                   help="end this call's training at this step with an "
                        "in-flight checkpoint (the next call resumes it)")
    p.add_argument("--skip-eval", action="store_true",
                   help="save the checkpoint and skip the evaluation")
    p.add_argument("--seed", type=int, default=0,
                   help="torch seed of the model's init")
    p.add_argument("--runs-dir", default="runs",
                   help="where the in-flight checkpoint goes, named after "
                        "--out")
    p.add_argument("--ckpt-out", default=os.path.join("runs",
                                                      "quality_overfit.ckpt"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="QUALITY_torch.json")
    return p.parse_args(argv)


def main(argv: Sequence[str] = None) -> Dict:
    args = parse_args(argv)
    if args.phase in NOT_PORTED:
        raise SystemExit(
            f"gens_torch.eval.quality_train: --phase {args.phase} is not "
            "ported yet (ROADMAP.md, A6, plans it); run --phase a, or "
            "scripts/quality_synthetic.py in the JAX package")
    from gens_torch.main import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    hw = (args.hw, args.hw)
    results: Dict = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results.update(json.load(f))
    results["config"] = {"hw": list(hw), "rays": args.rays,
                         "mesh_res": args.mesh_res, "samples": args.samples,
                         "bf16": args.bf16,
                         "volume_dims": [max(args.dims >> i, 2)
                                         for i in range(5)],
                         "packed": True, "agg_packed": args.agg_packed,
                         "steps_a": args.steps_a,
                         "train_views": TRAIN_VIEWS,
                         "device": (torch.cuda.get_device_name(device)
                                    if device.type == "cuda" else "cpu"),
                         "card": card_line(device),
                         "torch": torch.__version__}

    def flush():
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    phase_a(args, results, flush, device)
    return results


if __name__ == "__main__":
    main()
