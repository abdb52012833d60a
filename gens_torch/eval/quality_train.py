"""The training phases of the quality protocol of
scripts/quality_synthetic.py, on the card: phase a (the single-scene
overfit), b (multi-scene generalization with the pseudo-SDF and
pseudo-depth terms), ft (the per-scene finetune of a generalizable
checkpoint, in ``gens_torch/eval/quality_finetune.py``), all (a, then b)
and eval (the saved checkpoints rescored).

    python -m gens_torch.eval.quality_train --phase a|b|ft|all|eval \
        [--steps-a 1500] [--steps-b 4000] [--steps-ft 2000] \
        [--n-train-scenes 6] [--train-views 5] [--eval-views 3] \
        [--spread 0.5] [--hw 128] [--w 0] [--rays 512] [--dims 64] \
        [--samples 32] [--bf16] [--agg-packed table|table_bf16|pallas|diff] \
        [--agg-remat full] [--var-lr-mult 1.0] [--resume-from CKPT] \
        [--inv-s-ramp S0:S1] [--gen-ckpt runs/quality_gen.ckpt] \
        [--inflight-every 1000] [--stop-at STEP] [--skip-eval] \
        [--ckpt-out F] [--runs-dir runs] [--seed 0] \
        [--out QUALITY_torch.json] [--device cpu]

Frames are ``hw`` x ``w or hw``. Phase a trains one synthetic scene
(``scene_params(0)``, ``train_views`` views, 64 pre-generated batches) for
``steps_a`` steps from a seeded init with the cosine anneal ending at
``steps_a // 4``, evaluates it through ``gens_torch.eval.quality.eval_scene``
(``eval_views`` views, a stride-2 render, a ``mesh_res``³ mesh through K3,
cleaning and the geometric error) and writes ``runs/quality_overfit.ckpt``.
Phase b trains ``n_train_scenes`` scenes, ``max(steps_b // n // 4, 8)``
batches each with exact pseudo depths and surface points, seeds ``10000 (i
+ 1)``, interleaved round-robin, with the anneal ending at ``steps_b // 8``,
``pseudo_sdf_weight`` 1 and ``pseudo_depth_weight`` 0.05; it warm-starts
from ``--resume-from`` (a JAX pickle, fp16 leaves widened exactly to f32,
or a port checkpoint), forces the variance up a log-linear ``--inv-s-ramp``,
writes ``runs/quality_gen.ckpt`` before its evaluations and scores the
held-out sphere (``heldout``), the held-out union (``heldout_union``) and
training scene 0 (``trained``). ``--phase eval`` rescores
``runs/quality_overfit.ckpt`` and ``--gen-ckpt`` where they exist.
``--ckpt-out`` names the checkpoint of ``--phase a``, ``b`` or ``ft``
(default ``runs/quality_overfit.ckpt``, ``quality_gen.ckpt``,
``quality_ft.ckpt``); ``--phase all`` writes the defaults.

The configuration is the script's ``build_config``: a ``dims``³ …
``max(dims >> 4, 2)``³ cascade, ``samples`` + ``samples`` samples, 512
sparse points, packed lookups, ``volume.packed_bilerp = --agg-packed``,
the four bf16 dtype keys under ``--bf16``, and the LR schedule in steps
(``epochs = steps``, ``warmup = max(steps // 20, 1)``). Under
``--agg-packed pallas`` the aggregation's backward is K1 at every scale;
the port's kernels need no splat window, so the script's window probe is
not carried over.

Step ``s`` draws its perturb noise and sparse points from a CPU generator
seeded with ``s`` (the counterpart of ``jax.random.PRNGKey(step)``), so a
run resumed from its in-flight checkpoint draws what an uninterrupted one
draws. The in-flight checkpoint (``<runs-dir>/<--out's stem>_<tag>_inflight.ckpt``
with the tag ``overfit``, ``gen`` or ``ft``, every ``--inflight-every``
steps and at a segment's end) is the port's training checkpoint (numpy
optimizer state) with the scheduler's position, the curve so far and the
segments; an existing one is resumed and overrides a warm start. A run
stopped by ``--stop-at`` writes its segment to ``--out`` and skips the
evaluation; the next call continues it. ``--skip-eval`` trains and saves
the checkpoint only.

Results merge in place into ``--out`` under the script's keys (``<tag>_curve``:
rows every 25 steps and at the last step with ``loss``, ``psnr``,
``eikonal_loss``, ``color_loss``, ``mfc_loss``, ``sparse_loss`` and
``step``; ``<tag>_ms_per_step``, ``<tag>_compile_s``, and ``eval_scene``'s
``<scene>_*``), beside the port's own (``<tag>_segments``, the launch
counts, the peak device memory, ``<tag>_steps_done``). The step time is the
host clock over the steps after a segment's first, with a device
synchronize at both ends; ``<tag>_compile_s`` is the first step's seconds,
on the card including the build of any kernel it runs. The file is
flushed after each training and each evaluation. The entry point runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gens_torch.config import Config
from gens_torch.eval.quality import eval_scene, scene_params
from gens_torch.utils.profiling import counter

CURVE_EVERY = 25
CURVE_KEYS = ("loss", "psnr", "eikonal_loss", "color_loss", "mfc_loss",
              "sparse_loss")
# the checkpoint each phase writes (scripts/quality_synthetic.py:574, :627,
# :777)
CKPT_DEFAULTS = {"a": os.path.join("runs", "quality_overfit.ckpt"),
                 "b": os.path.join("runs", "quality_gen.ckpt"),
                 "ft": os.path.join("runs", "quality_ft.ckpt")}
# phase b's evaluations: (tag, scene)
GEN_EVALS = (("heldout", -1), ("heldout_union", -2), ("trained", 0))


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


def gen_cfg(args) -> Config:
    """Phase b's configuration (scripts/quality_synthetic.py:582-585)."""
    cfg = build_cfg(args, args.steps_b)
    cfg.train.anneal_end = args.steps_b // 8
    cfg.train.loss.pseudo_sdf_weight = 1.0
    cfg.train.loss.pseudo_depth_weight = 0.05
    return cfg


def frame(args) -> tuple:
    return (args.hw, args.w or args.hw)


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


def gen_schedule(steps_b: int, n_scenes: int) -> List[tuple]:
    """Phase b's per-scene (scene, batches, seed0)
    (scripts/quality_synthetic.py:588-592)."""
    per_scene = max(steps_b // n_scenes // 4, 8)
    return [(i, per_scene, 10000 * (i + 1)) for i in range(n_scenes)]


def interleave(per_scene: Sequence[Sequence]) -> list:
    """The scenes' batches round-robin (scripts/quality_synthetic.py:595-598)."""
    return [b[j % len(b)] for j in range(max(len(b) for b in per_scene))
            for b in per_scene]


def gen_batches(args, device) -> list:
    return interleave([
        pregen_batches(scene_params(i), n, True, seed0, frame(args),
                       args.rays, args.train_views, args.spread, device)[0]
        for i, n, seed0 in gen_schedule(args.steps_b, args.n_train_scenes)])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_segment(step_call: Callable, batches: Sequence[Dict],
                  anneal_end: float, n_steps: int, start: int, end: int,
                  tag: str, device, curve: List[Dict],
                  keys: Sequence[str] = CURVE_KEYS, every: int = CURVE_EVERY,
                  save: Optional[Callable[[int], None]] = None,
                  save_every: int = 0,
                  after_step: Optional[Callable[[int], None]] = None) -> Dict:
    """Steps [start, end) of an ``n_steps`` run: step ``s`` takes batch ``s
    % len(batches)``, the anneal ``min(1, s / anneal_end)`` and a CPU
    generator seeded with ``s``; ``curve`` gains a row of ``keys`` every
    ``every`` steps and at the run's last step; ``save(s + 1)`` runs every
    ``save_every`` steps before the segment's end. Returns the segment:
    its steps, ms a step, first step's seconds, K1 launches, peak device
    memory and card."""
    k1_before = counter("k1.launches")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    t_compile = 0.0
    for step in range(start, end):
        anneal = min(1.0, step / max(anneal_end, 1))
        metrics = step_call(batches[step % len(batches)], anneal,
                            torch.Generator().manual_seed(step))
        if after_step is not None:
            after_step(step)
        if step == start:
            _sync(device)
            t_compile = time.perf_counter() - t0
            t0 = time.perf_counter()
        if step % every == 0 or step == n_steps - 1:
            row = {k: float(metrics[k]) for k in keys}
            row["step"] = step
            curve.append(row)
            print(f"[{tag}] step {step}: loss {row['loss']:.4f} psnr "
                  f"{row['psnr']:.2f} eik {row['eikonal_loss']:.4f} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)
        if save and save_every and (step + 1) % save_every == 0 \
                and step + 1 < end:
            save(step + 1)
    _sync(device)
    ms_per_step = (time.perf_counter() - t0) / max(end - 1 - start, 1) * 1e3
    print(f"[{tag}] steps {start}-{end} of {n_steps}, first step "
          f"{t_compile:.1f}s, {ms_per_step:.1f} ms/step", flush=True)
    return {"start": start, "end": end, "ms_per_step": ms_per_step,
            "compile_s": t_compile,
            "k1_launches": counter("k1.launches") - k1_before,
            "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                            if device.type == "cuda" else None),
            "card": card_line(device)}


def _save_inflight(path, step, step_fn, curve, segments) -> None:
    from gens_torch.train.checkpoint import save_checkpoint

    save_checkpoint(path, 0, step, step_fn.model, step_fn.optimizer,
                    extra={"scheduler": step_fn.scheduler.state_dict(),
                           "curve": curve, "segments": segments})


def run_training(model, cfg: Config, batches: Sequence[Dict], n_steps: int,
                 tag: str, device, init_params=None,
                 inflight_path: Optional[str] = None,
                 save_every: int = 1000, var_ramp=None,
                 stop_at: Optional[int] = None) -> Dict:
    """The script's ``run_training`` through the port's ``TrainStep``.
    ``init_params`` (a checkpoint's path or payload, either package's)
    warm-starts the params; an in-flight checkpoint at ``inflight_path``
    overrides them. ``var_ramp`` = (inv_s0, inv_s1) projects the variance
    parameter up to a log-linear ramp after each step. ``stop_at`` ends
    this call's segment at that step with an in-flight checkpoint. Returns
    {curve, segments, end}: ``end`` is the step the params were trained to
    and a segment is one call's steps (:func:`train_segment`)."""
    from gens_torch.convert import load_checkpoint, load_params
    from gens_torch.train.checkpoint import load_optimizer_state
    from gens_torch.train.step import TrainStep

    if init_params is not None:
        payload = load_params(model, init_params)
        print(f"[{tag}] warm start from "
              f"{init_params if isinstance(init_params, str) else 'params'}"
              f" (step {payload.get('step')})", flush=True)
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

    def after_step(step):
        frac = (step + 1) / max(n_steps, 1)
        inv_s_floor = var_ramp[0] * (var_ramp[1] / var_ramp[0]) ** frac
        with torch.no_grad():
            v = model.variance.variance
            v.copy_(torch.clamp(v, min=math.log(inv_s_floor) / 10.0))

    segments.append(train_segment(
        lambda inputs, anneal, gen: step_fn(inputs, anneal,
                                            use_match_features=False,
                                            generator=gen),
        batches, cfg.train.anneal_end, n_steps, start, end, tag, device,
        curve, save=inflight_path and (lambda s: _save_inflight(
            inflight_path, s, step_fn, curve, segments)),
        save_every=save_every,
        after_step=after_step if var_ramp is not None else None))
    if inflight_path:
        _save_inflight(inflight_path, end, step_fn, curve, segments)
    return {"curve": curve, "segments": segments, "end": end}


def record_run(results: Dict, tag: str, run: Dict) -> None:
    """A run's curve, segments and their summary under ``<tag>_*``: ms a
    step over the steps after each segment's first, the first segment's
    first-step seconds, K1 launches a step, peak device memory, the step
    reached."""
    results[f"{tag}_curve"] = run["curve"]
    segs = results[f"{tag}_segments"] = run["segments"]
    if segs:
        timed = [max(g["end"] - 1 - g["start"], 1) for g in segs]
        results[f"{tag}_ms_per_step"] = sum(
            g["ms_per_step"] * n for g, n in zip(segs, timed)) / sum(timed)
        results[f"{tag}_compile_s"] = segs[0]["compile_s"]
        results[f"{tag}_k1_launches_per_step"] = sum(
            g["k1_launches"] for g in segs) / sum(g["end"] - g["start"]
                                                  for g in segs)
        peaks = [g["peak_mem_gb"] for g in segs if g["peak_mem_gb"]]
        if peaks:
            results[f"{tag}_train_peak_mem_gb"] = max(peaks)
    results[f"{tag}_steps_done"] = run["end"]


def inflight_path(args, tag: str) -> str:
    stem = os.path.splitext(os.path.basename(args.out))[0]
    return os.path.join(args.runs_dir, f"{stem}_{tag}_inflight.ckpt")


def _evaluate(model, args, results, flush, device, tags) -> int:
    """``eval_scene`` of each (tag, scene), flushed after each; returns
    K3's launches in them."""
    model.eval()
    before = counter("k3.launches")
    for tag, scene in tags:
        results.update(eval_scene(model, scene_params(scene), tag,
                                  frame(args), device, args.mesh_res,
                                  n_views=args.eval_views,
                                  spread=args.spread))
        flush()
    return counter("k3.launches") - before


def phase_a(args, results: Dict, flush, device) -> bool:
    """The single-scene overfit (scripts/quality_synthetic.py:559-579).
    Returns whether the run reached its last step (a phase stopped by
    ``--stop-at`` ends the call)."""
    from gens_torch.models.gens import GenSModel
    from gens_torch.train.checkpoint import save_params_checkpoint

    cfg = build_cfg(args, args.steps_a)
    cfg.train.anneal_end = args.steps_a // 4
    torch.manual_seed(args.seed)
    model = GenSModel(cfg.model).to(device)
    batches, _ = pregen_batches(scene_params(0), 64, False, 0, frame(args),
                                args.rays, args.train_views, args.spread,
                                device)
    run = run_training(model, cfg, batches, args.steps_a, "overfit", device,
                       inflight_path=inflight_path(args, "overfit"),
                       save_every=args.inflight_every, stop_at=args.stop_at)
    record_run(results, "overfit", run)
    if run["curve"]:
        results["overfit_psnr_first"] = run["curve"][0]["psnr"]
        results["overfit_psnr_last"] = run["curve"][-1]["psnr"]
    flush()
    if run["end"] < args.steps_a:
        print(f"[overfit] stopped at step {run['end']} of {args.steps_a}; "
              f"the next call resumes {inflight_path(args, 'overfit')}",
              flush=True)
        return False
    if not args.skip_eval:
        results["overfit_k3_launches_eval"] = _evaluate(
            model, args, results, flush, device, (("overfit", 0),))
    save_params_checkpoint(ckpt_path(args, "a"), run["end"], model)
    summary(results)
    return True


def phase_b(args, results: Dict, flush, device) -> bool:
    """Multi-scene generalization (scripts/quality_synthetic.py:581-644):
    the pseudo-labelled batches of ``n_train_scenes`` scenes round-robin,
    a warm start from ``--resume-from``, the ``--inv-s-ramp``; the
    checkpoint (``{epoch: 0, step, params}``, the step trained) before the
    evaluations."""
    from gens_torch.models.gens import GenSModel
    from gens_torch.train.checkpoint import save_params_checkpoint

    cfg = gen_cfg(args)
    torch.manual_seed(args.seed)
    model = GenSModel(cfg.model).to(device)
    batches = gen_batches(args, device)
    ramp = (tuple(float(x) for x in args.inv_s_ramp.split(":"))
            if args.inv_s_ramp else None)
    run = run_training(model, cfg, batches, args.steps_b, "gen", device,
                       init_params=args.resume_from or None,
                       inflight_path=inflight_path(args, "gen"),
                       save_every=args.inflight_every, var_ramp=ramp,
                       stop_at=args.stop_at)
    record_run(results, "gen", run)
    flush()
    if run["end"] < args.steps_b:
        print(f"[gen] stopped at step {run['end']} of {args.steps_b}; the "
              f"next call resumes {inflight_path(args, 'gen')}", flush=True)
        return False
    save_params_checkpoint(ckpt_path(args, "b"), run["end"], model)
    if not args.skip_eval:
        results["gen_k3_launches_eval"] = _evaluate(
            model, args, results, flush, device, GEN_EVALS)
    summary(results)
    return True


def phase_eval(args, results: Dict, flush, device) -> bool:
    """Rescore the saved checkpoints (scripts/quality_synthetic.py:786-809):
    ``runs/quality_overfit.ckpt`` as ``overfit`` and ``--gen-ckpt`` as
    ``heldout``, ``heldout_union`` and ``trained``, where they exist."""
    from gens_torch.convert import load_params
    from gens_torch.models.gens import GenSModel

    for path, n_steps, tags in (
            (CKPT_DEFAULTS["a"], args.steps_a, (("overfit", 0),)),
            (args.gen_ckpt, args.steps_b, GEN_EVALS)):
        if not os.path.exists(path):
            continue
        model = GenSModel(build_cfg(args, n_steps).model)
        load_params(model, path)
        _evaluate(model.to(device), args, results, flush, device, tags)
    summary(results)
    return True


def summary(results: Dict) -> None:
    print(json.dumps({k: v for k, v in results.items()
                      if not k.endswith(("curve", "segments"))}, indent=1),
          flush=True)


def ckpt_path(args, phase: str) -> str:
    if args.ckpt_out and args.phase == phase:
        return args.ckpt_out
    return CKPT_DEFAULTS[phase]


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
    p.add_argument("--phase", default="a",
                   choices=["a", "b", "ft", "all", "eval"],
                   help="all: a, then b")
    p.add_argument("--steps-a", type=int, default=1500)
    p.add_argument("--steps-b", type=int, default=4000)
    p.add_argument("--steps-ft", type=int, default=2000)
    p.add_argument("--n-train-scenes", type=int, default=6)
    p.add_argument("--train-views", type=int, default=5,
                   help="views of a training scene (1 reference + sources)")
    p.add_argument("--eval-views", type=int, default=3,
                   help="views of an evaluated or finetuned scene")
    p.add_argument("--spread", type=float, default=0.5,
                   help="fraction of the camera ring the views span")
    p.add_argument("--hw", type=int, default=128)
    p.add_argument("--w", type=int, default=0,
                   help="image width when it differs from --hw")
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
    p.add_argument("--resume-from", default="",
                   help="phase b: warm-start the params from this "
                        "checkpoint (either package's)")
    p.add_argument("--mesh-res", type=int, default=192)
    p.add_argument("--agg-remat", default="full",
                   choices=["full", "save_gathers", "save_gathers_proj"])
    p.add_argument("--inv-s-ramp", default=None,
                   help="phase b: a forced inv_s schedule 's0:s1'; the "
                        "variance is projected up to its log-linear ramp "
                        "after each step")
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
                   help="where the in-flight checkpoints go, named after "
                        "--out")
    p.add_argument("--ckpt-out", default=None,
                   help="the checkpoint of --phase a, b or ft (default "
                        "runs/quality_overfit.ckpt, quality_gen.ckpt, "
                        "quality_ft.ckpt)")
    p.add_argument("--gen-ckpt", default=CKPT_DEFAULTS["b"],
                   help="the generalizable checkpoint that ft finetunes "
                        "and eval rescores")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="QUALITY_torch.json")
    args = p.parse_args(argv)
    if args.ckpt_out and args.phase in ("all", "eval"):
        p.error(f"--ckpt-out names one phase's checkpoint; --phase "
                f"{args.phase} writes or reads the defaults")
    return args


def main(argv: Sequence[str] = None) -> Dict:
    args = parse_args(argv)
    from gens_torch.eval.quality_finetune import phase_ft
    from gens_torch.main import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    results: Dict = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results.update(json.load(f))
    results["config"] = {"hw": list(frame(args)), "rays": args.rays,
                         "mesh_res": args.mesh_res, "samples": args.samples,
                         "bf16": args.bf16,
                         "volume_dims": [max(args.dims >> i, 2)
                                         for i in range(5)],
                         "packed": True, "agg_packed": args.agg_packed,
                         "steps_a": args.steps_a, "steps_b": args.steps_b,
                         "steps_ft": args.steps_ft,
                         "n_train_scenes": args.n_train_scenes,
                         "train_views": args.train_views,
                         "eval_views": args.eval_views,
                         "spread": args.spread,
                         "device": (torch.cuda.get_device_name(device)
                                    if device.type == "cuda" else "cpu"),
                         "card": card_line(device),
                         "torch": torch.__version__}

    def flush():
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    phases = {"a": [phase_a], "b": [phase_b], "all": [phase_a, phase_b],
              "ft": [phase_ft], "eval": [phase_eval]}[args.phase]
    for phase in phases:
        if not phase(args, results, flush, device):
            break
    flush()
    print("wrote", args.out, flush=True)
    return results


if __name__ == "__main__":
    main()
