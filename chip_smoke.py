#!/usr/bin/env python3
"""On-card smoke run of the gens_torch serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds K3 (gens_torch/csrc/sdf_mlp.cu) and K1 (gens_torch/csrc/splat.cu),
   one nvcc each, started together, and the native isosurface, from the
   sources in the checkout.
3. The val path, through its entry point ``gens_torch.main --mode val``, at
   the full width of confs/dtu.yaml's model (256³…16³ cascade, 64+64
   samples, 4 up-sample rounds, 128-wide SDF MLP with 129 outputs) on the
   trained weights of artifacts/quality_gen_r05_sharpen.pkl, over a
   synthetic scene of 3 views at 480x640, val_res_level 4 (19,200 rays in
   512-ray chunks) and a 512³ mesh. The launch counters are zeroed just
   before and read just after; K3 must have launched. Then one 64-plane slab
   of the SDF grid against the plain MLP, K3 against its plain version on
   one 64³ chunk (262,144 rows) with timings, and the GPU port against the
   CPU port on a small scene.
4. The train path, through ``gens_torch.main --mode train`` on confs/dtu.yaml
   from a fresh seeded init: 3 synthetic scenes of 5 views (reference + 4
   sources) at 480x640, 512 rays, one epoch = 3 steps. Counters zeroed just
   before and read just after; K1 must have launched 25 times a step (5
   scales x 5 views). Every loss term finite, every trained module moved,
   the checkpoint readable by the val path's loader. Per-step ms, one
   step's build_scene / render / backward / optimizer ms (CUDA events) and
   the peak device memory.
5. K1 against its plain version on the scale-0 (xy, ct) of one view captured
   in that run, in both operand dtypes, timed beside the plain version and
   ``grid_sampler_2d_backward``; one training step of a small seeded model
   on the GPU against the CPU (loss and gradients).
6. Prints the card line, the kernels JSON line and, last, the ok line.

Any failed check raises, so the script exits non-zero and prints no result.
Build outputs and the runs' files go under build/ in the checkout.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5  # f32 both sides, other sum order
SLAB_TOL = 1e-4          # the slab adds the cascade lookup, shared by both
# K1 against its plain version, as a fraction of max |plain|: both sum each
# pixel's contributions (tens to hundreds of f32 terms) with float atomics in
# a run-dependent order; the operand rounding is the same on both sides
K1_TOL = 1e-4
# one training step of a small model, GPU against CPU: f32 on both sides
# (no TF32), the aggregation backward through K1's atomics on the GPU;
# gradients compared as ||g_gpu - g_cpu|| / ||g_cpu|| per module
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-3, 2e-2


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    from gens_torch.main import main as gens_main
    from gens_torch.mesh import isosurface
    from gens_torch.mesh.extract import eval_sdf_grid
    from gens_torch.ops import fused_mlp as fm
    from gens_torch.ops import splat as k1
    from gens_torch.ops.cuda_build import build_libraries

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = build_libraries(["sdf_mlp.cu", "splat.cu"])
    isosurface.build_library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc " + ", ".join(
        f"{k} {v[1]} s" for k, v in built.items()) + ")", flush=True)
    for _, _, ptxas in built.values():
        print(ptxas.strip(), flush=True)
    print(f"K1 float4 atomics: {k1.vector_atomics()}", flush=True)

    # -- the serving path, through its entry point --------------------------
    exp = os.path.join(REPO, "build", "chip_smoke")
    argv = ["--conf", os.path.join(REPO, "confs", "dtu.yaml"), "--mode", "val",
            "--resume", os.path.join(REPO, "artifacts",
                                     "quality_gen_r05_sharpen.pkl"),
            "--set", f"base_exp_dir={exp}", "mesh_resolution=512",
            "val_dataset.dataset_name=synthetic", 'val_dataset.scene=["s0"]',
            "val_dataset.num_src_view=2", "val_dataset.img_hw=[480,640]",
            "val_dataset.val_res_level=4"]
    torch.cuda.reset_peak_memory_stats()
    fm.sdf_mlp_fused.launches = 0
    k1.splat_bilinear.launches = 0
    t0 = time.perf_counter()
    runner = gens_main(argv)
    wall = time.perf_counter() - t0
    launches = fm.sdf_mlp_fused.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = runner.stats[0]
    cfg = runner.cfg
    assert tuple(cfg.model.volume.volume_dims) == (256, 128, 64, 32, 16)
    assert cfg.model.sdf_network.d_hidden == 128
    assert cfg.model.sdf_network.d_out == 129
    assert launches == (512 // 64) ** 3, launches
    assert st["rays"] == 120 * 160, st["rays"]
    assert st["n_tris"] > 0, "empty mesh"
    assert st["grid_finite"] and st["render_finite"]
    assert np.isfinite(st["psnr"])
    print("val path: " + json.dumps({
        "wall_s": wall, "build_scene_ms": st["build_scene_s"] * 1e3,
        "render_rays_per_s": st["rays_per_s"], "render_s": st["render_s"],
        "mesh_grid_s": st["mesh_grid_s"], "isosurface_s": st["isosurface_s"],
        "n_tris": st["n_tris"], "psnr": st["psnr"],
        "render_depth_loss": st["render_depth_loss"],
        "sdf_depth_loss": st["sdf_depth_loss"],
        "peak_mem_gb": peak_gb, "k3_launches": launches}), flush=True)

    # -- one 64-plane slab of the K3 grid against the plain MLP -------------
    model, scene = runner.model, runner.last_scene
    folded = fm.fold_sdf_mlp(model.sdf, device=dev)
    scale = model.sdf.cfg.scale

    def plain_sdf(p):
        x_pe, f_pe = model.sdf.encode(p, scene.volumes)
        return fm.sdf_mlp_plain(folded, x_pe, f_pe)[:, 0] / scale

    with torch.no_grad():
        slab = eval_sdf_grid(plain_sdf, [-1, -1, -1], [1, 1, 1], 512, dev,
                             x_range=(256, 320))
    slab_err = float(np.abs(slab - runner.last_sdf_grid[256:320]).max())
    print(f"slab x=256:320 max |K3 - plain| = {slab_err:.3g}", flush=True)
    assert slab_err <= SLAB_TOL, slab_err

    # -- K3 against its plain version on one 64³ chunk, timed ---------------
    r = torch.linspace(-1, 1, 512, device=dev)
    gx, gy, gz = torch.meshgrid(r[256:320], r[224:288], r[224:288],
                                indexing="ij")
    pts = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    with torch.no_grad():
        x_pe, f_pe = model.sdf.encode(pts, scene.volumes)
        x_pe, f_pe = x_pe.contiguous(), f_pe.contiguous()
        got = fm.sdf_mlp_fused(folded, x_pe, f_pe)
        ref = fm.sdf_mlp_plain(folded, x_pe, f_pe)
        torch.cuda.synchronize()
        k3_err = float((got - ref).abs().max())
        torch.testing.assert_close(got, ref, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        ms = cuda_ms(lambda: fm.sdf_mlp_fused(folded, x_pe, f_pe), 20)
        plain_ms = cuda_ms(lambda: fm.sdf_mlp_plain(folded, x_pe, f_pe), 10)
        encode_ms = cuda_ms(lambda: model.sdf.encode(pts, scene.volumes), 10)
    n = x_pe.shape[0]
    flops = n * sum(2 * w.shape[0] * w.shape[1] for w, _ in folded.weights)
    n_bytes = (4 * n * (x_pe.shape[1] + f_pe.shape[1] + got.shape[1])
               + 4 * folded.params.numel())
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    print(f"K3 on {n} rows: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {max(t_ops, t_bytes):.3f} ms ({flops:.4g} FLOP, "
          f"{n_bytes:.4g} B), {flops / ms / 1e9:.1f} TFLOP/s; cascade "
          f"lookup + PE of the chunk {encode_ms:.3f} ms", flush=True)
    print("render chunk: " + json.dumps(render_breakdown(runner)), flush=True)

    # -- the GPU port against the CPU port on a small scene ------------------
    share = check_small_scene(dev)
    print(f"small scene GPU vs CPU port: {share:.4f} of rays agree to 1e-3",
          flush=True)
    del runner, model, scene, folded, x_pe, f_pe, got, ref, pts
    torch.cuda.empty_cache()

    # -- the training path, through its entry point ------------------------
    k1_launches, captured = train_path(gens_main, dev)
    k1_row = k1_phase(captured, k1_launches)
    del captured
    torch.cuda.empty_cache()
    check_small_train(dev)

    kernels = [{
        "name": "sdf_mlp_fused", "route": "cuda",
        "source": "gens_torch/csrc/sdf_mlp.cu",
        "replaces": "gens_tpu/ops/pallas_mlp.py:52",
        "launches": launches, "max_abs_err": k3_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }, k1_row]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def render_breakdown(runner) -> dict:
    """CUDA-event ms of one 512-ray val chunk: the hierarchical sampler and
    the render core, apart."""
    from gens_torch.data.synthetic import SyntheticDataset
    from gens_torch.ops.sampling import hierarchical_sample

    vc = runner.cfg.val_dataset
    raw = SyntheticDataset(1, vc.num_src_view + 1, tuple(vc.img_hw),
                           val_res_level=vc.val_res_level)[0]
    t = runner._tensors(raw)
    ro, rd = t["rays_o"][:512], t["rays_d"][:512]
    r = runner.model.renderer
    scene, rc = runner.last_scene, runner.cfg.model.render
    with torch.no_grad():
        def sample():
            return hierarchical_sample(ro, rd, t["near"], t["far"],
                                       r.sdf_fn(scene.volumes), scene.mask(),
                                       rc.n_samples, rc.n_importance,
                                       rc.up_sample_steps)
        z = sample()
        return {"hierarchical_sample_ms": cuda_ms(sample, 5),
                "render_core_ms": cuda_ms(lambda: r.render_core(
                    ro, rd, z, 2.0 / rc.n_samples, scene), 5)}


def check_small_scene(dev) -> float:
    """build_scene + render of a tiny model with seeded random weights, on
    the GPU and on the CPU (the CPU port is held against the JAX package by
    tests/test_torch_slice.py). Returns the share of rays whose colours
    agree."""
    from gens_torch.config import Config
    from gens_torch.data.synthetic import make_scene
    from gens_torch.models.gens import GenSModel

    cfg = Config()
    m = cfg.model
    m.feature_network.d_enc = (8, 8, 8, 8, 8)
    m.volume.volume_dims = (32, 16, 8, 4, 2)
    m.render.n_samples, m.render.n_importance = 16, 16
    m.render.up_sample_steps = 2
    torch.manual_seed(0)
    cpu_model = GenSModel(m).eval()
    gpu_model = GenSModel(m).to(dev).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    s = make_scene(n_views=3, hw=(64, 64), n_rays=64)
    outs = []
    for model, d in ((cpu_model, "cpu"), (gpu_model, dev)):
        t = {k: torch.from_numpy(np.array(s[k])).to(d)
             for k in ("imgs", "intrs", "c2ws", "rays_o", "rays_d", "near",
                       "far")}
        with torch.no_grad():
            scene = model.build_scene(t["imgs"], t["intrs"], t["c2ws"])
            out = model.renderer.render(t["rays_o"], t["rays_d"], t["near"],
                                        t["far"], scene)
        outs.append(out["color_fine"].cpu())
    assert torch.isfinite(outs[1]).all()
    # the sampler's discrete choices may flip on a 1-ulp difference: at least
    # 90% of the rays agree to 1e-3, and the share is reported
    per_ray = (outs[0] - outs[1]).abs().amax(dim=1)
    share = float((per_ray <= 1e-3).float().mean())
    assert share >= 0.9, share
    return share


def train_path(gens_main, dev):
    """``gens_main --mode train`` at the DTU shape; returns K1's launches in
    that run and the scale-0 (xy, ct, hw, mm_dtype) of one view."""

    from gens_torch.convert import load_params
    from gens_torch.models.gens import GenSModel
    from gens_torch.ops import fused_mlp as fm
    from gens_torch.ops import splat as k1
    from gens_torch.runner import get_dataset

    captured = {}

    def capture(xy, ct, hw, mm_dtype):
        if hw == (480, 640) and not captured:
            captured.update(xy=xy.clone(), ct=ct.clone(), hw=hw,
                            mm_dtype=mm_dtype)

    exp = os.path.join(REPO, "build", "chip_smoke_train")
    argv = ["--conf", os.path.join(REPO, "confs", "dtu.yaml"),
            "--mode", "train", "--set", f"base_exp_dir={exp}",
            "train_dataset.dataset_name=synthetic",
            'train_dataset.scene=["s0","s1","s2"]',
            "train_dataset.num_src_view=4", "train_dataset.img_hw=[480,640]",
            "train_dataset.n_rays=512", "train.epochs=1"]
    k1.BilerpAggSplat.on_backward = capture
    torch.cuda.reset_peak_memory_stats()
    fm.sdf_mlp_fused.launches = 0
    k1.splat_bilinear.launches = 0
    t0 = time.perf_counter()
    runner = gens_main(argv)
    wall = time.perf_counter() - t0
    launches = k1.splat_bilinear.launches
    k1.BilerpAggSplat.on_backward = None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    cfg = runner.cfg
    rc = cfg.model.render
    assert tuple(cfg.model.volume.volume_dims) == (256, 128, 64, 32, 16)
    assert cfg.model.volume.packed_bilerp == "pallas"
    assert cfg.train_dataset.num_src_view == 4
    assert (rc.n_samples, rc.n_importance, rc.up_sample_steps) == (64, 64, 4)
    stats = runner.train_stats
    assert len(stats) == 3, len(stats)
    per_step = 5 * len(cfg.model.volume.volume_dims)
    assert launches == per_step * len(stats), launches
    assert captured, "no scale-0 splat was captured"
    for st in stats:
        bad = [k for k, v in st.items() if not np.isfinite(v)]
        assert not bad, (st["step"], bad)

    # every trained module moved from the seeded init; the frozen copy not
    torch.manual_seed(cfg.train.seed)
    init = GenSModel(cfg.model).state_dict()
    state = {k: v.detach().cpu() for k, v in runner.model.state_dict().items()}
    for top in ("feature", "reg", "sdf", "blending", "variance"):
        moved = max(float((state[k] - v).abs().max())
                    for k, v in init.items() if k.split(".")[0] == top)
        assert moved > 0, f"{top} did not move"
    ckpt = os.path.join(exp, "checkpoints", "model_000.ckpt")
    loaded = GenSModel(cfg.model)
    load_params(loaded, ckpt)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, state[k]), k

    # one more step, timed by phase, and one under the profiler
    inputs = runner._tensors(get_dataset(cfg.train_dataset, "train")[0])
    phase = runner.step_fn(inputs, 1.0, generator=runner.generator,
                           timing=True)
    step_ms = [st["step_s"] * 1e3 for st in stats]
    prof = profile_step(runner, inputs)
    # the profiler slows the host; the kernels' time against a plain step
    prof["device_share_of_later_steps"] = (
        prof["device_ms"] / float(np.mean(step_ms[1:])))
    print("train path: " + json.dumps({
        "wall_s": wall, "first_step_ms": step_ms[0],
        "later_steps_ms": step_ms[1:], "phase_ms": phase["phase_ms"],
        "profile": prof,
        "peak_mem_gb": peak_gb, "k1_launches": launches,
        "k1_launches_per_step": per_step,
        "losses": {k: v for k, v in stats[-1].items()
                   if k not in ("epoch", "step", "step_s")}}), flush=True)
    return launches, captured


def profile_step(runner, inputs) -> dict:
    """One training step under torch.profiler: the device time summed over
    the kernels and copies it ran (device-side events only: an operator's
    own entry repeats the time of the kernels it launched), its share of
    the step's wall time under the profiler, and the kernels that take the
    most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.step_fn(inputs, 1.0, generator=runner.generator)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    assert device_ms > 0, "the profiler recorded no device time"
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in top]}


def k1_phase(captured, launches) -> dict:
    """K1 against its plain version on the captured scale-0 inputs, both
    operand dtypes; times and the bound. Returns the kernels-line row."""
    from gens_torch.ops import splat as k1

    xy, ct, hw = captured["xy"], captured["ct"], captured["hw"]
    path_dtype = captured["mm_dtype"]
    n, C = ct.shape
    H, W = hw
    res = {}
    for mm in ("float32", "bfloat16"):
        got = k1.splat_bilinear(xy, ct, hw, mm)
        ref = k1.splat_plain(xy, ct, hw, mm)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        assert torch.isfinite(got).all()
        assert err <= K1_TOL * scale, (mm, err, scale)
        res[mm] = {"max_abs_err": err, "max_abs_ref": scale,
                   "ms": cuda_ms(lambda: k1.splat_bilinear(xy, ct, hw, mm),
                                 20),
                   "plain_ms": cuda_ms(lambda: k1.splat_plain(xy, ct, hw, mm),
                                       5)}
    # yardstick: ATen's grid-sample backward (bilinear, zeros, align_corners)
    # on the same queries, as a (1, C, 1, N) sample of an (H, W) image
    grid = torch.stack([xy[:, 0] / (W - 1) * 2 - 1,
                        xy[:, 1] / (H - 1) * 2 - 1], -1).view(1, 1, n, 2)
    go = ct.t().contiguous().view(1, C, 1, n)
    inp = torch.empty((1, C, H, W), device=ct.device)

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(
            go, inp, grid, 0, 0, True, [True, False])[0]

    lib_err = float((library()[0].permute(1, 2, 0)
                     - k1.splat_plain(xy, ct, hw, "float32")).abs().max())
    library_ms = cuda_ms(library, 5)
    live = int((ct != 0).any(dim=1).sum())
    # each input read once (ct of every query, xy of the live ones), the
    # image written once; 3 f32 operations per channel and corner
    n_bytes = 4 * C * n + 8 * live + 4 * C * H * W
    flops = 4 * 3 * C * live
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    print("K1 scale 0, one view: " + json.dumps({
        "queries": n, "live": live, "hw": [H, W], "path_mm_dtype": path_dtype,
        "by_mm_dtype": res, "library_ms": library_ms,
        "library_max_abs_err_vs_plain_f32": lib_err,
        "bound_ms": max(t_bytes, t_ops), "bytes": n_bytes, "flop": flops}),
        flush=True)
    return {
        "name": "splat_bilinear", "route": "cuda",
        "source": "gens_torch/csrc/splat.cu",
        "replaces": "gens_tpu/ops/pallas_splat.py:59",
        "launches": launches, "max_abs_err": res[path_dtype]["max_abs_err"],
        "ms": res[path_dtype]["ms"], "plain_ms": res[path_dtype]["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


def check_small_train(dev) -> None:
    """One training step of a tiny seeded model on the GPU (K1 in the
    aggregation backward) and on the CPU (its plain version), same batch and
    draws: the loss and the feature-net and SDF gradients agree."""
    from gens_torch.config import Config
    from gens_torch.data.synthetic import SyntheticDataset
    from gens_torch.models.gens import GenSModel
    from gens_torch.train.step import TrainStep

    cfg = Config()
    m = cfg.model
    m.feature_network.d_enc = (8, 8, 8, 8, 8)
    m.volume.volume_dims = (32, 16, 8, 4, 2)
    m.volume.packed_bilerp, m.volume.splat_mm_dtype = "pallas", "float32"
    m.render.n_samples, m.render.n_importance = 16, 16
    m.render.up_sample_steps, m.render.perturb = 2, 0.0
    m.render.patch_size, m.render.n_sparse_pts = 5, 64
    torch.manual_seed(0)
    models = {"cpu": GenSModel(m)}
    models["gpu"] = GenSModel(m).to(dev)
    models["gpu"].load_state_dict(models["cpu"].state_dict())
    raw = SyntheticDataset(1, 3, (64, 64), n_rays=64, n_pseudo_pts=64,
                           mode="train")[0]
    sparse = torch.rand((64, 3), generator=torch.Generator().manual_seed(1))
    loss, grads = {}, {}
    for name, d in (("cpu", "cpu"), ("gpu", dev)):
        inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(d)
                  for k, v in raw.items()
                  if isinstance(v, np.ndarray) and v.dtype == np.float32}
        step = TrainStep(models[name], cfg, 1)
        out = step(inputs, 0.5, sparse_pts=sparse * 2 - 1)
        loss[name] = float(out["loss"])
        grads[name] = {k: p.grad.detach().cpu()
                       for k, p in models[name].named_parameters()
                       if p.grad is not None}
    rel = abs(loss["gpu"] - loss["cpu"]) / abs(loss["cpu"])
    errs = {}
    for top in ("feature", "sdf"):
        keys = [k for k in grads["cpu"] if k.split(".")[0] == top]
        a = torch.cat([grads["cpu"][k].reshape(-1) for k in keys])
        b = torch.cat([grads["gpu"][k].reshape(-1) for k in keys])
        errs[top] = float((a - b).norm() / a.norm())
    print("train step GPU vs CPU port: " + json.dumps({
        "loss": loss, "loss_rel_err": rel, "grad_rel_err": errs}),
        flush=True)
    assert rel <= TRAIN_LOSS_RTOL, rel
    assert all(e <= TRAIN_GRAD_TOL for e in errs.values()), errs


if __name__ == "__main__":
    sys.exit(main())
