#!/usr/bin/env python3
"""On-card smoke run of the gens_torch serving, training and finetune paths
on one NVIDIA GPU.

    python3 chip_smoke.py

(``--rank-main`` and ``--rank-parity`` run one rank of the parallel phase;
the script starts them itself.)

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds K3 (gens_torch/csrc/sdf_mlp.cu), K4
   (gens_torch/csrc/cascade_pe.cu), K5 (gens_torch/csrc/isosurface.cu), K1
   (gens_torch/csrc/splat.cu), K2 (gens_torch/csrc/window_fwd.cu) and P1-P3
   (gens_torch/csrc/gather_probe.cu), one nvcc each, started together,
   and the native isosurface and raycaster and the zstd decoder, from the
   sources in the checkout.
3. The val path, through its entry point ``gens_torch.main --mode val``, at
   the full width of confs/dtu.yaml's model (256³…16³ cascade, 64+64
   samples, 4 up-sample rounds, 128-wide SDF MLP with 129 outputs) on the
   trained weights of artifacts/quality_gen_r05_sharpen.pkl, over a
   synthetic scene of 3 views at 480x640, val_res_level 4 (19,200 rays in
   512-ray chunks) and a 512³ mesh. The launch counters are zeroed just
   before and read just after; K3 must have launched, and K4 as often
   (once a 64³ chunk each, here and wherever K3's count is checked below),
   and K5 once (once a mesh of a grid on the card, here and below).
   Then one 64-plane slab
   of the SDF grid against the plain MLP, K3 against its plain version on
   one 64³ chunk (262,144 rows) with timings (bound: the chunk's FLOP three
   times, 3xTF32, at the TF32 tensor-core peak; the f32 SIMT bound of the
   earlier kernel printed beside it) and at n = 127, 128, 129 (one 128-row
   tile and a row either side); K4 against its plain version on the same
   chunk, f32 and bf16, timed (bound: the chunk's bytes at the HBM peak),
   and at n = 1, 127, 128, 129; K5 on the path's 512³ grid against the
   native host code, vertices and triangles bit-equal and in order, timed
   (bound: one read of the grid and the mesh written at the HBM peak; the
   host code's seconds beside it); and the GPU port against the CPU port on
   a small scene.
4. The train path, through ``gens_torch.main --mode train`` on confs/dtu.yaml
   from a fresh seeded init: 3 synthetic scenes of 5 views (reference + 4
   sources) at 480x640, 512 rays, one epoch = 3 steps. Counters zeroed just
   before and read just after; K1 must have launched 25 times a step (5
   scales x 5 views). Every loss term finite, every trained module moved,
   the checkpoint readable by the val path's loader. Per-step ms, one
   step's build_scene / render / backward / optimizer ms (CUDA events) and
   the peak device memory.
5. K1 against its plain version on the 25 splats (5 scales x 5 views)
   captured in the first step of that run: at every scale of one view in
   all three roundings (f32, bf16 fused_u, bf16 per_channel), timed, and
   beside the plain version and ``grid_sampler_2d_backward`` at scale 0;
   the path's rounding on all 25, timed, for K1's total in a step; the
   bricks that took K1's direct path in the path's run and in each check;
   the scale-0 footprint statistics (corner-adds per distinct pixel within
   a warp and within bricks of several shapes, the bricks' pixel boxes).
   One training step of a small seeded model on the GPU against the CPU
   (loss and gradients).
6. The finetune path, through ``gens_torch.main --mode finetune`` on
   confs/dtu_finetune.yaml from the trained artifact, with
   ``volume.packed_bilerp: pallas`` and ``splat_impl: kernel2f``: a
   synthetic scene of 3 views at 1152x1600, 512 rays, 64+64 samples, 6
   steps (two permutations of the views), validation at the end (512³ mesh,
   288x400 val rays). Counters zeroed just before and read just after; K2
   must have launched 15 times, all in the volume build (5 scales x 3
   views), K3 512 times, K5 once. Every loss finite, the five volumes and
   the sdf, blending and variance modules moved, the validation's grid
   against the plain MLP on one 64-plane slab, a surface in the mesh of the
   state the finetune started from (its built volumes, the artifact's MLP),
   the finetune checkpoint read back equal. init_volumes ms, per-step ms, one
   step's render / backward / optimizer ms (CUDA events), the validation's
   mesh and render seconds, its surface's size and margin, and the peak
   device memory.
7. K2 against its plain version on the scale-0 (image, xy) of one view
   captured in that run, in both operand dtypes, timed beside the plain
   version and ``F.grid_sample``; the raw volumes under "kernel2f" against
   the gather forward ("auto") on the run's features; one finetune step of
   a small seeded model on the GPU against the CPU.
8. The quality evaluation, through ``gens_torch.eval.quality`` on the
   trained artifact, held-out sphere only (480x640, 128³ cascade, 64+64
   samples, bf16, 76,800 rays, a 192³ mesh, cleaning and scoring). Counters
   zeroed just before and read just after; K3 must have launched 27 times.
   Held-out accuracy within 15% and PSNR within 0.5 dB of the JAX record,
   QUALITY_r05_sharpen_repro.json.
   Then the same params in gens_tpu's default checkpoint format, the orbax
   OCDBT directory artifacts/quality_gen_r05_sharpen.orbax (written by
   gens_tpu's save_checkpoint, tests/_write_orbax_fixture.py), read through
   the port's own OCDBT, zarr and zstd readers (no orbax, tensorstore or
   zstandard on this machine): every leaf bit-equal to the pickle's,
   dtype included, with the read's seconds and MB/s; the quality
   evaluation of the held-out sphere from the pickle and from the
   directory (K3 27 each), every score equal; ``gens_torch.main --mode
   finetune`` with 0 steps (the volume build alone, 3 views at 1152x1600
   under ``kernel2f``, K2 15) from the directory and from the pickle, the
   volumes, masks and features equal. These pairs run with cuDNN's
   deterministic convolutions (without, two runs on the same params
   differ). One "orbax path" line.
9. The gather probes, through ``gens_torch.probes.gather --iters 2`` (every
   row of both TPU probe scripts; counters zeroed just before and read just
   after, P1-P3 launched in it), printed on one ``gather_probe`` line; then
   P1, P2 and P3 against their plain versions, bit for bit, on every probe
   shape at 2^20 indices, timed beside their bound, the plain version and
   the library calls (``index_select``; for P3 also cuBLAS ``matmul`` of
   the same one-hot).
10. The DTU and BlendedMVS readers, through ``gens_torch.main`` with only
   the data paths and the run length overridden, on trees written under
   build/ at the datasets' on-disk sizes (the synthetic sphere rendered
   from DTU-like rigs: 49 MVSNet cameras at 1600x1200, depth 425-905 mm,
   scan24 light 3 images, masks, PFM depths and pseudo depths at
   1200x1600 for 10 views; a BlendedMVS scene of 5 views, masked JPEGs at
   576x768). confs/dtu.yaml trains 3 steps (ref views 0-2; K1 25 a step,
   2048 pseudo points a step; per step the wait on the prefetch queue and
   an item's decode time), then ``--resume auto`` trains epoch 1 from the
   first run's checkpoint, its optimizer state read in the port's numpy
   form, with the config's validation at its end (K3 512);
   logs/metrics.jsonl holds the train and train_avg records. A JAX-form
   checkpoint of a seeded model at confs/dtu.yaml's width, its Adam state
   pickled under optax's class paths (written without optax), resumes
   ``--mode train`` for one step: the state read in its optax form, K1
   25, and the step's first moments b1 · mu + (1 - b1) · g of the carried
   mu within 1e-5 relative.
   ``--mode val`` on the trained artifact (K3 512, depth PNGs in magma);
   confs/dtu_finetune.yaml, 6 steps under ``kernel2f`` (K2 15, all in the
   volume build; K3 512 at its validation); a small DTU training step GPU
   against CPU; confs/bmvs.yaml ``--mode val`` (K3 512). Counters zeroed
   just before and read just after each run.
11. The options of the JAX model, through ``gens_torch.main`` on the
   DTU-layout tree at confs/dtu.yaml's width (256³…16³ cascade, 5 views at
   480x640, 512 rays, 64+64 samples, bf16 as the yaml sets it). "alt":
   ``backbone: mnasnet`` with its encoder from a ``pretrained_path``
   pickle that the phase writes from a seeded torchvision-layout state
   dict through the port's converter, ``use_global_attn`` and ``head:
   idr``; "adaptive": ``volume.agg: adaptive`` with ``d_volume`` = C. Each
   trains 3 steps from a seeded init (K1 25 a step under "alt", none under
   "adaptive", whose backward is the plain bilerp's) and then runs
   ``--mode val`` of one scene on that checkpoint with a 512³ mesh (K3
   512); counters zeroed just before and read just after each run. Per
   config one line: step times, the val scene's time and split, peak
   memory, launch counts. Then one tiny training step GPU against CPU per
   option, on the gradients of the module it adds (feature, agg, reg,
   blending).
12. Several ranks, on the DTU-layout tree: the one-process step at
   confs/dtu.yaml's widths (f32 dtypes, as the GPU-vs-CPU checks; K1 in
   the backward) from a seeded init on two items with fixed draws; a
   one-rank NCCL group running the sharded step's collectives (its view
   group the world) against it; then, when the card's compute mode lets
   two processes share it, two gloo ranks on cuda:0: the sharded step
   under view=2 (K1 15 a rank) and data=2 (K1 25) against it (loss 1e-3
   relative, gradients 2e-2 per module); ``gens_torch.main --mode train``
   of confs/dtu.yaml for 3 steps under parallel.view=2 and under
   parallel.data=2 (counters zeroed and read in each rank; per-rank step
   ms, data wait, K1 a step, peak memory); ``--mode val`` of two DTU
   items on two ranks (K3 512 on each) against one process (merged
   metrics within 1e-3); ``--mode val`` of one DTU item on two ranks, its
   rays split over both (K3 512 on rank 0, none on rank 1; the gathered
   render within 1e-5 relative of a one-process render, the metrics
   within 1e-3, rank 1 writing nothing); ``--mode finetune`` of
   confs/dtu_finetune.yaml under ``kernel2f`` on two ranks, 2 steps and
   one validation (256³ mesh, 288x400 rays) split over both (K2 15 and
   K3 64 on rank 0, none on rank 1; the split render within 1e-5
   relative of a one-process render of rank 0's saved state on the first
   two steps of chunks and the last). One line each: per-rank render
   seconds and rays, broadcast bytes and seconds, gather seconds, launch
   counts, peak memory, the check's seconds. Two ranks on one card
   time-slice it: their times are no scaling measurement. Every group of
   ranks has a timeout, and a failed rank fails the script.
13. Phase a of the quality protocol, through ``gens_torch.eval.quality_train
   --phase a --agg-packed pallas --bf16`` (5 views at 128x128, 512 rays, a
   64³…4³ cascade, 32+32 samples) for 50 steps from a seeded init, with its
   evaluation (3 views, a 192³ mesh). Counters zeroed just before and read
   just after; K1 must have launched 25 times a step (5 scales x 5 views:
   bf16 rounding at 64, 32 and 16, the exact f32 adjoint at 8 and 4), K3
   27 times at the evaluation. Every curve row finite and the step-25
   row's PSNR at least 5 dB above the first. Then K1 against its plain
   version on the 25 splats of the first step, timed for K1's total in a
   step, and one more step of the trained model under the profiler; then
   phase a's first forward ((a-table), f32, seed 0) at the script's widths
   on the GPU against the CPU: every loss term within 1e-3 relative, each
   term's gradient of each module within 2e-2, the MFC term's gradient of
   the SDF reported (its zero-crossing root is ill-conditioned).
   Phase b, through ``--phase b --n-train-scenes 2 --agg-packed pallas
   --bf16 --skip-eval`` (the same widths, pseudo-labelled batches of two
   scenes round-robin) for 50 steps: K1 exactly 25 a step and nothing
   else, every curve row finite, and one more step of the trained model
   under the profiler. Phase ft, through ``--phase ft`` from
   artifacts/quality_gen_r05_sharpen.pkl at the r05 width (480x640, a
   128³…8³ cascade, 64+64 samples, bf16, 512 rays) for 30 steps: K3 54
   times (the 192³ meshes of ft_init and ft) and nothing else, every
   curve row finite, and ft_init's accuracy within 5e-3 relative of the
   quality phase's held-out score of the same artifact in this process
   (the same scene's volumes from the same 3 views), and one finetune
   step from the artifact under the profiler. One line each.
14. Prints the card line, the kernels JSON line and, last, the ok line.

Any failed check raises, so the script exits non-zero and prints no result.
Build outputs and the runs' files go under build/ in the checkout.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5  # f32 both sides, other sum order
SLAB_TOL = 1e-4          # the slab adds the cascade lookup (K4 against plain)
K4_ATOL = 1e-6  # K4 against its plain version: the same arithmetic
# K1 against its plain version, as a fraction of max |plain|: both sum each
# pixel's contributions (tens to hundreds of f32 terms) with float atomics in
# a run-dependent order; the operand rounding is the same on both sides
K1_TOL = 1e-4
# one training step of a small model, GPU against CPU: f32 on both sides
# (no TF32), the aggregation backward through K1's atomics on the GPU;
# gradients compared as ||g_gpu - g_cpu|| / ||g_cpu|| per module
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-3, 2e-2
# K2 against its plain version, as a fraction of max |plain|: the same
# operand rounding and order of operations; nvcc may contract a multiply-add
# into an FMA
K2_TOL = 1e-5
# the raw volumes under "kernel2f" against the gather forward: they differ
# only by K2's bf16 rounding of hat_v, at most 2^-9 of each row weight, so a
# sample moves by at most 2^-9 A (A = max |feature| of the scale): the mean
# by at most 2^-9 A, the variance E[x²] - E[x]² by at most 4 * 2^-9 A²
# (1% added for the f32 sums)
AGG_EPS = 2.0 ** -9
# the quality phase against the JAX record of the same checkpoint: bf16 on
# another chip, the artifact's fp16 storage of the params and another order
# of atomics (the JAX f32 and bf16 evals of one checkpoint agreed within
# 0.3%)
QUALITY_RECORD = "QUALITY_r05_sharpen_repro.json"
QUALITY_ACC_RTOL, QUALITY_PSNR_ATOL = 0.15, 0.5
# the probe shapes the comparison runs at: P1 (E2), P2 and P3 (A)
GATHER_N = 1 << 20


@contextlib.contextmanager
def spying(module, name: str, spy):
    """Inside the block, ``module.name`` first calls ``spy`` with its
    arguments (a module global that callers look up when they call it)."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        spy(*args, **kwargs)
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


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
    from gens_torch.mesh import clean, isosurface
    from gens_torch.ops import fused_mlp as fm
    from gens_torch.ops import splat as k1
    from gens_torch.utils import libraries, zstd

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = libraries.build(libraries.cuda_libraries())
    libraries.build([isosurface.LIBRARY, clean.LIBRARY, zstd.LIBRARY])
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc " + ", ".join(
        f"{os.path.basename(k)} {v[1]} s" for k, v in built.items()) + ")",
        flush=True)
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
    zero_counts()
    t0 = time.perf_counter()
    runner = gens_main(argv)
    wall = time.perf_counter() - t0
    launches = launch_counts()["K3"]
    assert (launch_counts()["K1"], launch_counts()["K2"]) == (
        0, 0)
    assert launch_counts()["K4"] == launches, launch_counts()
    assert launch_counts()["K5"] == 1, launch_counts()
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
    slab_err = k3_slab_err(model.sdf, scene.volumes, runner.last_sdf_grid, dev)
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
        for n_edge in (127, 128, 129):
            torch.testing.assert_close(
                fm.sdf_mlp_fused(folded, x_pe[:n_edge], f_pe[:n_edge]),
                fm.sdf_mlp_plain(folded, x_pe[:n_edge], f_pe[:n_edge]),
                rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        ms = cuda_ms(lambda: fm.sdf_mlp_fused(folded, x_pe, f_pe), 20)
        plain_ms = cuda_ms(lambda: fm.sdf_mlp_plain(folded, x_pe, f_pe), 10)
        encode_ms = cuda_ms(lambda: model.sdf.encode(pts, scene.volumes), 10)
    n = x_pe.shape[0]
    flops = n * sum(2 * w.shape[0] * w.shape[1] for w, _ in folded.weights)
    n_bytes = (4 * n * (x_pe.shape[1] + f_pe.shape[1] + got.shape[1])
               + 4 * sum(w.numel() + b.numel() for w, b in folded.weights))
    # 3xTF32: three tensor-core products for every product of the function
    t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_simt = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    print(f"K3 on {n} rows: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {max(t_ops, t_bytes):.3f} ms (3xTF32 at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s; f32 SIMT bound "
          f"{t_simt:.3f} ms; {flops:.4g} FLOP, {n_bytes:.4g} B), "
          f"{3 * flops / ms / 1e9:.1f} TFLOP/s of TF32 products; cascade "
          f"lookup + PE of the chunk {encode_ms:.3f} ms", flush=True)
    k4_row = k4_phase(model.sdf, scene.volumes, pts, launches)
    k5_row = k5_phase(runner.last_sdf_grid, dev)
    print("render chunk: " + json.dumps(render_breakdown(runner)), flush=True)

    # -- the GPU port against the CPU port on a small scene ------------------
    share = check_small_scene(dev)
    print(f"small scene GPU vs CPU port: {share:.4f} of rays agree to 1e-3",
          flush=True)
    del runner, model, scene, folded, x_pe, f_pe, got, ref, pts
    torch.cuda.empty_cache()

    # -- the training path, through its entry point ------------------------
    k1_launches, captured, k1_bricks = train_path(gens_main, dev)
    k1_row = k1_phase(captured, k1_launches, k1_bricks)
    del captured
    torch.cuda.empty_cache()
    check_small_train(dev)

    # -- the finetune path, through its entry point ------------------------
    k2_launches, captured, ft_runner, cams = finetune_path(gens_main, dev)
    k2_row = k2_phase(captured, k2_launches)
    del captured
    check_agg_kernel2f(ft_runner, *cams)
    del ft_runner
    torch.cuda.empty_cache()
    check_small_finetune(dev)

    # -- the quality evaluation, through its entry point --------------------
    heldout = quality_path()
    torch.cuda.empty_cache()

    # -- the same params from gens_tpu's orbax format ------------------------
    orbax_path(gens_main, card)
    torch.cuda.empty_cache()

    # -- the gather probes, through their entry point ----------------------
    gather_launches = gather_probe_path()
    gather_rows = gather_phase(gather_launches)

    # -- the DTU and BlendedMVS readers, through the entry points ------------
    dtu_path(gens_main, dev)

    # -- the model options, through the entry point -------------------------
    options_path(gens_main, dev, os.path.join(REPO, "build", "chip_smoke_dtu"))

    # -- several ranks, through the entry point ----------------------------
    parallel_path(gens_main, dev,
                  os.path.join(REPO, "build", "chip_smoke_dtu"))
    torch.cuda.empty_cache()

    # -- phases a, b and ft of the quality protocol, through the entry point
    quality_train_path()
    torch.cuda.empty_cache()
    quality_gen_path()
    torch.cuda.empty_cache()
    quality_ft_path(heldout)

    kernels = [{
        "name": "sdf_mlp_fused", "route": "cuda",
        "source": "gens_torch/csrc/sdf_mlp.cu",
        "replaces": "gens_tpu/ops/pallas_mlp.py:52",
        "launches": launches, "max_abs_err": k3_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }, k4_row, k5_row, k1_row, k2_row] + gather_rows
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def k4_phase(sdf_net, volumes, pts, launches) -> dict:
    """K4 against its plain version on the 64³ chunk ``pts`` of the val
    path's cascade, in f32 and rounded to bf16, timed; bound: the chunk's
    bytes (points, outputs, and the rows of each scale inside the index box
    its corners span) at the HBM peak. Returns the kernel table's row (f32)."""
    from gens_torch.ops import cascade_pe as k4

    c = sdf_net.cfg
    args = (c.scale, c.multires, c.feat_multires)
    times = {}
    with torch.no_grad():
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            vols = [v.to(dt).contiguous() for v in volumes]
            got = k4.cascade_pe(pts, vols, *args)
            ref = k4.cascade_pe_plain(pts, vols, *args)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            equal = all(torch.equal(g, r) for g, r in zip(got, ref))
            assert err <= K4_ATOL, (name, err)
            for n_edge in (1, 127, 128, 129):
                for g, r in zip(k4.cascade_pe(pts[:n_edge], vols, *args),
                                k4.cascade_pe_plain(pts[:n_edge], vols,
                                                    *args)):
                    assert float((g - r).abs().max()) <= K4_ATOL, n_edge
            ms = cuda_ms(lambda: k4.cascade_pe(pts, vols, *args), 20)
            plain_ms = cuda_ms(lambda: k4.cascade_pe_plain(pts, vols, *args),
                               10)
            rows = 0
            for v in vols:
                X, Y, Z, C = v.shape
                span = 1
                for a, size in enumerate((X, Y, Z)):
                    u = torch.floor((pts[:, a] + 1.0) * 0.5 * (size - 1))
                    lo = max(int(u.min()), 0)
                    hi = min(int(u.max()) + 1, size - 1)
                    span *= max(hi - lo + 1, 0)
                rows += span * C * v.element_size()
            n_bytes = (pts.numel() * 4 + rows
                       + 4 * sum(t.numel() for t in got))
            bound = n_bytes / PEAK_BYTES * 1e3
            times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                               max_abs_err=err, bit_equal=equal,
                               bytes=n_bytes)
            print(f"K4 {name} on {pts.shape[0]} points: {ms:.4f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({n_bytes:.4g} "
                  f"B at {PEAK_BYTES / 1e12:.2f} TB/s), max |K4 - plain| "
                  f"{err:.3g}, bit-equal {equal}", flush=True)
    f32 = times["f32"]
    return {"name": "cascade_pe", "route": "cuda",
            "source": "gens_torch/csrc/cascade_pe.cu",
            "replaces": "none (XLA in gens_tpu/ops/pallas_mlp.py:139-141)",
            "launches": launches, "max_abs_err": f32["max_abs_err"],
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "bf16": times["bf16"]}


def k5_phase(grid, dev) -> dict:
    """K5 against the native host code on ``grid``, the val path's 512³
    grid as ``eval_sdf_grid`` returned it: vertices and triangles bit-equal
    and in order. Timed on the grid already on the card (count, scan, the
    totals' read, emit; CUDA events) and as ``grid_to_mesh`` runs it on the
    host array, which must be pinned (the upload, K5, the mesh's copy back;
    host clock, the best of 3); bound: one read of the grid and the mesh
    written at the HBM peak; the host code's ms as the plain column.
    Returns the kernel table's row."""
    from gens_torch.mesh.extract import isosurface_of
    from gens_torch.mesh.isosurface import marching_tetrahedra
    from gens_torch.ops import isosurface as k5

    host = np.asarray(grid)
    assert torch.from_numpy(host).is_pinned(), "the grid is not pinned"
    t0 = time.perf_counter()
    want = marching_tetrahedra(host, 0.0)
    plain_ms = (time.perf_counter() - t0) * 1e3
    g = torch.from_numpy(host).to(dev)
    got = k5.marching_tetrahedra_cuda(g)
    assert [a.shape for a in got] == [a.shape for a in want], (
        [a.shape for a in got], [a.shape for a in want])
    assert np.array_equal(got[0].view(np.int32), want[0].view(np.int32))
    assert np.array_equal(got[1], want[1])
    ms = cuda_ms(lambda: k5.extract_on_device(g), 10)
    upload_ms = cuda_ms(lambda: torch.from_numpy(host).to(dev), 3)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        isosurface_of(grid)
        walls.append((time.perf_counter() - t0) * 1e3)
    n_bytes = host.nbytes + want[0].nbytes + want[1].nbytes
    bound = n_bytes / PEAK_BYTES * 1e3
    print(f"K5 on the {'x'.join(map(str, host.shape))} val grid: {ms:.4f} ms "
          f"({len(want[0])} vertices, {len(want[1])} triangles), bound "
          f"{bound:.4f} ms ({n_bytes:.4g} B at {PEAK_BYTES / 1e12:.2f} "
          f"TB/s), host code {plain_ms:.1f} ms, bit-equal True; as "
          f"grid_to_mesh runs it {min(walls):.1f} ms (upload "
          f"{upload_ms:.1f} ms from pinned memory)", flush=True)
    return {"name": "isosurface", "route": "cuda",
            "source": "gens_torch/csrc/isosurface.cu",
            "replaces": "none (native/isosurface.cpp on the host, as "
                        "gens_tpu/mesh/isosurface.py binds it)",
            "launches": 1, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None, "grid_to_mesh_ms": min(walls),
            "upload_ms": upload_ms, "n_verts": len(want[0]),
            "n_tris": len(want[1])}


def k3_slab_err(sdf_net, volumes, grid, dev) -> float:
    """Max |K3 - plain| over the x = 256:320 slab of a 512³ mesh grid on
    [-1, 1]³ (``grid``, the path's K3 grid), the plain MLP on the same
    volumes and weights."""
    from gens_torch.mesh.extract import eval_sdf_grid
    from gens_torch.ops import fused_mlp as fm

    folded = fm.fold_sdf_mlp(sdf_net, device=dev)
    scale = sdf_net.cfg.scale

    def plain_sdf(p):
        x_pe, f_pe = sdf_net.encode(p, volumes)
        return fm.sdf_mlp_plain(folded, x_pe, f_pe)[:, 0] / scale

    with torch.no_grad():
        slab = eval_sdf_grid(plain_sdf, [-1, -1, -1], [1, 1, 1], 512, dev,
                             x_range=(256, 320))
    return float(np.abs(slab - grid[256:320]).max())


KERNELS = {"K3": "k3.launches", "K4": "k4.launches", "K5": "k5.launches",
           "K1": "k1.launches", "K2": "k2.launches",
           "P1": "p1.launches", "P2": "p2.launches", "P3": "p3.launches"}
_ZERO = {}


def grid_kernels(chunks: int, meshes: int = 1) -> dict:
    """The launches of ``meshes`` meshes of SDF grids of ``chunks`` 64³
    chunks in all: K4 (lookup + PE) and K3 (MLP) once a chunk each, K5 (the
    isosurface) once a mesh; none without chunks."""
    return {"K3": chunks, "K4": chunks, "K5": meshes if chunks else 0}


def zero_counts() -> None:
    """Count every kernel's launches from 0 from now on."""
    from gens_torch.utils.profiling import counter

    _ZERO.update((k, counter(c)) for k, c in KERNELS.items())


def launch_counts() -> dict:
    """Each kernel's launches since :func:`zero_counts`, by its name."""
    from gens_torch.utils.profiling import counter

    return {k: counter(c) - _ZERO.get(k, 0) for k, c in KERNELS.items()}


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
    that run, the inputs of its 25 splats in the first step (xy, ct, hw,
    mm_dtype, dim; on the host, so the first step's time includes their
    copy) and K1's brick counts over the run (live, direct)."""

    from gens_torch.convert import load_params
    from gens_torch.models.gens import GenSModel
    from gens_torch.ops import splat as k1
    from gens_torch.runner import get_dataset

    # the 25 splats of the first step, copied to the host (the device's peak
    # memory stays the run's own)
    captured = []

    def capture(xy, ct, hw, mm_dtype, layout, dim):
        if len(captured) < 25:
            captured.append({"xy": xy.cpu(), "ct": ct.cpu(), "hw": hw,
                             "mm_dtype": mm_dtype, "dim": dim})

    exp = os.path.join(REPO, "build", "chip_smoke_train")
    argv = ["--conf", os.path.join(REPO, "confs", "dtu.yaml"),
            "--mode", "train", "--set", f"base_exp_dir={exp}",
            "train_dataset.dataset_name=synthetic",
            'train_dataset.scene=["s0","s1","s2"]',
            "train_dataset.num_src_view=4", "train_dataset.img_hw=[480,640]",
            "train_dataset.n_rays=512", "train.epochs=1"]

    torch.cuda.reset_peak_memory_stats()
    k1.brick_counts()
    zero_counts()
    t0 = time.perf_counter()
    with spying(k1, "splat_bilinear", capture):
        runner = gens_main(argv)
    wall = time.perf_counter() - t0
    launches = launch_counts()["K1"]
    bricks = k1.brick_counts()
    assert launch_counts()["K2"] == 0
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
    assert len(captured) == per_step, len(captured)
    # the aggregation tells K1 that its queries are the voxel grid
    assert sorted(c["dim"] for c in captured) == sorted(
        5 * list(cfg.model.volume.volume_dims))
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
    prof = profile_step(lambda: runner.step_fn(inputs, 1.0,
                                               generator=runner.generator))
    # the profiler slows the host; the kernels' time against a plain step
    prof["device_share_of_later_steps"] = (
        prof["device_ms"] / float(np.mean(step_ms[1:])))
    print("train path: " + json.dumps({
        "wall_s": wall, "first_step_ms": step_ms[0],
        "later_steps_ms": step_ms[1:], "phase_ms": phase["phase_ms"],
        "profile": prof,
        "peak_mem_gb": peak_gb, "k1_launches": launches,
        "k1_launches_per_step": per_step,
        "k1_bricks_live_direct": list(bricks),
        "losses": {k: v for k, v in stats[-1].items()
                   if k not in ("epoch", "step", "step_s")}}), flush=True)
    return launches, captured, bricks


def profile_step(step) -> dict:
    """One step (``step()``) under torch.profiler: the device time summed
    over the kernels and copies it ran (device-side events only: an
    operator's own entry repeats the time of the kernels it launched), its
    share of the step's wall time under the profiler, and the kernels that
    take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
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


K1_MODES = (("float32", "fused_u"), ("bfloat16", "fused_u"),
            ("bfloat16", "per_channel"))


def k1_phase(captured, launches, path_bricks) -> dict:
    """K1 against its plain version on the 25 splats of one training step:
    at every scale of one view in all three roundings (timed beside the
    plain version at scale 0), and the path's rounding on all 25, timed,
    for the step's total; the footprint statistics of the scale-0 splat,
    the bricks that went straight to the image, the bound and
    ``grid_sampler_2d_backward`` at scale 0. Returns the kernels-line
    row."""
    from gens_torch.ops import splat as k1

    def on_card(c):
        return c["xy"].cuda(), c["ct"].cuda(), c["hw"], c["dim"]

    def check(xy, ct, hw, dim, mm, layout):
        got = k1.splat_bilinear(xy, ct, hw, mm, layout, dim)
        ref = k1.splat_plain(xy, ct, hw, mm, layout)
        torch.cuda.synchronize()
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        assert torch.isfinite(got).all()
        assert err <= K1_TOL * scale, (hw, mm, layout, err, scale)
        return err, scale

    path_mm = captured[0]["mm_dtype"]
    # one view: the first splat of each scale (the backward runs the last
    # view of the forward first)
    one_view = {}
    for c in captured:
        one_view.setdefault(c["dim"], c)
    per_scale, res = [], {}
    for dim in sorted(one_view, reverse=True):
        xy, ct, hw, _ = on_card(one_view[dim])
        entry = {"dim": dim, "hw": list(hw)}
        for mm, layout in K1_MODES:
            k1.brick_counts()
            err, scale = check(xy, ct, hw, dim, mm, layout)
            name = mm if layout == "fused_u" else f"{mm}_{layout}"
            entry[name] = {
                "max_abs_err": err, "max_abs_ref": scale,
                "bricks_live_direct": list(k1.brick_counts()),
                "ms": cuda_ms(lambda: k1.splat_bilinear(
                    xy, ct, hw, mm, layout, dim), 20)}
            if dim == max(one_view):
                entry[name]["plain_ms"] = cuda_ms(
                    lambda: k1.splat_plain(xy, ct, hw, mm, layout), 5)
                res[name] = entry[name]
        per_scale.append(entry)
        del xy, ct
    step_ms = 0.0
    for c in captured:
        xy, ct, hw, dim = on_card(c)
        check(xy, ct, hw, dim, path_mm, "fused_u")
        step_ms += cuda_ms(lambda: k1.splat_bilinear(
            xy, ct, hw, path_mm, "fused_u", dim), 10)
        del xy, ct

    xy, ct, hw, dim = on_card(one_view[max(one_view)])
    n, C = ct.shape
    H, W = hw
    footprint = k1_footprint(xy, ct, hw, dim, K1_TILE_PIXELS)
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
        "queries": n, "live": live, "hw": [H, W], "dim": dim,
        "path_mm_dtype": path_mm, "by_mm_dtype": res,
        "library_ms": library_ms,
        "library_max_abs_err_vs_plain_f32": lib_err,
        "bound_ms": max(t_bytes, t_ops), "bytes": n_bytes, "flop": flops,
        "step_ms_25_launches": step_ms,
        "path_bricks_live_direct": list(path_bricks)}), flush=True)
    print("K1 per scale, one view: " + json.dumps(per_scale), flush=True)
    print("K1 footprint, scale 0: " + json.dumps(footprint), flush=True)
    return {
        "name": "splat_bilinear", "route": "cuda",
        "source": "gens_torch/csrc/splat.cu",
        "replaces": "gens_tpu/ops/pallas_splat.py:59",
        "launches": launches, "max_abs_err": res[path_mm]["max_abs_err"],
        "ms": res[path_mm]["ms"], "plain_ms": res[path_mm]["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


# the sharing scopes whose merge ratios the K1 lines report: bricks of the
# voxel grid, (x, y, z) voxels (a warp's 32 z-consecutive queries apart);
# K1 takes 8 x 8 x 8 bricks, with a footprint tile of K1_TILE_PIXELS at C = 4
# (csrc/splat.cu: 32 KB of two int32 planes a channel)
K1_BRICKS = ((1, 16, 16), (4, 8, 16), (16, 16, 16), (8, 8, 8))
K1_TILE_PIXELS = 32 * 1024 // 32


def k1_footprint(xy, ct, hw, dim, tile_pixels) -> dict:
    """What sharing a pixel's atomics could merge on one view's splat: the
    live in-image corner-adds, the distinct pixels they hit, and for a
    warp's 32 z-consecutive queries and each brick of :data:`K1_BRICKS` the
    corner-adds per distinct (scope, pixel) pair; per brick shape the
    footprint's width and height in pixels (median, 90th, 99th percentile,
    max) and the share of live bricks whose box fits ``tile_pixels``."""
    H, W = hw
    n = xy.shape[0]
    x, y = xy[:, 0], xy[:, 1]
    ok = ((ct != 0).any(dim=1) & (x > -1) & (x < W) & (y > -1) & (y < H))
    q = torch.nonzero(ok)[:, 0]
    x0, y0 = torch.floor(x[q]).long(), torch.floor(y[q]).long()
    px, py, qq = [], [], []
    for dx in (0, 1):
        for dy in (0, 1):
            ix, iy = x0 + dx, y0 + dy
            v = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            px.append(ix[v])
            py.append(iy[v])
            qq.append(q[v])
    px, py, qq = torch.cat(px), torch.cat(py), torch.cat(qq)
    del x0, y0, q, ok
    pix = py * W + px
    adds = pix.numel()

    def merge(group):
        return adds / torch.unique(group * (H * W) + pix).numel()

    out = {"queries": n, "corner_adds": adds,
           "distinct_pixels": int(torch.unique(pix).numel()),
           "merge_warp32": merge(qq // 32), "bricks": {}}
    iz, iy_, ix_ = qq % dim, (qq // dim) % dim, qq // (dim * dim)
    for bx, by, bz in K1_BRICKS:
        nby, nbz = -(-dim // by), -(-dim // bz)
        g = ((ix_ // bx) * nby + iy_ // by) * nbz + iz // bz
        ng = int(g.max()) + 1
        lo = torch.full((ng,), W + H, device=g.device, dtype=torch.long)
        hi = torch.full((ng,), -1, device=g.device, dtype=torch.long)
        bw = (hi.scatter_reduce(0, g, px, "amax")
              - lo.scatter_reduce(0, g, px, "amin") + 1)
        bh = (hi.scatter_reduce(0, g, py, "amax")
              - lo.scatter_reduce(0, g, py, "amin") + 1)
        live = bw > 0
        bw, bh = bw[live].double(), bh[live].double()
        qs = torch.tensor([0.5, 0.9, 0.99], device=g.device,
                          dtype=torch.double)
        out["bricks"]["x".join(map(str, (bx, by, bz)))] = {
            "merge": merge(g), "live_bricks": int(live.sum()),
            "w_p50_p90_p99_max": torch.quantile(bw, qs).tolist()
            + [float(bw.max())],
            "h_p50_p90_p99_max": torch.quantile(bh, qs).tolist()
            + [float(bh.max())],
            "share_fitting_tile": float((bw * bh <= tile_pixels).double()
                                        .mean())}
    return out


def check_small_train(dev, raw=None, name="train step", setup=None,
                      modules=("feature", "sdf")) -> None:
    """One training step of a tiny seeded model on the GPU (K1 in the
    aggregation backward) and on the CPU (its plain version), same batch and
    draws: the loss and the gradients of ``modules`` agree. The batch is
    ``raw`` (a dataset item), else a synthetic scene's; ``setup(model_cfg)``
    switches options on."""
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
    if setup is not None:
        setup(m)
    torch.manual_seed(0)
    models = {"cpu": GenSModel(m)}
    models["gpu"] = GenSModel(m).to(dev)
    models["gpu"].load_state_dict(models["cpu"].state_dict())
    if raw is None:
        raw = SyntheticDataset(1, 3, (64, 64), n_rays=64, n_pseudo_pts=64,
                               mode="train")[0]
    sparse = torch.rand((64, 3), generator=torch.Generator().manual_seed(1))
    loss, grads = {}, {}
    for side, d in (("cpu", "cpu"), ("gpu", dev)):
        inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(d)
                  for k, v in raw.items()
                  if isinstance(v, np.ndarray) and v.dtype == np.float32}
        step = TrainStep(models[side], cfg, 1)
        out = step(inputs, 0.5, sparse_pts=sparse * 2 - 1)
        loss[side] = float(out["loss"])
        grads[side] = {k: p.grad.detach().cpu()
                       for k, p in models[side].named_parameters()
                       if p.grad is not None}
    rel = abs(loss["gpu"] - loss["cpu"]) / abs(loss["cpu"])
    errs = {}
    for top in modules:
        keys = [k for k in grads["cpu"] if k.split(".")[0] == top]
        a = torch.cat([grads["cpu"][k].reshape(-1) for k in keys])
        b = torch.cat([grads["gpu"][k].reshape(-1) for k in keys])
        errs[top] = float((a - b).norm() / a.norm())
    print(f"{name} GPU vs CPU port: " + json.dumps({
        "loss": loss, "loss_rel_err": rel, "grad_rel_err": errs}),
        flush=True)
    assert rel <= TRAIN_LOSS_RTOL, rel
    assert all(e <= TRAIN_GRAD_TOL for e in errs.values()), errs


def finetune_path(gens_main, dev):
    """``gens_main --mode finetune`` at the DTU finetune shape with the K2
    volume build; returns K2's launches in that run, the scale-0 (image,
    xy, mm_dtype) of one view, the runner and the volume build's (intrs,
    c2ws)."""
    from gens_torch.convert import (load_checkpoint, load_params,
                                    params_from_jax)
    from gens_torch.mesh.extract import eval_sdf_grid, grid_to_mesh
    from gens_torch.models.gens import GenSModel
    from gens_torch.ops import fused_mlp as fm
    from gens_torch.ops import splat as k1
    from gens_torch.train.checkpoint import load_finetune_checkpoint

    captured, build = {}, {}

    def capture(image, xy, mm_dtype):
        if tuple(image.shape[:2]) == (1152, 1600) and not captured:
            captured.update(image=image.detach().clone(), xy=xy.clone(),
                            mm_dtype=mm_dtype)

    init_volumes = GenSModel.init_volumes

    def counted_init_volumes(self, imgs, intrs, c2ws):
        n0 = launch_counts()["K2"]
        out = init_volumes(self, imgs, intrs, c2ws)
        build.update(k2=launch_counts()["K2"] - n0,
                     volumes=[v.clone() for v in out[0]], intrs=intrs,
                     c2ws=c2ws)
        return out

    artifact = os.path.join(REPO, "artifacts", "quality_gen_r05_sharpen.pkl")
    exp = os.path.join(REPO, "build", "chip_smoke_ft")
    argv = ["--conf", os.path.join(REPO, "confs", "dtu_finetune.yaml"),
            "--mode", "finetune", "--resume", artifact,
            "--set", f"base_exp_dir={exp}",
            "finetune_dataset.dataset_name=synthetic",
            "finetune_dataset.num_src_view=2",
            "finetune_dataset.img_hw=[1152,1600]",
            "finetune_dataset.n_rays=512", "finetune_dataset.val_res_level=4",
            "mesh_resolution=512", "train.epochs=6",
            "model.volume.packed_bilerp=pallas",
            "model.volume.splat_impl=kernel2f"]
    GenSModel.init_volumes = counted_init_volumes
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with spying(k1, "bilerp_window_fwd", capture):
        runner = gens_main(argv)
    wall = time.perf_counter() - t0
    launches = launch_counts()["K2"]
    k3_launches = launch_counts()["K3"]
    k4_launches = launch_counts()["K4"]
    k1_launches = launch_counts()["K1"]
    k5_launches = launch_counts()["K5"]
    GenSModel.init_volumes = init_volumes
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    cfg = runner.cfg
    rc = cfg.model.render
    dims = tuple(cfg.model.volume.volume_dims)
    assert dims == (256, 128, 64, 32, 16), dims
    assert cfg.model.sdf_network.d_hidden == 128
    assert (rc.n_samples, rc.n_importance, rc.up_sample_steps) == (64, 64, 4)
    assert tuple(cfg.finetune_dataset.img_hw) == (1152, 1600)
    n_views = cfg.finetune_dataset.num_src_view + 1
    assert launches == len(dims) * n_views == 15, launches
    assert build["k2"] == launches, build["k2"]  # all in the volume build
    assert k3_launches == k4_launches == (512 // 64) ** 3, (k3_launches,
                                                            k4_launches)
    assert k1_launches == 0, k1_launches
    assert k5_launches == 1, k5_launches  # the validation's mesh
    assert captured, "no scale-0 K2 input was captured"
    steps = [st for st in runner.finetune_stats if "loss" in st]
    (val,) = [st for st in runner.finetune_stats if "val_step" in st]
    assert len(steps) == 6 and sorted(st["vid"] for st in steps) == [
        0, 0, 1, 1, 2, 2], steps
    for st in steps:
        bad = [k for k, v in st.items() if not np.isfinite(v)]
        assert not bad, (st["step"], bad)
    assert val["grid_finite"] and val["render_finite"]
    assert val["rays"] == 288 * 400, val["rays"]
    # The validation's mesh is held to the plain MLP on the finetuned state.
    # Whether that state still has a surface is not asserted: the first
    # Adam steps shift the whole SDF, and the run-to-run float differences
    # (atomics in the backward) grow into different shifts, so after 6
    # steps the surface's size varies widely from run to run and can vanish
    # (an empty mesh, which the JAX runner also allows). The state the
    # finetune starts from (the run's K2-built volumes, the artifact's MLP)
    # is the same in every run up to rounding: its mesh, through the same
    # K3 grid and isosurface, must have a surface.
    grid = runner.last_sdf_grid
    assert cfg.mesh_resolution == 512 and grid.shape == (512,) * 3
    slab_err = k3_slab_err(runner.model.sdf, runner.last_scene.volumes,
                           grid, dev)
    assert slab_err <= SLAB_TOL, slab_err
    start = GenSModel(cfg.model)
    load_params(start, artifact)
    start_sdf = start.sdf.to(dev)
    with torch.no_grad():
        start_grid = eval_sdf_grid(
            fm.sdf_fused_fn(start_sdf, build["volumes"]), [-1, -1, -1],
            [1, 1, 1], cfg.mesh_resolution, dev)
    _, start_tris = grid_to_mesh(start_grid, [-1, -1, -1], [1, 1, 1])
    assert len(start_tris) > 0, "empty mesh at the finetune's start"
    surface = {"n_tris": val["n_tris"], "outside_margin": float(-grid.min()),
               "slab_max_abs_err": slab_err, "start_n_tris": len(start_tris),
               "start_outside_margin": float(-start_grid.min())}
    del start, start_sdf, start_grid, start_tris

    # every trained tensor moved from where the run started
    step = runner.ft_step
    for i, (a, b) in enumerate(zip(step.volumes, build["volumes"])):
        assert float((a.detach() - b).abs().max()) > 0, f"volume {i}"
    init = params_from_jax(load_checkpoint(artifact)["params"])
    state = {k: v.detach().cpu() for k, v in runner.model.state_dict().items()}
    for top in ("sdf", "blending", "variance"):
        moved = max(float((state[k] - v).abs().max())
                    for k, v in init.items() if k.split(".")[0] == top)
        assert moved > 0, f"{top} did not move"
    # the finetune checkpoint reads back equal
    ckpt = os.path.join(runner.exp_dir, "checkpoints", "model_005.ckpt")
    fresh = GenSModel(cfg.model)
    _, arrays = load_finetune_checkpoint(fresh, ckpt)
    for k, src in (("volumes", step.volumes),
                   ("mask_volumes", step.mask_volumes),
                   ("features", step.features)):
        for a, b in zip(arrays[k], src):
            assert torch.equal(a, b.detach().float().cpu()), k
    for k, v in fresh.state_dict().items():
        if k.split(".")[0] in ("sdf", "blending", "variance"):
            assert torch.equal(v, state[k]), k

    # one more step, timed by phase
    from gens_torch.runner import get_dataset

    ds = get_dataset(cfg.finetune_dataset, "finetune")
    raw = ds.get_random_rays(1)
    inputs = runner._tensors(raw)
    inputs["view_ids"] = torch.from_numpy(raw["view_ids"]).to(dev)
    phase = step(inputs, 1.0, generator=runner.generator, timing=True)
    step_ms = [st["step_s"] * 1e3 for st in steps]
    prof = profile_step(lambda: step(inputs, 1.0, generator=runner.generator))
    prof["device_share_of_later_steps"] = (
        prof["device_ms"] / float(np.mean(step_ms[1:])))
    print("finetune path: " + json.dumps({
        "wall_s": wall, "init_volumes_ms": runner.init_volumes_s * 1e3,
        "first_step_ms": step_ms[0], "later_steps_ms": step_ms[1:],
        "phase_ms": phase["phase_ms"], "profile": prof,
        "val_mesh_grid_s": val["mesh_grid_s"],
        "val_isosurface_s": val["isosurface_s"], "val_render_s": val["render_s"],
        "val_rays": val["rays"], "val_rays_per_s": val["rays_per_s"],
        "val_psnr": val["psnr"], "surface": surface,
        "peak_mem_gb": peak_gb, "k2_launches": launches,
        "k2_launches_in_build": build["k2"], "k3_launches": k3_launches,
        "losses": {k: v for k, v in steps[-1].items()
                   if k not in ("step", "vid", "step_s")}}), flush=True)
    return launches, captured, runner, (build["intrs"], build["c2ws"])


def k2_phase(captured, launches) -> dict:
    """K2 against its plain version on the captured scale-0 inputs, both
    operand dtypes; times, the bound and ``F.grid_sample``. Returns the
    kernels-line row."""
    import torch.nn.functional as F

    from gens_torch.ops import window_fwd as k2

    image, xy = captured["image"], captured["xy"]
    path_dtype = captured["mm_dtype"]
    H, W, C = image.shape
    n = xy.shape[0]
    res = {}
    for mm in ("float32", "bfloat16"):
        img = image.to(torch.bfloat16 if mm == "bfloat16" else torch.float32
                       ).contiguous()
        got = k2.bilerp_window_fwd(img, xy, mm)
        ref = k2.window_fwd_plain(img, xy, mm)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        assert torch.isfinite(got).all()
        assert err <= K2_TOL * scale, (mm, err, scale)
        res[mm] = {"max_abs_err": err, "max_abs_ref": scale,
                   "ms": cuda_ms(lambda: k2.bilerp_window_fwd(img, xy, mm),
                                 20),
                   "plain_ms": cuda_ms(lambda: k2.window_fwd_plain(img, xy,
                                                                   mm), 5)}
        del got, ref
    # yardstick: F.grid_sample of the f32 map (bilinear, zeros padding,
    # align_corners) at the same queries; non-finite ones moved outside
    inp = image.float().permute(2, 0, 1).unsqueeze(0).contiguous()
    grid = torch.stack([xy[:, 0] / (W - 1) * 2 - 1,
                        xy[:, 1] / (H - 1) * 2 - 1], -1)
    grid = torch.nan_to_num(grid, nan=-3.0, posinf=-3.0, neginf=-3.0)
    grid = grid.clamp(-3.0, 3.0).view(1, 1, n, 2)

    def library():
        return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    lib_err = float((library()[0, :, 0].t() - k2.window_fwd_plain(
        image, xy, "float32")).abs().max())
    library_ms = cuda_ms(library, 10)
    live = int(((xy[:, 0] > -1) & (xy[:, 0] < W) & (xy[:, 1] > -1)
                & (xy[:, 1] < H)).sum())
    elem = 2 if path_dtype == "bfloat16" else 4
    # each input read once (xy, the map), the output written once; per
    # in-image query 12 operations for the corner weights and 9 per channel
    n_bytes = 8 * n + 4 * C * n + elem * H * W * C
    flops = (12 + 9 * C) * live
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    print("K2 scale 0, one view: " + json.dumps({
        "queries": n, "in_image": live, "hw": [H, W], "channels": C,
        "path_mm_dtype": path_dtype, "by_mm_dtype": res,
        "library_ms": library_ms,
        "library_max_abs_err_vs_plain_f32": lib_err,
        "bound_ms": max(t_bytes, t_ops), "bytes": n_bytes, "flop": flops}),
        flush=True)
    return {
        "name": "bilerp_window_fwd", "route": "cuda",
        "source": "gens_torch/csrc/window_fwd.cu",
        "replaces": "gens_tpu/ops/pallas_splat.py:164",
        "launches": launches, "max_abs_err": res[path_dtype]["max_abs_err"],
        "ms": res[path_dtype]["ms"], "plain_ms": res[path_dtype]["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


def check_agg_kernel2f(runner, intrs, c2ws) -> None:
    """The raw volumes of the finetune run's features under "kernel2f" (K2)
    and under "auto" (the bf16 gather forward), on the card: per scale, the
    mean channels within 2^-9 A and the variance channels within 4 * 2^-9
    A² (A = max |feature|); the largest difference is also reported as a
    share of max |raw|."""
    from gens_torch.models.volume import (aggregate_scale, splat_dtype,
                                          splat_impl_at)

    vc = runner.cfg.model.volume
    feats = runner.ft_step.features
    errs = []
    with torch.no_grad():
        for i, dim in enumerate(vc.volume_dims):
            raw = {impl: aggregate_scale(
                feats[i], intrs, c2ws, dim, i, min_vis_view=vc.min_vis_view,
                splat_mm_dtype=splat_dtype("pallas", dim, vc.splat_mm_dtype),
                splat_impl=splat_impl_at("pallas", dim, impl))[0]
                for impl in ("kernel2f", "auto")}
            C = feats[i].shape[-1]
            a = float(feats[i].abs().max())
            diff = (raw["kernel2f"] - raw["auto"]).abs()
            err_mean = float(diff[..., :C].max())
            err_var = float(diff[..., C:].max())
            scale = float(raw["auto"].abs().max())
            errs.append({"dim": dim, "max_abs_diff_mean": err_mean,
                         "max_abs_diff_var": err_var, "max_abs_feature": a,
                         "max_abs_raw": scale,
                         "max_diff_over_max_raw": max(err_mean, err_var)
                         / scale})
            assert err_mean <= 1.01 * AGG_EPS * a, errs[-1]
            assert err_var <= 1.01 * 4 * AGG_EPS * a * a, errs[-1]
            del raw, diff
    print("raw volumes, kernel2f vs gather forward: " + json.dumps(errs),
          flush=True)


def check_small_finetune(dev) -> None:
    """One finetune step of a tiny seeded model under "kernel2f" on the
    GPU (K2 in the volume build) and on the CPU (its plain version), same
    batch and draws: the loss and the volume and SDF gradients agree."""
    from gens_torch.config import Config
    from gens_torch.data.synthetic import SyntheticDataset
    from gens_torch.models.gens import GenSModel
    from gens_torch.train.step import FinetuneStep

    cfg = Config()
    m = cfg.model
    m.feature_network.d_enc = (8, 8, 8, 8, 8)
    m.volume.volume_dims = (32, 16, 8, 4, 2)
    m.volume.packed_bilerp, m.volume.splat_impl = "pallas", "kernel2f"
    m.volume.splat_mm_dtype = "float32"
    m.render.n_samples, m.render.n_importance = 16, 16
    m.render.up_sample_steps, m.render.perturb = 2, 0.0
    m.render.patch_size, m.render.n_sparse_pts = 5, 64
    torch.manual_seed(0)
    models = {"cpu": GenSModel(m)}
    models["gpu"] = GenSModel(m).to(dev)
    models["gpu"].load_state_dict(models["cpu"].state_dict())
    ds = SyntheticDataset(1, 3, (64, 64), n_rays=64, mode="finetune")
    images = ds.get_all_images()
    raw = ds.get_random_rays(1)
    sparse = torch.rand((64, 3), generator=torch.Generator().manual_seed(1))
    loss, grads = {}, {}
    for name, d in (("cpu", "cpu"), ("gpu", dev)):
        def tensors(r):
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(d)
                    for k, v in r.items()
                    if isinstance(v, np.ndarray) and v.dtype == np.float32}
        im = tensors(images)
        built = models[name].init_volumes(im["imgs"], im["intrs"],
                                          im["c2ws"])
        step = FinetuneStep(models[name], cfg, *built)
        inputs = tensors(raw)
        inputs["view_ids"] = torch.from_numpy(raw["view_ids"]).to(d)
        out = step(inputs, 0.5, sparse_pts=sparse * 2 - 1)
        loss[name] = float(out["loss"])
        grads[name] = {
            "volumes": torch.cat([v.grad.reshape(-1).cpu()
                                  for v in step.volumes]),
            "sdf": torch.cat([p.grad.reshape(-1).cpu()
                              for p in models[name].sdf.parameters()])}
    rel = abs(loss["gpu"] - loss["cpu"]) / abs(loss["cpu"])
    errs = {k: float((grads["cpu"][k] - grads["gpu"][k]).norm()
                     / grads["cpu"][k].norm()) for k in grads["cpu"]}
    print("finetune step GPU vs CPU port: " + json.dumps({
        "loss": loss, "loss_rel_err": rel, "grad_rel_err": errs}),
        flush=True)
    assert rel <= TRAIN_LOSS_RTOL, rel
    assert all(e <= TRAIN_GRAD_TOL for e in errs.values()), errs


def quality_path() -> dict:
    """``gens_torch.eval.quality`` on the trained artifact, held-out sphere
    only, at the protocol's size; K3 launches 27 times (a 192³ grid in 64³
    blocks) and nothing else; accuracy and PSNR against the JAX record.
    Returns the result."""
    from gens_torch.eval import quality

    artifact = os.path.join(REPO, "artifacts", "quality_gen_r05_sharpen.pkl")
    with open(os.path.join(REPO, QUALITY_RECORD)) as f:
        record = json.load(f)
    out = os.path.join(REPO, "build", "chip_smoke_quality.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    zero_counts()
    t0 = time.perf_counter()
    res = quality.main(["--ckpt", artifact, "--scenes", "heldout",
                        "--out", out])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    assert counts == {**{k: 0 for k in counts},
                      **grid_kernels((192 // 64) ** 3)}, counts
    cfg = res["config"]
    assert cfg["hw"] == [480, 640] and cfg["mesh_res"] == 192
    assert cfg["volume_dims"] == record["config"]["volume_dims"]
    keys = ("acc_mean", "acc_p50", "acc_p90", "comp_mean", "overall", "psnr",
            "verts_raw", "verts_clean", "verts_bbox", "verts_scored")
    print("quality path: " + json.dumps({
        "wall_s": wall, "k3_launches": counts["K3"],
        "params_stored_dtype": res["params_stored_dtype"],
        "port": {k: res[f"heldout_{k}"] for k in keys},
        "jax_record": {k: record[f"heldout_{k}"] for k in keys},
        "seconds": {k: res[f"heldout_{k}_s"] for k in (
            "build_scene", "render", "mesh_grid", "isosurface",
            "clean_and_score")},
        "rays_per_s": res["heldout_rays_per_s"]}), flush=True)
    acc, ref_acc = res["heldout_acc_mean"], record["heldout_acc_mean"]
    psnr, ref_psnr = res["heldout_psnr"], record["heldout_psnr"]
    if abs(acc - ref_acc) > QUALITY_ACC_RTOL * ref_acc:
        raise AssertionError(f"held-out acc {acc} is not within "
                             f"{QUALITY_ACC_RTOL:.0%} of {ref_acc}")
    if abs(psnr - ref_psnr) > QUALITY_PSNR_ATOL:
        raise AssertionError(f"held-out PSNR {psnr} is not within "
                             f"{QUALITY_PSNR_ATOL} dB of {ref_psnr}")
    return res


ORBAX_FIXTURE = os.path.join(REPO, "artifacts",
                             "quality_gen_r05_sharpen.orbax")


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_leaves(v, path + (k,)))
        return out
    return {path: tree}


def _finetune_build(gens_main, ckpt: str, exp: str):
    """``gens_main --mode finetune`` from ``ckpt`` with 0 steps: the volume
    build alone at the DTU finetune shape under ``kernel2f``; returns (the
    built volumes, masks and features, the build's seconds, K2's
    launches)."""
    argv = ["--conf", os.path.join(REPO, "confs", "dtu_finetune.yaml"),
            "--mode", "finetune", "--resume", ckpt,
            "--set", f"base_exp_dir={exp}",
            "finetune_dataset.dataset_name=synthetic",
            "finetune_dataset.num_src_view=2",
            "finetune_dataset.img_hw=[1152,1600]", "train.epochs=0",
            "model.volume.packed_bilerp=pallas",
            "model.volume.splat_impl=kernel2f"]
    zero_counts()
    runner = gens_main(argv)
    counts = launch_counts()
    assert counts == {**{k: 0 for k in counts}, "K2": 5 * 3}, counts
    step = runner.ft_step
    return ([t.detach().clone() for t in step.volumes],
            [t.detach().clone() for t in step.mask_volumes],
            [t.detach().clone() for t in step.features]), \
        runner.init_volumes_s, counts["K2"]


def orbax_path(gens_main, card: str) -> None:
    """The trained artifact's params from gens_tpu's default checkpoint
    format, artifacts/quality_gen_r05_sharpen.orbax: read through the
    port bit-equal to the pickle; the held-out quality evaluation (K3 27)
    and the finetune's volume build (K2 15) from it equal to the same runs
    from the pickle. Both runs of a pair use cuDNN's deterministic
    convolutions: by default cuDNN may choose a nondeterministic algorithm,
    and two runs on the same params differ (the feature net's outputs by
    ~4e-6, the bf16 volumes by up to 0.5, the held-out accuracy in its
    third digit)."""
    import importlib.util

    from gens_torch.convert import load_checkpoint
    from gens_torch.eval import quality

    phase_t0 = time.perf_counter()
    artifact = os.path.join(REPO, "artifacts", "quality_gen_r05_sharpen.pkl")
    absent = [m for m in ("orbax", "tensorstore", "zstandard")
              if importlib.util.find_spec(m) is None]
    dir_bytes = sum(os.path.getsize(os.path.join(d, f))
                    for d, _, files in os.walk(ORBAX_FIXTURE) for f in files)
    t0 = time.perf_counter()
    payload = load_checkpoint(ORBAX_FIXTURE)
    read_s = time.perf_counter() - t0
    got = _tree_leaves(payload)
    want = _tree_leaves(load_checkpoint(artifact))
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for path, leaf in want.items():
        a, b = np.asarray(got[path]), np.asarray(leaf)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    param_bytes = sum(np.asarray(v).nbytes for k, v in got.items()
                      if k[0] == "params")
    dtypes = sorted({str(np.asarray(v).dtype) for k, v in got.items()
                     if k[0] == "params"})

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res, quality_s = {}, {}
        for name, ckpt in (("pickle", artifact), ("orbax", ORBAX_FIXTURE)):
            out = os.path.join(REPO, "build",
                               f"chip_smoke_quality_{name}.json")
            zero_counts()
            t0 = time.perf_counter()
            res[name] = quality.main(["--ckpt", ckpt, "--scenes", "heldout",
                                      "--out", out])
            quality_s[name] = time.perf_counter() - t0
            counts = launch_counts()
            assert counts == {**{k: 0 for k in counts},
                              **grid_kernels((192 // 64) ** 3)}, counts
        ref = res["pickle"]
        scores = [k for k, v in ref.items() if k.startswith("heldout_")
                  and not k.endswith(("_s", "rays_per_s"))
                  and isinstance(v, (int, float))]
        assert scores and res["orbax"]["params_stored_dtype"] == \
            ref["params_stored_dtype"]
        differ = {k: (res["orbax"][k], ref[k]) for k in scores
                  if not np.array_equal(res["orbax"][k], ref[k],
                                        equal_nan=True)}
        assert not differ, differ
        quality_diff = max((float(abs(res["orbax"][k] - ref[k]))
                            for k in scores if np.isfinite(ref[k])),
                           default=0.0)

        exp = os.path.join(REPO, "build", "chip_smoke_orbax_ft")
        from_orbax, orbax_build_s, k2_launches = _finetune_build(
            gens_main, ORBAX_FIXTURE, exp + "_orbax")
        from_pickle, pickle_build_s, _ = _finetune_build(
            gens_main, artifact, exp + "_pickle")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    build_diff = 0.0
    for xs, ys in zip(from_orbax, from_pickle):
        assert len(xs) == len(ys) > 0
        for x, y in zip(xs, ys):
            assert x.shape == y.shape and x.dtype == y.dtype
            build_diff = max(build_diff, float((x - y).abs().max()))
    assert build_diff == 0.0, build_diff
    print("orbax path: " + json.dumps({
        "card": card, "wall_s": time.perf_counter() - phase_t0,
        "absent": absent, "dir_bytes": dir_bytes,
        "read_s": read_s, "read_mb_per_s": dir_bytes / read_s / 1e6,
        "params_mb_per_s": param_bytes / read_s / 1e6,
        "leaves": len(got), "bit_equal": True, "params_dtypes": dtypes,
        "quality_s": quality_s, "k3_launches": counts["K3"],
        "quality_scores": len(scores), "quality_max_diff": quality_diff,
        "heldout_acc_mean": res["orbax"]["heldout_acc_mean"],
        "heldout_psnr": res["orbax"]["heldout_psnr"],
        "ft_build_k2_launches": k2_launches,
        "ft_build_max_diff": build_diff,
        "ft_init_volumes_s": {"orbax": orbax_build_s,
                              "pickle": pickle_build_s}}), flush=True)


QUALITY_TRAIN_STEPS = 50
QUALITY_TRAIN_DIR = os.path.join(REPO, "build", "chip_smoke_quality_train")
# phase a over 50 steps: the step-25 row's PSNR above the first row's by
# at least this (the JAX record's 1,500-step run: 19.3 -> 34.6 dB by step 25)
QUALITY_TRAIN_RISE_DB = 5.0


def quality_train_path() -> None:
    """``gens_torch.eval.quality_train --phase a`` in the r05 stage-2
    configuration (``--agg-packed pallas --bf16``: 5 views at 128x128, 512
    rays, a 64³…4³ cascade, 32+32 samples) for 50 steps from a seeded init,
    then its evaluation (3 views, a 192³ mesh). K1 launches 25 times a step
    (5 scales x 5 views: in the bf16 rounding at 64, 32 and 16, where the
    JAX Pallas splat runs, and as the exact f32 adjoint at 8 and 4, where
    the JAX function falls back to the table's adjoint) and K3 27 times at
    the evaluation, nothing else; every curve row finite; the step-25 row's
    PSNR 5 dB or more above the first row's."""
    from gens_torch.convert import load_params
    from gens_torch.eval import quality_train
    from gens_torch.eval.quality import scene_params
    from gens_torch.models.gens import GenSModel
    from gens_torch.ops import splat as k1
    from gens_torch.train.step import TrainStep

    shutil.rmtree(QUALITY_TRAIN_DIR, ignore_errors=True)
    out = os.path.join(QUALITY_TRAIN_DIR, "quality_a_pallas.json")
    ckpt = os.path.join(QUALITY_TRAIN_DIR, "overfit.ckpt")
    flags = ["--phase", "a", "--steps-a", str(QUALITY_TRAIN_STEPS),
             "--agg-packed", "pallas", "--bf16"]
    k1_step = 5 * 5
    # the 25 splats of the first step, copied to the host
    captured = []

    def capture(xy, ct, hw, mm_dtype, layout, dim):
        if len(captured) < k1_step:
            captured.append((xy.cpu(), ct.cpu(), hw, mm_dtype, dim))

    zero_counts()
    t0 = time.perf_counter()
    with spying(k1, "splat_bilinear", capture):
        res = quality_train.main(flags + [
            "--out", out, "--runs-dir", QUALITY_TRAIN_DIR,
            "--ckpt-out", ckpt])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    assert counts == {**{k: 0 for k in counts},
                      "K1": k1_step * QUALITY_TRAIN_STEPS,
                      **grid_kernels((192 // 64) ** 3)}, counts
    assert res["overfit_k1_launches_per_step"] == k1_step, res
    assert res["overfit_k3_launches_eval"] == (192 // 64) ** 3, res
    curve = res["overfit_curve"]
    assert [r["step"] for r in curve] == [0, 25, 49], curve
    bad = [(r["step"], k) for r in curve for k, v in r.items()
           if not np.isfinite(v)]
    assert not bad, bad
    rise = curve[1]["psnr"] - curve[0]["psnr"]
    assert np.isfinite(res["overfit_psnr"]), res["overfit_psnr"]

    # K1 against its plain version on the step's 25 splats; their total
    assert sorted((c[4], c[3]) for c in captured) == sorted(
        [(d, "bfloat16" if d >= 16 else "float32")
         for d in (64, 32, 16, 8, 4)] * 5), [(c[4], c[3]) for c in captured]
    k1_ms, k1_err = 0.0, 0.0
    for xy, ct, hw, mm, dim in captured:
        xy, ct = xy.cuda(), ct.cuda()
        got = k1.splat_bilinear(xy, ct, hw, mm, "fused_u", dim)
        ref = k1.splat_plain(xy, ct, hw, mm, "fused_u")
        err = float((got - ref).abs().max())
        assert err <= K1_TOL * float(ref.abs().max()), (hw, dim, err)
        k1_err = max(k1_err, err)
        k1_ms += cuda_ms(lambda: k1.splat_bilinear(xy, ct, hw, mm,
                                                   "fused_u", dim), 20)
    # one more step of the trained model, under the profiler
    cfg = quality_train.build_cfg(quality_train.parse_args(flags),
                                  QUALITY_TRAIN_STEPS)
    model = GenSModel(cfg.model).cuda()
    load_params(model, ckpt)
    batches, _ = quality_train.pregen_batches(
        scene_params(0), 1, False, 0, (128, 128), 512, 5, 0.5,
        torch.device("cuda"))
    step = TrainStep(model, cfg, steps_per_epoch=1)

    def one_step():
        step(batches[0], 1.0, generator=torch.Generator().manual_seed(0))

    one_step()
    prof = profile_step(one_step)
    del model, step, batches
    first_step = check_phase_a_step()
    print("quality train path: " + json.dumps({
        "wall_s": wall, "steps": QUALITY_TRAIN_STEPS,
        "ms_per_step": res["overfit_ms_per_step"],
        "first_step_s": res["overfit_compile_s"],
        "train_peak_mem_gb": res["overfit_train_peak_mem_gb"],
        "k1_per_step": res["overfit_k1_launches_per_step"],
        "k3_eval": res["overfit_k3_launches_eval"],
        "psnr_rows": [r["psnr"] for r in curve],
        "eikonal_rows": [r["eikonal_loss"] for r in curve],
        "psnr_rise_0_25_db": rise,
        "k1_ms_per_step": k1_ms, "k1_max_abs_err": k1_err,
        "k1_dims": sorted({c[4] for c in captured}, reverse=True),
        "profile": prof, "first_step_gpu_vs_cpu": first_step,
        # acc_* is absent where cleaning left no vertex: 50 steps from a
        # seeded init give a surface that varies widely from run to run
        "eval": {k: res.get(f"overfit_{k}") for k in (
            "psnr", "acc_mean", "acc_p50", "verts_raw", "verts_clean",
            "render_s", "mesh_grid_s")}}),
        flush=True)
    assert rise >= QUALITY_TRAIN_RISE_DB, (
        f"PSNR rose {rise:.2f} dB from step 0 to 25, under "
        f"{QUALITY_TRAIN_RISE_DB} dB")


QUALITY_GEN_STEPS = 50
QUALITY_FT_STEPS = 30
# ft_init against the quality phase's held-out score: one process builds
# the same scene's volumes from the same 3 views and the same params, and
# a process repeats its render bit for bit
QUALITY_FT_INIT_RTOL = 5e-3


def finite_rows(curve) -> None:
    bad = [(r["step"], k) for r in curve for k, v in r.items()
           if not np.isfinite(v)]
    assert not bad, bad


def quality_gen_path() -> None:
    """``gens_torch.eval.quality_train --phase b`` at phase a's widths under
    ``--agg-packed pallas --bf16`` on two scenes' pseudo-labelled batches,
    50 steps from a seeded init, no evaluation: K1 25 times a step and
    nothing else; every curve row finite."""
    from gens_torch.eval import quality_train

    out = os.path.join(QUALITY_TRAIN_DIR, "quality_b.json")
    flags = ["--phase", "b", "--steps-b", str(QUALITY_GEN_STEPS),
             "--n-train-scenes", "2", "--agg-packed", "pallas", "--bf16",
             "--skip-eval"]
    zero_counts()
    t0 = time.perf_counter()
    res = quality_train.main(flags + [
        "--out", out, "--runs-dir", QUALITY_TRAIN_DIR,
        "--ckpt-out", os.path.join(QUALITY_TRAIN_DIR, "gen.ckpt")])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    assert counts == {**{k: 0 for k in counts},
                      "K1": 25 * QUALITY_GEN_STEPS}, counts
    assert res["gen_k1_launches_per_step"] == 25, res
    assert res["gen_steps_done"] == QUALITY_GEN_STEPS, res
    curve = res["gen_curve"]
    assert [r["step"] for r in curve] == [0, 25, 49], curve
    finite_rows(curve)
    # one more step of the trained model, under the profiler
    from gens_torch.convert import load_params
    from gens_torch.models.gens import GenSModel
    from gens_torch.train.step import TrainStep

    args = quality_train.parse_args(flags)
    cfg = quality_train.gen_cfg(args)
    model = GenSModel(cfg.model).cuda()
    load_params(model, os.path.join(QUALITY_TRAIN_DIR, "gen.ckpt"))
    batch = quality_train.gen_batches(args, torch.device("cuda"))[0]
    step = TrainStep(model, cfg, steps_per_epoch=1)

    def one_step():
        step(batch, 1.0, generator=torch.Generator().manual_seed(0))

    one_step()
    prof = profile_step(one_step)
    del model, step, batch
    print("quality b path: " + json.dumps({
        "wall_s": wall, "steps": QUALITY_GEN_STEPS,
        "ms_per_step": res["gen_ms_per_step"],
        "first_step_s": res["gen_compile_s"],
        "train_peak_mem_gb": res["gen_train_peak_mem_gb"],
        "k1_per_step": res["gen_k1_launches_per_step"],
        "psnr_rows": [r["psnr"] for r in curve],
        "eikonal_rows": [r["eikonal_loss"] for r in curve],
        "loss_rows": [r["loss"] for r in curve], "profile": prof}),
        flush=True)


def quality_ft_path(heldout: dict) -> None:
    """``gens_torch.eval.quality_train --phase ft`` from the trained
    artifact at the r05 width for 30 steps: K3 54 times (ft_init's and
    ft's 192³ meshes) and nothing else, every curve row finite, ft_init's
    accuracy within QUALITY_FT_INIT_RTOL of ``heldout`` (the quality
    phase's score of the same artifact)."""
    from gens_torch.eval import quality_train

    artifact = os.path.join(REPO, "artifacts", "quality_gen_r05_sharpen.pkl")
    out = os.path.join(QUALITY_TRAIN_DIR, "quality_ft.json")
    flags = ["--phase", "ft", "--gen-ckpt", artifact,
             "--steps-ft", str(QUALITY_FT_STEPS), "--dims", "128", "--hw",
             "480", "--w", "640", "--samples", "64", "--rays", "512",
             "--agg-packed", "pallas", "--bf16", "--agg-remat",
             "save_gathers", "--mesh-res", "192"]
    zero_counts()
    t0 = time.perf_counter()
    res = quality_train.main(flags + [
        "--out", out, "--runs-dir", QUALITY_TRAIN_DIR,
        "--ckpt-out", os.path.join(QUALITY_TRAIN_DIR, "ft.ckpt")])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    k3 = 2 * (192 // 64) ** 3
    assert counts == {**{k: 0 for k in counts}, **grid_kernels(k3, 2)}, counts
    assert res["ft_k3_launches"] == k3, res
    curve = res["ft_curve"]
    assert [r["step"] for r in curve] == [0, QUALITY_FT_STEPS - 1], curve
    finite_rows(curve)
    acc, ref = res["ft_init_acc_mean"], heldout["heldout_acc_mean"]
    keys = ("acc_mean", "acc_p50", "comp_mean", "overall", "verts_scored")
    # one finetune step from the artifact, under the profiler
    from gens_torch.convert import load_params
    from gens_torch.data.synthetic import make_scene
    from gens_torch.eval import quality_finetune
    from gens_torch.eval.quality import scene_params
    from gens_torch.models.gens import GenSModel
    from gens_torch.train.step import FinetuneStep

    args = quality_train.parse_args(flags)
    cfg = quality_finetune.ft_cfg(args)
    model = GenSModel(cfg.model)
    load_params(model, artifact)
    model = model.cuda()
    kw = scene_params(quality_finetune.FT_SCENE)
    base = make_scene(n_views=3, hw=(480, 640), n_rays=512, seed=123,
                      spread=0.5, **kw)
    step = FinetuneStep(model, cfg, *model.init_volumes(
        *[torch.from_numpy(base[k]).cuda() for k in ("imgs", "intrs",
                                                      "c2ws")]))
    batch = quality_finetune.ft_batches(base, kw, (480, 640), 512,
                                        torch.device("cuda"), n_batches=1)[0]

    def one_step():
        step(batch, 1.0, generator=torch.Generator().manual_seed(0))

    one_step()
    prof = profile_step(one_step)
    del model, step, batch
    print("quality ft path: " + json.dumps({
        "wall_s": wall, "steps": QUALITY_FT_STEPS,
        "ms_per_step": res["ft_ms_per_step"],
        "first_step_s": res["ft_compile_s"],
        "init_volumes_s": res["ft_init_volumes_s"],
        "train_peak_mem_gb": res["ft_train_peak_mem_gb"],
        "k3_launches": res["ft_k3_launches"],
        "psnr_rows": [r["psnr"] for r in curve],
        "ft_init": {k: res[f"ft_init_{k}"] for k in keys},
        "ft": {k: res.get(f"ft_{k}") for k in keys},
        "heldout_acc_mean": ref, "ft_init_rel_err": abs(acc - ref) / ref,
        "mesh_grid_s": [res["ft_init_mesh_grid_s"], res["ft_mesh_grid_s"]],
        "profile": prof}), flush=True)
    assert abs(acc - ref) <= QUALITY_FT_INIT_RTOL * ref, (acc, ref)


PHASE_A_TERMS = ("color_loss", "eikonal_loss", "smooth_loss", "sparse_loss",
                 "mfc_loss", "tv_loss")


def check_phase_a_step() -> dict:
    """Phase a's first training forward at the script's widths, (a-table)
    in f32 from the seed-0 init, on the GPU and on the CPU with the same
    batch and draws: every loss term within TRAIN_LOSS_RTOL, and each
    term's gradient of each module within TRAIN_GRAD_TOL, except the MFC
    term's gradient of the SDF, which is reported: it reaches the SDF
    through the zero-crossing root z = (s1 z2 - s2 z1) / (s1 - s2), whose
    1 / (s1 - s2)² amplifies the devices' rounding on rays that graze
    the surface."""
    from gens_torch import losses
    from gens_torch.eval import quality_train
    from gens_torch.eval.quality import scene_params
    from gens_torch.models.gens import GenSModel

    cfg = quality_train.build_cfg(quality_train.parse_args([]), 1500)
    torch.manual_seed(0)
    models = {"cpu": GenSModel(cfg.model)}
    models["gpu"] = GenSModel(cfg.model).cuda()
    models["gpu"].load_state_dict(models["cpu"].state_dict())
    terms, grads = {}, {}
    for side, d in (("cpu", torch.device("cpu")),
                    ("gpu", torch.device("cuda"))):
        model = models[side].train()
        batches, _ = quality_train.pregen_batches(
            scene_params(0), 1, False, 0, (128, 128), 512, 5, 0.5, d)
        out = model.forward_train(batches[0], 0.0, False,
                                  generator=torch.Generator().manual_seed(0))
        lo = losses.compute_losses(out, batches[0], cfg.train.loss)
        terms[side] = {t: float(lo[t].detach()) for t in PHASE_A_TERMS}
        grads[side] = {}
        for t in PHASE_A_TERMS:
            model.zero_grad(set_to_none=True)
            lo[t].backward(retain_graph=True)
            grads[side][t] = {k: p.grad.detach().cpu()
                              for k, p in model.named_parameters()
                              if p.grad is not None}
    loss_err = {t: abs(terms["gpu"][t] - terms["cpu"][t])
                / abs(terms["cpu"][t]) for t in PHASE_A_TERMS}
    grad_err = {}
    for t in PHASE_A_TERMS:
        for top in ("feature", "reg", "sdf", "blending"):
            keys = [k for k in grads["cpu"][t] if k.split(".")[0] == top]
            if not keys:
                continue
            a = torch.cat([grads["cpu"][t][k].reshape(-1) for k in keys])
            b = torch.cat([grads["gpu"][t][k].reshape(-1) for k in keys])
            if float(a.norm()) > 0:
                grad_err[f"{t}/{top}"] = float((a - b).norm() / a.norm())
    assert all(v <= TRAIN_LOSS_RTOL for v in loss_err.values()), loss_err
    bad = {k: v for k, v in grad_err.items()
           if v > TRAIN_GRAD_TOL and k != "mfc_loss/sdf"}
    assert not bad, bad
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err}


def gather_probe_path() -> dict:
    """``gens_torch.probes.gather --iters 2``: every row of both TPU probe
    scripts; returns P1-P3's launches in it (each kernel row: one check
    against index_select, then two passes of 2; P1 runs the 5 rows of E2
    and beside the library on the 11 of E1 and the 5 of C)."""
    from gens_torch.probes import gather as probe

    out = os.path.join(REPO, "build", "chip_smoke_gather_probe.json")
    zero_counts()
    t0 = time.perf_counter()
    res = probe.main(["--iters", "2", "--out", out])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    per_row = 1 + 2 * 2
    assert counts == {**grid_kernels(0), "K1": 0, "K2": 0, "P1": 21 * per_row,
                      "P2": 3 * per_row, "P3": 2 * per_row}, counts
    print("gather_probe " + json.dumps({"wall_s": wall, **res}), flush=True)
    return counts


def gather_phase(launches) -> list:
    """P1, P2 and P3 against their plain versions, bit for bit, on every
    probe shape at 2^20 indices; ms beside the bound, the plain version
    and the library calls. Returns the kernels-line rows (the first shape
    of each kernel; every shape is printed)."""
    from gens_torch.ops import gather as gk
    from gens_torch.probes import gather as probe

    g = torch.Generator(device="cuda").manual_seed(1)
    plans = {
        "P1": (gk.row_gather_take, [s for s in probe.E2]),
        "P2": (gk.row_gather_take_along,
               [s[1:] for s in probe.A if s[0] == "tala"]),
        "P3": (gk.onehot_gather, [s[1:] for s in probe.A if s[0] == "onehot"]),
    }
    source = {"P1": ("row_gather_take", "scripts/gather_probe.py:94"),
              "P2": ("row_gather_take_along", "scripts/gather_probe2.py:54"),
              "P3": ("onehot_gather", "scripts/gather_probe2.py:59")}
    rows = []
    for key, (wrapper, shapes) in plans.items():
        onehot = key == "P3"
        plain = gk.onehot_gather_plain if onehot else gk.row_gather_plain
        per_shape = []
        for n_rows, width, dt in shapes:
            table = torch.randn((n_rows, width), generator=g, device="cuda",
                                dtype=probe.DTYPES[dt])
            idx = torch.randint(0, n_rows, (GATHER_N,), generator=g,
                                device="cuda", dtype=torch.int32)
            got = wrapper(table, idx)
            ref = plain(table, idx)
            torch.cuda.synchronize()
            ibits = torch.int16 if table.dtype == torch.bfloat16 else \
                torch.int32
            if not torch.equal(got.view(ibits), ref.view(ibits)):
                raise AssertionError(f"{key} on {(n_rows, width, dt)} is not "
                                     "bit for bit its plain version")
            err = float((got.float() - ref.float()).abs().max())
            del got, ref
            elem = table.element_size()
            touched = int(torch.unique(idx).numel())
            n_bytes = 4 * GATHER_N + GATHER_N * width * elem \
                + touched * width * elem
            flops = 2.0 * GATHER_N * n_rows * width if onehot else 0.0
            t_bytes = n_bytes / PEAK_BYTES * 1e3
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            sel_table = table.to(torch.bfloat16).to(table.dtype) \
                if onehot else table
            entry = {
                "table_rows": n_rows, "width": width, "dtype": dt,
                "max_abs_err": err,
                "ms": cuda_ms(lambda: wrapper(table, idx), 20),
                "plain_ms": cuda_ms(lambda: plain(table, idx), 3),
                "index_select_ms": cuda_ms(
                    lambda: torch.index_select(sel_table, 0, idx), 20),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "operations" if t_ops > t_bytes else "bytes",
                "bytes": n_bytes, "flop": flops}
            if onehot:
                # cuBLAS on the same function: the pre-built bf16 one-hot
                # times the bf16 table
                cols = torch.arange(n_rows, device="cuda")
                oh = (idx[:, None].long() == cols[None]).to(torch.bfloat16)
                tb = table.to(torch.bfloat16)
                lib = torch.matmul(oh, tb)
                if not torch.equal(lib.float(), sel_table.float()[idx.long()]):
                    raise AssertionError("cuBLAS one-hot product differs")
                del lib
                entry["matmul_ms"] = cuda_ms(lambda: torch.matmul(oh, tb), 5)
                del oh, tb
            entry["library_ms"] = entry.get("matmul_ms",
                                            entry["index_select_ms"])
            per_shape.append(entry)
            del table, idx, sel_table
            torch.cuda.empty_cache()
        print(f"{key} {source[key][0]}: " + json.dumps(per_shape), flush=True)
        first = per_shape[0]
        rows.append({
            "name": source[key][0], "route": "cuda",
            "source": "gens_torch/csrc/gather_probe.cu",
            "replaces": source[key][1], "launches": launches[key],
            "max_abs_err": max(e["max_abs_err"] for e in per_shape),
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}})
    return rows


# -- the DTU and BlendedMVS paths ---------------------------------------------

# the DTU-layout tree: 49 cameras calibrated at 1600x1200 (DTU's focal
# lengths and principal point), depth range 425 + 2.5 * 192 = 905 mm; images,
# masks, depth maps and pseudo depths of scan24, light 3, for DTU_VIEWS at
# DTU's 1200x1600. The content is the synthetic sphere, rendered in units of
# DTU_UNIT mm (radius 0.5 = 100 mm) from cameras about 600 mm out.
DTU_K = np.array([[2892.33, 0.0, 823.21], [0.0, 2883.18, 619.07],
                  [0.0, 0.0, 1.0]])
DTU_VIEWS = (0, 1, 2, 3, 4, 5, 6, 22, 23, 24)
DTU_UNIT = 200.0
DTU_SCAN = "scan24"
BMVS_SCENE = "5bsyntheticsphere0000000"
BMVS_VIEWS = 5


def rig_c2w(k: int, dist: float) -> np.ndarray:
    """c2w (in sphere units) of the k-th camera of a cluster looking at the
    origin: azimuths 12 degrees apart in rows of five, rows 15 degrees
    apart in elevation."""
    from gens_torch.data.synthetic import look_at

    az = np.radians((k % 5 - 2) * 12.0)
    el = np.radians(30.0 + (k // 5) * 15.0)
    eye = dist * np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                           np.sin(el)], np.float32)
    return look_at(eye, np.zeros(3, np.float32))


def render_view(c2w, K, hw):
    """(RGB uint8, mask, z-depth in sphere units) of the synthetic sphere."""
    from gens_torch.data.synthetic import (render_sphere_view, shape_spheres,
                                           trace_spheres)

    img, mask = render_sphere_view(c2w, K.astype(np.float32), hw,
                                   return_mask=True)
    H, W = hw
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    cam = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float32) \
        @ np.linalg.inv(K).T.astype(np.float32)
    cam /= np.linalg.norm(cam, axis=-1, keepdims=True)
    t, hit, _ = trace_spheres(c2w[:3, 3], cam @ c2w[:3, :3].T,
                              *shape_spheres())
    depth = np.where(hit, t * cam[..., 2], 0.0).astype(np.float32)
    return (img * 255).astype(np.uint8), mask, depth


def write_cam(path, w2c, K, depth_min, depth_interval):
    """An MVSNet camera file."""
    rows = ["extrinsic"] + [" ".join(f"{v:.9f}" for v in r) for r in w2c]
    rows += ["", "intrinsic"] + [" ".join(f"{v:.6f}" for v in r) for r in K]
    rows += ["", f"{depth_min} {depth_interval}"]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def write_pfm(path, data):
    h, w = data.shape
    with open(path, "wb") as f:
        f.write(f"Pf\n{w} {h}\n-1.0\n".encode())
        np.flipud(data.astype("<f4")).tofile(f)


def write_pairs(path, centers, written):
    """pair.txt: per view, the 10 nearest views that have images (the
    last repeated where fewer are written)."""
    with open(path, "w") as f:
        f.write(f"{len(centers)}\n")
        for ref, c in enumerate(centers):
            src = sorted((v for v in written if v != ref),
                         key=lambda v: np.linalg.norm(centers[v] - c))[:10]
            src += src[-1:] * (10 - len(src))
            f.write(f"{ref}\n{len(src)} " + " ".join(
                f"{v} {100.0 - k}" for k, v in enumerate(src)) + "\n")


def write_dtu_tree(root: str) -> str:
    """The DTU-layout tree under ``root`` (written once)."""
    from gens_torch.data.dtu import PSEUDO_SCALE
    from gens_torch.data.image_io import write_png

    done = os.path.join(root, "complete")
    if os.path.exists(done):
        return root
    for sub in ("Cameras", f"Rectified_raw/{DTU_SCAN}",
                f"Depths_raw/{DTU_SCAN}", f"pseudo_depths/{DTU_SCAN}"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    # the views with images form the cluster; the others sit further up
    slot = {v: k for k, v in enumerate(DTU_VIEWS)}
    others = iter(range(10, 100))
    c2ws = [rig_c2w(slot[v] if v in slot else next(others),
                    3.0 + 0.02 * (v % 5)) for v in range(49)]
    for vid, c2w in enumerate(c2ws):
        c2w_mm = c2w.astype(np.float64)
        c2w_mm[:3, 3] *= DTU_UNIT
        write_cam(os.path.join(root, f"Cameras/{vid:08d}_cam.txt"),
                  np.linalg.inv(c2w_mm), DTU_K, 425.0, 2.5)
    write_pairs(os.path.join(root, "Cameras/pair.txt"),
                np.stack([c[:3, 3] for c in c2ws]), DTU_VIEWS)
    for vid in DTU_VIEWS:
        img, mask, depth = render_view(c2ws[vid], DTU_K, (1200, 1600))
        depth_mm = depth * DTU_UNIT
        write_png(os.path.join(
            root, f"Rectified_raw/{DTU_SCAN}/rect_{vid + 1:03d}_3_r5000.png"),
            img)
        d = os.path.join(root, f"Depths_raw/{DTU_SCAN}")
        write_png(os.path.join(d, f"depth_visual_{vid:04d}.png"),
                  (mask * 255).astype(np.uint8))
        write_pfm(os.path.join(d, f"depth_map_{vid:04d}.pfm"), depth_mm)
        np.save(os.path.join(root, f"pseudo_depths/{DTU_SCAN}/"
                             f"{vid}_epoch0.npy"),
                (depth_mm * PSEUDO_SCALE).astype(np.float32))
    open(done, "w").close()
    return root


def write_bmvs_tree(root: str) -> str:
    """A BlendedMVS-layout scene under ``root``: BMVS_VIEWS cameras
    calibrated at 768x576, masked JPEGs and rendered depth maps (the
    sphere, in its own units; background depth 0, below depth_min)."""
    from PIL import Image

    scene = os.path.join(root, BMVS_SCENE)
    done = os.path.join(scene, "complete")
    if os.path.exists(done):
        return root
    for sub in ("cams", "blended_images", "rendered_depth_maps"):
        os.makedirs(os.path.join(scene, sub), exist_ok=True)
    K = np.array([[700.0, 0.0, 384.0], [0.0, 700.0, 288.0], [0, 0, 1.0]])
    c2ws = [rig_c2w(k, 3.0) for k in range(BMVS_VIEWS)]
    for vid, c2w in enumerate(c2ws):
        write_cam(os.path.join(scene, f"cams/{vid:08d}_cam.txt"),
                  np.linalg.inv(c2w.astype(np.float64)), K, 1.5,
                  3.0 / 192)
        img, _, depth = render_view(c2w, K, (576, 768))
        Image.fromarray(img).save(os.path.join(
            scene, f"blended_images/{vid:08d}_masked.jpg"), quality=95)
        write_pfm(os.path.join(scene, f"rendered_depth_maps/{vid:08d}.pfm"),
                  depth)
    write_pairs(os.path.join(scene, "cams/pair.txt"),
                np.stack([c[:3, 3] for c in c2ws]), range(BMVS_VIEWS))
    open(done, "w").close()
    return root


def depth_png_in_colour(path: str) -> bool:
    """Whether the PNG at ``path`` is RGB with pixels whose channels
    differ (a colour map, not grey)."""
    from PIL import Image

    with Image.open(path) as im:
        a = np.asarray(im)
    return im.mode == "RGB" and bool((a[..., 0] != a[..., 2]).any())


DTU_ARTIFACT = os.path.join(REPO, "artifacts", "quality_gen_r05_sharpen.pkl")


def dtu_path(gens_main, dev) -> None:
    """confs/dtu.yaml, dtu_finetune.yaml and bmvs.yaml through ``gens_main``
    on DTU- and BlendedMVS-layout trees, with only the data paths and the
    run length overridden."""
    from gens_torch.config import DatasetConfig
    from gens_torch.data.dtu import DTUDataset

    t0 = time.perf_counter()
    tree = write_dtu_tree(os.path.join(REPO, "build", "chip_smoke_dtu"))
    btree = write_bmvs_tree(os.path.join(REPO, "build", "chip_smoke_bmvs"))
    tree_s = time.perf_counter() - t0
    data = [f"{ds}.{k}" for ds in ("train_dataset", "val_dataset")
            for k in (f"data_dir={tree}", f'scene=["{DTU_SCAN}"]')]
    dtu_train_path(gens_main, data, tree_s)
    torch.cuda.empty_cache()
    dtu_jax_resume_path(gens_main, data)
    torch.cuda.empty_cache()
    dtu_val_path(gens_main, data)
    torch.cuda.empty_cache()
    dtu_finetune_path(gens_main, tree)
    torch.cuda.empty_cache()
    raw = DTUDataset(DatasetConfig(
        data_dir=tree, split=None, scene=(DTU_SCAN,), ref_view=(0,),
        num_src_view=2, img_hw=(96, 128), n_rays=64, n_pseudo_pts=64),
        "train", rng=np.random.RandomState(0))[0]
    assert raw["pseudo_pts"].shape == (64, 3)
    check_small_train(dev, raw, "dtu train step")
    bmvs_val_path(gens_main, btree)
    torch.cuda.empty_cache()


def dtu_train_path(gens_main, data, tree_s: float) -> None:
    """confs/dtu.yaml trains 3 steps (ref views 0-2), then ``--resume
    auto`` trains epoch 1 from the first run's checkpoint with the
    config's validation at its end: K1 25 a step, 2048 pseudo points in
    every step's batch, finite losses, the train and train_avg records;
    per step the wait on the prefetch queue and an item's decode time."""
    from gens_torch.train import step as step_mod

    exp = os.path.join(REPO, "build", "chip_smoke_dtu_train")
    pseudo_rows = []
    call = step_mod.TrainStep.__call__

    def recording_call(self, inputs, *a, **k):
        pts = inputs.get("pseudo_pts")
        pseudo_rows.append(None if pts is None else int(pts.shape[0]))
        return call(self, inputs, *a, **k)

    step_mod.TrainStep.__call__ = recording_call
    runs = []
    try:
        for resume, epochs in (([], 1), (["--resume", "auto"], 2)):
            zero_counts()
            t0 = time.perf_counter()
            runner = gens_main(
                ["--conf", os.path.join(REPO, "confs", "dtu.yaml"), "--mode",
                 "train"] + resume + ["--set", f"base_exp_dir={exp}",
                                      "train_dataset.ref_view=[0,1,2]",
                                      f"train.epochs={epochs}"] + data)
            runs.append((runner, time.perf_counter() - t0, launch_counts()))
    finally:
        step_mod.TrainStep.__call__ = call
    (first, first_wall, first_counts), (second, second_wall, second_counts) \
        = runs
    cfg = first.cfg
    assert cfg.train_dataset.dataset_name == "dtu"
    assert tuple(cfg.train_dataset.img_hw) == (480, 640)
    assert cfg.train_dataset.num_src_view == 4
    assert cfg.model.volume.packed_bilerp == "pallas"
    k1_run = 3 * 5 * len(cfg.model.volume.volume_dims)
    zeros = {k: 0 for k in first_counts}
    assert first_counts == {**zeros, "K1": k1_run}, first_counts
    # the resumed epoch ends with confs/dtu.yaml's validation (val_freq 2)
    assert second_counts == {**zeros, "K1": k1_run, **grid_kernels(512)}, \
        second_counts
    assert second.start_epoch == 1, second.start_epoch
    # the resumed run read the port's checkpoint, optimizer state as numpy
    assert (first.opt_state_form, second.opt_state_form) == (None, "numpy")
    assert [s["step"] for s in first.train_stats] == [1, 2, 3]
    assert [s["step"] for s in second.train_stats] == [4, 5, 6]
    assert pseudo_rows == [2048] * 6, pseudo_rows
    steps = first.train_stats + second.train_stats
    for st in steps:
        bad = [k for k, v in st.items() if not np.isfinite(v)]
        assert not bad, (st["step"], bad)
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        kinds = [json.loads(line)["mode"] for line in f]
    assert kinds.count("train") == 6 and kinds.count("train_avg") == 2, kinds
    print("dtu train path: " + json.dumps({
        "tree_s": tree_s, "wall_s": [first_wall, second_wall],
        "step_ms": [s["step_s"] * 1e3 for s in steps],
        "data_wait_ms": [s["data_wait_s"] * 1e3 for s in steps],
        "decode_ms": [s["decode_s"] * 1e3 for s in steps],
        "k1_launches": [first_counts["K1"], second_counts["K1"]],
        "resumed_at_epoch": second.start_epoch,
        "resumed_opt_state_form": second.opt_state_form,
        "val_in_training": {k: second.stats[0][k] for k in (
            "psnr", "n_tris", "mesh_grid_s", "render_s")},
        "losses": {k: v for k, v in steps[-1].items() if k not in (
            "epoch", "step", "step_s", "data_wait_s", "decode_s")}}),
        flush=True)


JAX_STEP = 3
# the optax class paths of a gens_tpu training checkpoint (optax 0.2.x)
OPTAX_PATHS = ("optax.transforms._combining.PartitionState",
               "optax.transforms._masking.MaskedState",
               "optax.transforms._masking.MaskedNode",
               "optax._src.transform.ScaleByAdamState",
               "optax._src.transform.ScaleByScheduleState",
               "optax._src.base.EmptyState")


def write_jax_checkpoint(path: str, cfg, seed: int) -> dict:
    """A JAX training checkpoint of a seeded model at ``cfg``'s width: the
    params in the JAX layout and an optax Adam state after JAX_STEP updates
    (seeded moments), pickled under optax's class paths (the keys of
    ``JAX_PICKLE_CLASSES``) as gens_tpu's ``save_checkpoint`` pickles
    them. optax need not exist: stand-in modules named as optax's exist
    only while the file is written. Returns {port parameter name:
    exp_avg} of the moments written."""
    import collections
    import pickle
    import types

    from gens_torch.convert import (JAX_PICKLE_CLASSES, load_checkpoint,
                                    params_to_jax)
    from gens_torch.models.gens import GenSModel
    from gens_torch.train.checkpoint import jax_adam_moments
    from gens_torch.train.step import GROUPS

    torch.manual_seed(seed)
    params = params_to_jax(GenSModel(cfg.model).state_dict())
    fakes, classes = {}, {}
    for cls_path in OPTAX_PATHS:
        module, name = cls_path.rsplit(".", 1)
        cls = collections.namedtuple(name,
                                     JAX_PICKLE_CLASSES[cls_path]._fields)
        cls.__module__ = module
        parts = module.split(".")
        for i in range(1, len(parts) + 1):
            fakes.setdefault(".".join(parts[:i]),
                             types.ModuleType(".".join(parts[:i])))
        setattr(fakes[module], name, cls)
        classes[name] = cls
    rng = np.random.RandomState(seed)

    def draw(tree, second):
        if isinstance(tree, dict):
            return {k: draw(v, second) for k, v in tree.items()}
        x = np.asarray(rng.randn(*tree.shape))
        return (np.abs(x) * 1e-6 if second else x * 1e-3).astype(np.float32)

    def moments(label, second):
        return {top: draw(sub, second) if GROUPS.get(top) == label
                else classes["MaskedNode"]() for top, sub in params.items()}

    count = np.asarray(JAX_STEP, np.int32)
    inner = {label: classes["MaskedState"]((
        classes["ScaleByAdamState"](count, moments(label, False),
                                    moments(label, True)),
        classes["ScaleByScheduleState"](count)))
        for label in ("mlp", "variance", "feat")}
    inner["frozen"] = classes["MaskedState"](classes["EmptyState"]())
    opt_state = classes["PartitionState"](inner)
    saved = {k: sys.modules.get(k) for k in fakes}
    sys.modules.update(fakes)
    try:
        data = pickle.dumps({"epoch": 0, "step": JAX_STEP,
                             "format_version": 2, "params": params,
                             "opt_state": opt_state}, protocol=4)
    finally:
        for k, mod in saved.items():
            if mod is None:
                del sys.modules[k]
            else:
                sys.modules[k] = mod
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return jax_adam_moments(load_checkpoint(path)["opt_state"])[0]


def dtu_jax_resume_path(gens_main, data) -> None:
    """``--mode train --resume`` of a JAX-form checkpoint (optax's Adam
    state) at confs/dtu.yaml's width, one step (epoch 1 of one item): the
    optimizer state read in its optax form, K1 25, finite losses, and the
    step's first moments b1 · mu + (1 - b1) · g of the carried mu."""
    import importlib.util

    from gens_torch.config import load_config

    exp = os.path.join(REPO, "build", "chip_smoke_jax_resume")
    shutil.rmtree(exp, ignore_errors=True)
    conf = os.path.join(REPO, "confs", "dtu.yaml")
    ckpt = os.path.join(exp, "jax", "model_000.ckpt")
    mu = write_jax_checkpoint(ckpt, load_config(conf), seed=3)
    zero_counts()
    t0 = time.perf_counter()
    runner = gens_main(["--conf", conf, "--mode", "train", "--resume", ckpt,
                        "--set", f"base_exp_dir={exp}",
                        "train_dataset.ref_view=[0]", "train.epochs=2",
                        "train.val_freq=100"] + data)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    assert counts == {**{k: 0 for k in counts}, "K1": 25}, counts
    assert runner.opt_state_form == "optax", runner.opt_state_form
    (st,) = runner.train_stats
    assert (st["epoch"], st["step"]) == (1, JAX_STEP + 1), st
    bad = [k for k, v in st.items() if not np.isfinite(v)]
    assert not bad, bad
    opt = runner.step_fn.optimizer
    err, n = 0.0, 0
    for name, p in runner.model.named_parameters():
        if name.startswith("match_feature"):
            continue
        state = opt.state[p]
        assert float(state["step"]) == JAX_STEP + 1, name
        want = 0.9 * mu[name].to(p.device) + 0.1 * p.grad
        err = max(err, float((state["exp_avg"] - want).abs().max()
                             / want.abs().max().clamp_min(1e-30)))
        n += 1
    assert n == len(mu), (n, len(mu))
    print("dtu jax resume path: " + json.dumps({
        "wall_s": wall, "opt_state_form": runner.opt_state_form,
        "optax_importable": importlib.util.find_spec("optax") is not None,
        "step": st["step"], "step_ms": st["step_s"] * 1e3,
        "k1_launches": counts["K1"], "params": n,
        "exp_avg_rel_err": err, "loss": st["loss"]}), flush=True)
    assert err <= 1e-5, err


def dtu_val_path(gens_main, data) -> None:
    """``--mode val`` of confs/dtu.yaml on the trained artifact (scan24,
    reference view 23): K3 512, a finite grid and render, a surface, the
    depth PNGs in colour."""
    exp = os.path.join(REPO, "build", "chip_smoke_dtu_val")
    zero_counts()
    t0 = time.perf_counter()
    runner = gens_main(["--conf", os.path.join(REPO, "confs", "dtu.yaml"),
                        "--mode", "val", "--resume", DTU_ARTIFACT, "--set",
                        f"base_exp_dir={exp}", "mesh_resolution=512"] + data)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    (st,) = runner.stats
    assert counts == {**{k: 0 for k in counts}, **grid_kernels(512)}, counts
    assert st["scene"] == DTU_SCAN and st["rays"] == 120 * 160, st
    assert st["grid_finite"] and st["render_finite"] and np.isfinite(
        st["psnr"])
    # an inside margin of 0.14 on an H100 80GB HBM3 (PERF.md section 5)
    assert st["n_tris"] > 0, "empty mesh of the DTU val scene"
    for sub in ("val_render_depth", "val_sdf_depth"):
        (name,) = os.listdir(os.path.join(exp, sub))
        assert name.startswith(f"{DTU_SCAN}_view23_light3_epoch"), name
        assert depth_png_in_colour(os.path.join(exp, sub, name)), sub
    print("dtu val path: " + json.dumps({
        "wall_s": wall, "k3_launches": counts["K3"],
        "outside_margin": float(-runner.last_sdf_grid.min()),
        **{k: st[k] for k in ("psnr", "n_tris", "build_scene_s",
                              "mesh_grid_s", "isosurface_s", "render_s",
                              "rays_per_s", "render_depth_loss",
                              "sdf_depth_loss")}}), flush=True)


def dtu_finetune_path(gens_main, tree: str) -> None:
    """confs/dtu_finetune.yaml (scan24, view 23, 3 views at 1152x1600) on
    the trained artifact under ``kernel2f``, 6 steps: K2 15, all in the
    volume build, K3 512 at the validation, finite losses."""
    from gens_torch.models.gens import GenSModel

    exp = os.path.join(REPO, "build", "chip_smoke_dtu_ft")
    build = {}
    init_volumes = GenSModel.init_volumes

    def counted_init_volumes(self, imgs, intrs, c2ws):
        n0 = launch_counts()["K2"]
        out = init_volumes(self, imgs, intrs, c2ws)
        build["k2"] = launch_counts()["K2"] - n0
        return out

    GenSModel.init_volumes = counted_init_volumes
    zero_counts()
    t0 = time.perf_counter()
    try:
        runner = gens_main([
            "--conf", os.path.join(REPO, "confs", "dtu_finetune.yaml"),
            "--mode", "finetune", "--resume", DTU_ARTIFACT, "--set",
            f"base_exp_dir={exp}", f"finetune_dataset.data_dir={tree}",
            "model.volume.packed_bilerp=pallas",
            "model.volume.splat_impl=kernel2f", "train.epochs=6"])
    finally:
        GenSModel.init_volumes = init_volumes
    wall = time.perf_counter() - t0
    counts = launch_counts()
    cfg = runner.cfg
    assert tuple(cfg.finetune_dataset.img_hw) == (1152, 1600)
    assert list(cfg.finetune_dataset.scene) == [DTU_SCAN]
    assert counts == {**{k: 0 for k in counts}, "K2": 15,
                      **grid_kernels(512)}, counts
    assert build["k2"] == 15, build
    steps = [s for s in runner.finetune_stats if "loss" in s]
    (val,) = [s for s in runner.finetune_stats if "val_step" in s]
    assert len(steps) == 6
    for s in steps:
        bad = [k for k, v in s.items() if not np.isfinite(v)]
        assert not bad, (s["step"], bad)
    assert val["grid_finite"] and val["render_finite"]
    assert val["rays"] == 288 * 400, val["rays"]
    print("dtu finetune path: " + json.dumps({
        "wall_s": wall, "init_volumes_ms": runner.init_volumes_s * 1e3,
        "step_ms": [s["step_s"] * 1e3 for s in steps],
        "k2_launches": counts["K2"], "k3_launches": counts["K3"],
        "val_psnr": val["psnr"], "val_n_tris": val["n_tris"],
        "val_mesh_grid_s": val["mesh_grid_s"], "val_render_s": val["render_s"],
        "losses": {k: v for k, v in steps[-1].items()
                   if k not in ("step", "vid", "step_s")}}), flush=True)


def bmvs_val_path(gens_main, btree: str) -> None:
    """``--mode val`` of confs/bmvs.yaml (576x768) on the trained artifact,
    reference view 0 of the BlendedMVS-layout scene: K3 512, a finite grid
    and render, a surface."""
    exp = os.path.join(REPO, "build", "chip_smoke_bmvs_val")
    zero_counts()
    t0 = time.perf_counter()
    runner = gens_main([
        "--conf", os.path.join(REPO, "confs", "bmvs.yaml"), "--mode", "val",
        "--resume", DTU_ARTIFACT, "--set", f"base_exp_dir={exp}",
        f"val_dataset.data_dir={btree}", f'val_dataset.scene=["{BMVS_SCENE}"]',
        "val_dataset.ref_view=[0]"])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    (st,) = runner.stats
    assert tuple(runner.cfg.val_dataset.img_hw) == (576, 768)
    assert counts == {**{k: 0 for k in counts},
                      **grid_kernels((runner.cfg.mesh_resolution // 64) ** 3)
                      }, counts
    assert st["rays"] == 144 * 192 and st["grid_finite"] \
        and st["render_finite"], st
    assert st["n_tris"] > 0, "empty mesh of the BlendedMVS val scene"
    print("bmvs val path: " + json.dumps({
        "wall_s": wall, "k3_launches": counts["K3"],
        "outside_margin": float(-runner.last_sdf_grid.min()),
        **{k: st[k] for k in ("psnr", "n_tris", "mesh_grid_s", "render_s")}}),
        flush=True)


# -- the options phase --------------------------------------------------------

# the options of the JAX model, as confs/dtu.yaml overrides: "alt" puts the
# MnasNet backbone (its encoder from a pretrained_path pickle), GlobalAttn
# at the U-Net's 8³ bottleneck and the idr colour head on the path of K1;
# "adaptive" aggregates by the learned softmax, whose backward is the plain
# bilerp's (no K1), with reg_network.d_volume = C
OPTIONS = {
    "alt": ["model.feature_network.backbone=mnasnet",
            "model.reg_network.use_global_attn=true",
            "model.color_network.head=idr"],
    "adaptive": ["model.volume.agg=adaptive",
                 "model.reg_network.d_volume=[4,4,4,4,4]"],
}
OPTIONS_DIR = os.path.join(REPO, "build", "chip_smoke_options")


def torchvision_mnasnet_state(seed: int) -> dict:
    """A seeded state dict in torchvision's ``mnasnet1_0().layers`` layout
    (conv weights, BN weight / bias / running statistics), as numpy."""
    rng = np.random.RandomState(seed)
    state = {}

    def conv(name, shape):
        fan_in = shape[1] * shape[2] * shape[3]
        state[name] = (rng.randn(*shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def bn(prefix, c):
        state[prefix + ".weight"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
        state[prefix + ".bias"] = rng.uniform(-0.2, 0.2, c).astype(
            np.float32)
        state[prefix + ".running_mean"] = rng.uniform(-0.2, 0.2, c).astype(
            np.float32)
        state[prefix + ".running_var"] = rng.uniform(0.5, 2.0, c).astype(
            np.float32)

    conv("layers.0.weight", (32, 3, 3, 3))
    bn("layers.1", 32)
    conv("layers.3.weight", (32, 1, 3, 3))
    bn("layers.4", 32)
    conv("layers.6.weight", (16, 32, 1, 1))
    bn("layers.7", 16)
    c_in = 16
    for t_idx, (c_out, k, expand, n) in zip(range(8, 14), (
            (24, 3, 3, 3), (40, 5, 3, 3), (80, 5, 6, 3), (96, 3, 6, 2),
            (192, 5, 6, 4), (320, 3, 6, 1))):
        for b in range(n):
            mid = (c_in if b == 0 else c_out) * expand
            base = f"layers.{t_idx}.{b}.layers"
            conv(f"{base}.0.weight", (mid, c_in if b == 0 else c_out, 1, 1))
            bn(f"{base}.1", mid)
            conv(f"{base}.3.weight", (mid, 1, k, k))
            bn(f"{base}.4", mid)
            conv(f"{base}.6.weight", (c_out, mid, 1, 1))
            bn(f"{base}.7", c_out)
        c_in = c_out
    return state


def options_path(gens_main, dev, tree: str) -> None:
    """confs/dtu.yaml under each of OPTIONS through ``gens_main`` on the
    DTU-layout tree: 3 training steps from a seeded init ("alt": K1 25 a
    step; "adaptive": none), then ``--mode val`` of one scene on that run's
    checkpoint with a 512³ mesh (K3 512). Per config one line: the step
    times after the first, the val scene's time and split, the peak
    memory, the launch counts. Then a tiny training step GPU against CPU
    for each option, on the gradients of the module it adds."""
    import pickle

    from gens_torch.convert import load_params
    from gens_torch.models import mnasnet
    from gens_torch.models.gens import GenSModel
    from gens_torch.utils.profiling import device_memory_stats

    os.makedirs(OPTIONS_DIR, exist_ok=True)
    pretrained = os.path.join(OPTIONS_DIR, "mnasnet_encoder.pkl")
    with open(pretrained, "wb") as f:
        pickle.dump(mnasnet.convert_torch_mnasnet(
            torchvision_mnasnet_state(0)), f)
    data = [f"{ds}.{k}" for ds in ("train_dataset", "val_dataset")
            for k in (f"data_dir={tree}", f'scene=["{DTU_SCAN}"]')]
    conf = os.path.join(REPO, "confs", "dtu.yaml")
    for name, opts in OPTIONS.items():
        exp = os.path.join(OPTIONS_DIR, name)
        opts = opts + ([f"model.feature_network.pretrained_path={pretrained}"]
                       if name == "alt" else [])
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        runner = gens_main(["--conf", conf, "--mode", "train", "--set",
                            f"base_exp_dir={exp}",
                            "train_dataset.ref_view=[0,1,2]",
                            "train.epochs=1"] + opts + data)
        train_wall = time.perf_counter() - t0
        train_counts = launch_counts()
        train_peak = device_memory_stats(dev)["peak_bytes_gb"]
        cfg = runner.cfg
        m = cfg.model
        assert tuple(m.volume.volume_dims) == (256, 128, 64, 32, 16)
        assert tuple(cfg.train_dataset.img_hw) == (480, 640)
        assert cfg.train_dataset.num_src_view == 4
        assert cfg.train_dataset.n_rays == 512
        assert (m.render.n_samples, m.render.n_importance) == (64, 64)
        assert m.reg_network.dtype == m.sdf_network.mlp_dtype == "bfloat16"
        steps = runner.train_stats
        assert [s["step"] for s in steps] == [1, 2, 3], steps
        for st in steps:
            bad = [k for k, v in st.items() if not np.isfinite(v)]
            assert not bad, (name, st["step"], bad)
        k1 = 3 * 5 * len(m.volume.volume_dims) if name == "alt" else 0
        zeros = {k: 0 for k in train_counts}
        assert train_counts == {**zeros, "K1": k1}, (name, train_counts)
        model = runner.model
        if name == "alt":
            assert isinstance(model.feature, mnasnet.MnasNetFeatureNetwork)
            assert model.reg.global_attn is not None
            assert model.renderer.color_head == "idr"
            # the BN statistics are the pickle's after 3 steps
            ref = mnasnet.MnasNetEncoder()
            mnasnet.load_pretrained_encoder(ref, pretrained)
            got = model.feature.encoder.state_dict()
            for k, v in ref.state_dict().items():
                if "running_" in k:
                    assert torch.equal(got[k].cpu(), v), k
        else:
            assert model.agg is not None
            assert tuple(m.reg_network.d_volume) == (4,) * 5
        ckpt = os.path.join(exp, "checkpoints", "model_000.ckpt")
        loaded = GenSModel(m)
        load_params(loaded, ckpt)
        state = model.state_dict()
        for k, v in loaded.state_dict().items():
            assert torch.equal(v, state[k].cpu()), (name, k)
        del runner, model, loaded, state
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        runner = gens_main(["--conf", conf, "--mode", "val", "--resume", ckpt,
                            "--set", f"base_exp_dir={exp}",
                            "mesh_resolution=512"] + opts + data)
        val_wall = time.perf_counter() - t0
        val_counts = launch_counts()
        val_peak = device_memory_stats(dev)["peak_bytes_gb"]
        (st,) = runner.stats
        assert val_counts == {**zeros, **grid_kernels(512)}, (name, val_counts)
        assert st["rays"] == 120 * 160, st
        assert st["grid_finite"] and st["render_finite"], st
        assert np.isfinite(st["psnr"]), st
        print(f"options {name} path: " + json.dumps({
            "options": opts, "train_wall_s": train_wall,
            "first_step_ms": steps[0]["step_s"] * 1e3,
            "later_steps_ms": [s["step_s"] * 1e3 for s in steps[1:]],
            "train_peak_mem_gb": train_peak, "train_launches": train_counts,
            "val_wall_s": val_wall, "val_peak_mem_gb": val_peak,
            "val_launches": val_counts,
            **{k: st[k] for k in ("build_scene_s", "mesh_grid_s",
                                  "isosurface_s", "render_s", "n_tris",
                                  "psnr")},
            "losses": {k: v for k, v in steps[-1].items() if k not in (
                "epoch", "step", "step_s", "data_wait_s", "decode_s")}}),
            flush=True)
        del runner
        torch.cuda.empty_cache()

    def mnasnet_backbone(m):
        m.feature_network.backbone = "mnasnet"

    def adaptive_agg(m):
        m.volume.agg = "adaptive"
        m.reg_network.d_volume = (4,) * 5

    def global_attn(m):
        # three scales: a 4³ bottleneck, where GlobalAttn attends over 64
        # voxels (tiny's five leave one)
        m.reg_network.use_global_attn = True
        m.volume.volume_dims = (32, 16, 8)
        m.reg_network.d_volume, m.reg_network.d_out = (8,) * 3, (4,) * 3
        m.sdf_network.feat_channels = 12

    def idr_head(m):
        m.color_network.head = "idr"

    for setup, modules in ((mnasnet_backbone, ("feature", "sdf")),
                           (adaptive_agg, ("agg", "feature", "sdf")),
                           (global_attn, ("reg", "sdf")),
                           (idr_head, ("blending", "sdf"))):
        check_small_train(dev, name=f"option {setup.__name__} train step",
                          setup=setup, modules=modules)


# -- the parallel path --------------------------------------------------------

# each spawned group of ranks: seconds before it is killed and the script
# fails
RANKS_TIMEOUT = 300
# the 2-rank val against one process: the per-scene metrics are the same
# computation on the same card; the merge sums them in another order
VAL_MERGE_RTOL = 1e-3
PARALLEL_DIR = os.path.join(REPO, "build", "chip_smoke_parallel")


def run_ranks(argvs, name: str, env_extra=None) -> list:
    """``python3 chip_smoke.py <argv>`` once for each argv, as ranks 0..n-1
    of one group (RANK, WORLD_SIZE, LOCAL_RANK 0, MASTER_ADDR/PORT), output
    under PARALLEL_DIR. A rank that fails or outlasts RANKS_TIMEOUT stops
    every rank and fails the script. Returns each rank's JSON result and
    the group's wall seconds."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    procs, outs = [], []
    t0 = time.perf_counter()
    for r, argv in enumerate(argvs):
        out = os.path.join(PARALLEL_DIR, f"{name}_rank{r}.json")
        if os.path.exists(out):
            os.remove(out)
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(len(argvs)),
                   LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), **(env_extra or {}))
        log = open(os.path.join(PARALLEL_DIR, f"{name}_rank{r}.log"), "wb")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)] + argv + [out],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
        outs.append(out)
    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() - t0 > RANKS_TIMEOUT:
                raise RuntimeError(f"{name}: over {RANKS_TIMEOUT} s")
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"{name}: rank(s) {failed} failed")
    except RuntimeError:
        for r in range(len(procs)):
            with open(os.path.join(PARALLEL_DIR, f"{name}_rank{r}.log"),
                      errors="replace") as f:
                print(f"-- {name} rank {r}:\n" + f.read()[-4000:],
                      flush=True)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results, wall


def rank_main(argv, out: str) -> None:
    """A rank of a parallel run: ``gens_main(argv)`` with the counts zeroed
    just before and read just after; its launches, step stats, val and
    finetune stats, metrics and peak memory into ``out``; where this rank
    led a validation split over several ranks, its last render into
    ``<out>.npz`` and its last scene into ``<out>.scene.pt``."""
    from gens_torch.main import main as gens_main

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    runner = gens_main(argv)
    wall = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump({"wall_s": wall, "counts": launch_counts(),
                   "train_stats": getattr(runner, "train_stats", []),
                   "val_stats": [{k: v for k, v in st.items()
                                  if not isinstance(v, str)}
                                 for st in runner.stats],
                   "finetune_stats": [{k: v for k, v in st.items()
                                       if not isinstance(v, str)}
                                      for st in runner.finetune_stats],
                   "metrics": runner.metrics,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9},
                  f)
    split = [st for st in runner.stats + runner.finetune_stats
             if st.get("group_size", 1) > 1]
    if split and getattr(runner, "last_render", None) is not None:
        np.savez(out + ".npz", **runner.last_render)
        sc = runner.last_scene
        torch.save({k: [t.cpu() for t in getattr(sc, k)] for k in (
            "volumes", "mask_volumes", "features", "match_features")}
            | {k: getattr(sc, k).cpu() for k in ("imgs", "intrs", "c2ws")},
            out + ".scene.pt")


# the parity check's dtypes: f32 where confs/dtu.yaml has bf16, as the
# GPU-vs-CPU checks (the widths, the K1 route and the data stay the yaml's).
# In bf16 the U-Net amplifies any f32 difference of its input, K1's atomics
# order included: one-process steps against each other differ by ~2% in
# the reg net's gradient (PERF.md section 6)
PARITY_F32 = ["model.volume.dtype=float32",
              "model.volume.splat_mm_dtype=float32",
              "model.reg_network.dtype=float32",
              "model.sdf_network.volume_dtype=float32",
              "model.sdf_network.mlp_dtype=float32",
              "model.color_network.packed_dtype=float32",
              "model.color_network.mlp_dtype=float32"]


def parity_config(tree: str, f32: bool = True):
    from gens_torch.config import load_config

    return load_config(os.path.join(REPO, "confs", "dtu.yaml"), [
        f"train_dataset.data_dir={tree}",
        f'train_dataset.scene=["{DTU_SCAN}"]',
        "train_dataset.ref_view=[0,1]"] + (PARITY_F32 if f32 else []))


def rank_parity(spec_path: str, out: str) -> None:
    """A rank of the parity check: for each (name, data, view) of the spec,
    one ShardedTrainStep at confs/dtu.yaml's width from the saved init on
    the saved batch and draws of its data row; metrics, gradients (saved
    beside ``out``) and K1's launches. Backend "nccl" runs a one-rank
    world whose view group is the world, so every collective of the step
    runs."""
    import torch.distributed as dist

    from gens_torch.models.gens import GenSModel
    from gens_torch.parallel.distributed import RankLayout, make_layout
    from gens_torch.parallel.sharded import ShardedTrainStep, shard

    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        spec["backend"], world_size=world, rank=rank,
        init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}")
    data = torch.load(spec["batch"])
    cfg = parity_config(spec["tree"])
    result = {}
    for name, n_data, n_view in spec["cases"]:
        if spec["backend"] == "nccl":
            layout = RankLayout(1, 1, 0, view_group=dist.group.WORLD)
        else:
            layout = make_layout(n_data, n_view)
        model = GenSModel(cfg.model).to(dev)
        model.load_state_dict(data["init"])
        step = ShardedTrainStep(model, cfg, 1, layout)
        row, col = layout.data_row, layout.view_col
        inputs = {k: v.to(dev) for k, v in data["items"][row].items()}
        zero_counts()
        metrics = step(inputs, 0.5,
                       perturb_noise=shard(data["noise"][row], n_view, col),
                       sparse_pts=shard(data["sparse"][row], n_view, col))
        torch.cuda.synchronize()
        counts = launch_counts()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        if rank == 0:
            torch.save(grads, out + f".{name}.grads.pt")
        result[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                        "counts": counts}
        del model, step, inputs, grads
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(result, f)


def one_process_step(cfg, init, item, noise, sparse, dev) -> dict:
    """One TrainStep from ``init`` on ``item`` with the given draws: its
    loss and gradients (on the host)."""
    from gens_torch.models.gens import GenSModel
    from gens_torch.train.step import TrainStep

    model = GenSModel(cfg.model).to(dev)
    model.load_state_dict(init)
    metrics = TrainStep(model, cfg, 1)(
        {k: v.to(dev) for k, v in item.items()}, 0.5, perturb_noise=noise,
        sparse_pts=sparse)
    out = {"loss": float(metrics["loss"]),
           "grads": {k: p.grad.cpu() for k, p in model.named_parameters()
                     if p.grad is not None}}
    del model
    torch.cuda.empty_cache()
    return out


def parity_references(tree: str, dev):
    """The one-process step at confs/dtu.yaml's widths (f32) from a seeded
    init on two DTU items (reference views 0 and 1), with fixed
    perturbation and sparse points; saves the init, the items (with the
    sharded runner's batch schema) and the draws for the ranks. Returns
    the saved file, each item's loss and gradients, and the run-to-run
    noise: item 0's step again, in f32 and in the yaml's bf16."""
    from gens_torch.data.dtu import DTUDataset
    from gens_torch.models.gens import GenSModel
    from gens_torch.runner import _float_arrays, materialize_schema

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = parity_config(tree)
    dataset = DTUDataset(cfg.train_dataset, "train",
                         rng=np.random.RandomState(0))
    items = [_float_arrays(materialize_schema(
        dataset[i], True, cfg.train_dataset.n_pseudo_pts)) for i in (0, 1)]
    g = torch.Generator().manual_seed(5)
    n_rays = items[0]["rays_o"].shape[0]
    noise = [torch.rand((n_rays, 1), generator=g) - 0.5 for _ in items]
    sparse = [torch.rand((cfg.model.render.n_sparse_pts, 3), generator=g)
              * 2 - 1 for _ in items]
    torch.manual_seed(cfg.train.seed)
    init = GenSModel(cfg.model).state_dict()
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    batch = os.path.join(PARALLEL_DIR, "parity_batch.pt")
    torch.save({"init": init, "items": items, "noise": noise,
                "sparse": sparse}, batch)
    refs = [one_process_step(cfg, init, item, nz, sp, dev)
            for item, nz, sp in zip(items, noise, sparse)]
    repeat = {"f32": grad_errors(refs[0], one_process_step(
        cfg, init, items[0], noise[0], sparse[0], dev))}
    bf16 = parity_config(tree, f32=False)
    twice = [one_process_step(bf16, init, items[0], noise[0], sparse[0], dev)
             for _ in range(2)]
    repeat["bf16"] = grad_errors(*twice)
    return batch, refs, repeat


def grad_errors(ref: dict, got: dict):
    """(loss relative error, per-module gradient relative norm errors) of
    ``got`` against ``ref``, each {"loss", "grads"}."""
    errs = {}
    for top in ("feature", "reg", "sdf", "blending", "variance"):
        keys = [k for k in ref["grads"] if k.split(".")[0] == top]
        a = torch.cat([ref["grads"][k].reshape(-1) for k in keys])
        b = torch.cat([got["grads"][k].reshape(-1) for k in keys])
        errs[top] = float((a - b).norm() / a.norm())
    return abs(got["loss"] - ref["loss"]) / abs(ref["loss"]), errs


def rank_step(result: dict, name: str, out: str) -> dict:
    """A parity rank's {"loss", "grads"} for case ``name``."""
    return {"loss": result[name]["metrics"]["loss"],
            "grads": torch.load(out + f".{name}.grads.pt")}


def parallel_path(gens_main, dev, tree: str) -> None:
    """confs/dtu.yaml on two ranks through ``gens_torch.main`` (gloo, both
    on cuda:0, which they time-slice), under parallel.view=2 (5 views
    padded to 6: K1 15 a step on each rank) and parallel.data=2 (K1 25);
    the 2-rank step against the one-process step at that width on a fixed
    batch and draws (view=2 on one item, data=2 on two); a one-rank NCCL
    group running the step's collectives; and a 2-rank ``--mode val`` of
    two DTU items against one process."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"parallel path: compute mode {mode}; gloo on CUDA tensors "
          f"(all_reduce, broadcast) with torch {torch.__version__}; two "
          "ranks on one card time-slice it: their step times are no "
          "scaling measurement", flush=True)
    shared = mode.splitlines()[0] == "Default"
    t_phase = time.perf_counter()
    data = [f"{ds}.{k}" for ds in ("train_dataset", "val_dataset")
            for k in (f"data_dir={tree}", f'scene=["{DTU_SCAN}"]')]
    conf = ["--conf", os.path.join(REPO, "confs", "dtu.yaml")]

    batch, refs, repeat = parity_references(tree, dev)
    print("parallel one-process repeat (run-to-run noise of the reference "
          "step): " + json.dumps(repeat), flush=True)
    mean = {"loss": (refs[0]["loss"] + refs[1]["loss"]) / 2,
            "grads": {k: (refs[0]["grads"][k] + refs[1]["grads"][k]) / 2
                      for k in refs[0]["grads"]}}

    def parity(name, backend, cases, world):
        spec = os.path.join(PARALLEL_DIR, f"{name}.json")
        with open(spec, "w") as f:
            json.dump({"backend": backend, "cases": cases, "batch": batch,
                       "tree": tree}, f)
        return run_ranks([["--rank-parity", spec]] * world, name)

    # one rank, NCCL: the sharded step's collectives on the card
    (nccl,), nccl_wall = parity("nccl1", "nccl", [["nccl", 1, 1]], 1)
    rel, errs = grad_errors(refs[0], rank_step(
        nccl, "nccl", os.path.join(PARALLEL_DIR, "nccl1_rank0.json")))
    print("parallel nccl one rank vs one process: " + json.dumps({
        "loss_rel_err": rel, "grad_rel_err": errs, "wall_s": nccl_wall,
        "k1_launches": nccl["nccl"]["counts"]["K1"]}), flush=True)
    assert rel <= TRAIN_LOSS_RTOL and max(errs.values()) <= TRAIN_GRAD_TOL
    assert nccl["nccl"]["counts"]["K1"] == 25

    if not shared:
        print(f"parallel path: the two-rank checks cannot run: compute mode "
              f"{mode} lets one process hold the card", flush=True)
        return

    # the 2-rank step against the one-process step, view=2 then data=2
    ranks, wall = parity("parity2", "gloo", [["view2", 1, 2],
                                             ["data2", 2, 1]], 2)
    for name, ref, k1 in (("view2", refs[0], 15), ("data2", mean, 25)):
        rel, errs = grad_errors(ref, rank_step(
            ranks[0], name, os.path.join(PARALLEL_DIR, "parity2_rank0.json")))
        assert ranks[0][name]["metrics"] == ranks[1][name]["metrics"], name
        print(f"parallel {name} two ranks vs one process: " + json.dumps({
            "loss_rel_err": rel, "grad_rel_err": errs,
            "k1_launches": [r[name]["counts"]["K1"] for r in ranks]}),
            flush=True)
        assert rel <= TRAIN_LOSS_RTOL, (name, rel)
        assert max(errs.values()) <= TRAIN_GRAD_TOL, (name, errs)
        assert [r[name]["counts"]["K1"] for r in ranks] == [k1, k1], name

    # training through the entry point, 3 steps a run
    for axis, views, k1 in (("view", "[0,1,2]", 15),
                            ("data", "[0,1,2,3,4,5]", 25)):
        exp = os.path.join(REPO, "build", f"chip_smoke_parallel_{axis}")
        argv = conf + ["--mode", "train", "--device", "cuda:0",
                       "--dist_backend", "gloo", "--set",
                       f"base_exp_dir={exp}", f"parallel.{axis}=2",
                       f"train_dataset.ref_view={views}",
                       "train.epochs=1"] + data
        ranks, wall = run_ranks([["--rank-main"] + argv + ["--"]] * 2,
                                f"train_{axis}2")
        zeros = {k: 0 for k in ranks[0]["counts"]}
        for r in ranks:
            assert len(r["train_stats"]) == 3, len(r["train_stats"])
            assert r["counts"] == {**zeros, "K1": 3 * k1}, r["counts"]
            for st in r["train_stats"]:
                bad = [k for k, v in st.items() if not np.isfinite(v)]
                assert not bad, (st["step"], bad)
        assert os.path.exists(os.path.join(exp, "checkpoints",
                                           "model_000.ckpt"))
        print(f"parallel train {axis}=2: " + json.dumps({
            "wall_s": wall,
            "step_ms": [[s["step_s"] * 1e3 for s in r["train_stats"]]
                        for r in ranks],
            "data_wait_ms": [[s["data_wait_s"] * 1e3
                              for s in r["train_stats"]] for r in ranks],
            "k1_launches_per_step": [r["counts"]["K1"] / 3 for r in ranks],
            "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
            "loss": ranks[0]["train_stats"][-1]["loss"]}), flush=True)

    # validation of two DTU items over two ranks, against one process
    val = conf + ["--mode", "val", "--resume", DTU_ARTIFACT, "--set",
                  "val_dataset.ref_view=[23,0]"] + data
    exp = os.path.join(REPO, "build", "chip_smoke_parallel_val")
    ranks, wall = run_ranks(
        [["--rank-main"] + val[:-len(data)] + [
            f"base_exp_dir={exp}", "mesh_resolution=512"] + data
          + ["--device", "cuda:0", "--dist_backend", "gloo", "--"]] * 2,
        "val2")
    one = gens_main(val + [f"base_exp_dir={exp}_one", "mesh_resolution=64"])
    assert len(one.stats) == 2
    zeros = {k: 0 for k in ranks[0]["counts"]}
    for r in ranks:
        assert r["counts"] == {**zeros, **grid_kernels(512)}, r["counts"]
        assert len(r["val_stats"]) == 1
        for k, v in one.metrics.items():
            assert abs(r["metrics"][k] - v) <= VAL_MERGE_RTOL * abs(v), (k, v)
    print("parallel val two ranks: " + json.dumps({
        "wall_s": wall, "k3_launches": [r["counts"]["K3"] for r in ranks],
        "merged": ranks[0]["metrics"], "one_process": one.metrics,
        "per_rank_psnr": [r["val_stats"][0]["psnr"] for r in ranks],
        "phase_s": time.perf_counter() - t_phase}), flush=True)
    del one
    torch.cuda.empty_cache()
    split_val_check(gens_main, conf, data)
    split_finetune_check(tree)
    print(f"parallel path: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# the split render against one process on the same card: the same chunks
# of the same rays through the same kernels
SPLIT_RTOL = 1e-5


def render_rel_err(got: dict, ref: dict, rows=slice(None)) -> float:
    """max |got - ref| / max |ref| over the render's outputs, at ``rows``
    of ``got``."""
    return max(float(np.abs(got[k][rows] - ref[k]).max()
                     / max(float(np.abs(ref[k]).max()), 1e-30))
               for k in ref)


def split_line(ranks, wall: float) -> dict:
    """The per-rank numbers of a split validation's line."""
    def stats(r):
        return (r["val_stats"] or [s for s in r["finetune_stats"]
                                   if "val_step" in s])[-1]

    return {"wall_s": wall,
            **{k: [stats(r).get(k) for r in ranks]
               for k in ("render_s", "rays", "broadcast_bytes",
                         "broadcast_s", "gather_s")},
            "counts": [r["counts"] for r in ranks],
            "peak_mem_gb": [r["peak_mem_gb"] for r in ranks]}


def split_val_check(gens_main, conf, data) -> None:
    """``--mode val`` of one DTU item on two ranks: rank 0 builds, meshes
    and scores it, both render half its chunks. The gathered render
    against a one-process render of rank 0's scene, the metrics against a
    one-process run; K3 on rank 0 only; rank 1 writes nothing. Two
    processes that build the same scene differ by float noise (the
    render within one process does not), so the line also gives the
    one-process run's scene and render against rank 0's."""
    from gens_torch.models.renderer import Scene
    from gens_torch.parallel.render_split import RAY_KEYS, split_render
    from gens_torch.runner import get_dataset

    t0 = time.perf_counter()
    val = conf + ["--mode", "val", "--resume", DTU_ARTIFACT, "--set",
                  "val_dataset.ref_view=[23]", "mesh_resolution=512"] + data
    exp = os.path.join(REPO, "build", "chip_smoke_split_val")
    shutil.rmtree(exp + "_rank1", ignore_errors=True)
    ranks, wall = run_ranks(
        [["--rank-main"] + val + [f"base_exp_dir={exp}{sfx}", "--device",
                                  "cuda:0", "--dist_backend", "gloo", "--"]
         for sfx in ("", "_rank1")], "split_val")
    one = gens_main(val + [f"base_exp_dir={exp}_one", "mesh_resolution=64"])
    out0 = os.path.join(PARALLEL_DIR, "split_val_rank0.json")
    got = dict(np.load(out0 + ".npz"))
    dev = torch.device("cuda")
    saved = torch.load(out0 + ".scene.pt")
    scene = Scene(**{k: [t.to(dev) for t in v] if isinstance(v, list)
                     else v.to(dev) for k, v in saved.items()})
    raw = get_dataset(one.cfg.val_dataset, "val",
                      np.random.RandomState(0))[0]
    with torch.no_grad():
        ref, _ = split_render(one.model.renderer, scene, {
            k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(dev)
            for k in RAY_KEYS})
    err = render_rel_err(got, ref)
    build_err = max(float((a - b.float()).abs().max() / b.float().abs().max())
                    for a, b in zip(one.last_scene.volumes, scene.volumes))
    zeros = {k: 0 for k in ranks[0]["counts"]}
    assert ranks[0]["counts"] == {**zeros, **grid_kernels(512)}, \
        ranks[0]["counts"]
    assert ranks[1]["counts"] == zeros, ranks[1]["counts"]
    assert not os.path.exists(exp + "_rank1"), "rank 1 wrote files"
    (st0,), (st1,) = ranks[0]["val_stats"], ranks[1]["val_stats"]
    assert st0["rays"] + st1["rays"] == 120 * 160, (st0["rays"], st1["rays"])
    assert st0["n_tris"] > 0 and "n_tris" not in st1
    for r in ranks:
        for k, v in one.metrics.items():
            assert abs(r["metrics"][k] - v) <= VAL_MERGE_RTOL * abs(v), (k, v)
    print("parallel split val one item two ranks (time-sliced on one "
          "card): " + json.dumps({
              **split_line(ranks, wall), "render_rel_err": err,
              "two_builds": {"volume_rel_err": build_err,
                             "render_rel_err": render_rel_err(
                                 got, one.last_render)},
              "merged": ranks[0]["metrics"], "one_process": one.metrics,
              "check_s": time.perf_counter() - t0}), flush=True)
    assert err <= SPLIT_RTOL, err
    del one, scene, saved
    torch.cuda.empty_cache()


def split_finetune_check(tree: str) -> None:
    """confs/dtu_finetune.yaml under ``kernel2f`` on two ranks, 2 steps and
    one validation split over both: rank 0 builds the volumes (K2 15),
    steps, saves and meshes (K3 64 at 256³), rank 1 only renders its
    chunks. The split render against a one-process render of rank 0's
    saved state on the first two steps of chunks and the last."""
    from gens_torch.config import load_config
    from gens_torch.data.dtu_finetune import DTUFinetuneDataset
    from gens_torch.models.gens import GenSModel
    from gens_torch.models.renderer import Scene
    from gens_torch.parallel.render_split import RAY_KEYS, split_render
    from gens_torch.train.checkpoint import load_finetune_checkpoint

    t0 = time.perf_counter()
    overrides = [f"finetune_dataset.data_dir={tree}",
                 "model.volume.packed_bilerp=pallas",
                 "model.volume.splat_impl=kernel2f", "train.epochs=2",
                 "mesh_resolution=256"]
    conf = os.path.join(REPO, "confs", "dtu_finetune.yaml")
    exp = os.path.join(REPO, "build", "chip_smoke_split_ft")
    shutil.rmtree(exp, ignore_errors=True)
    shutil.rmtree(exp + "_rank1", ignore_errors=True)
    ranks, wall = run_ranks(
        [["--rank-main", "--conf", conf, "--mode", "finetune", "--resume",
          DTU_ARTIFACT, "--device", "cuda:0", "--dist_backend", "gloo",
          "--set", f"base_exp_dir={exp}{sfx}"] + overrides + ["--"]
         for sfx in ("", "_rank1")], "split_ft")
    zeros = {k: 0 for k in ranks[0]["counts"]}
    assert ranks[0]["counts"] == {**zeros, "K2": 15, **grid_kernels(64)}, \
        ranks[0]["counts"]
    assert ranks[1]["counts"] == zeros, ranks[1]["counts"]
    assert not os.path.exists(exp + "_rank1"), "rank 1 wrote files"
    steps = [s for s in ranks[0]["finetune_stats"] if "loss" in s]
    assert len(steps) == 2 and all(np.isfinite(s["loss"]) for s in steps)
    assert not [s for s in ranks[1]["finetune_stats"] if "loss" in s]
    (v0,) = [s for s in ranks[0]["finetune_stats"] if "val_step" in s]
    (v1,) = ranks[1]["finetune_stats"]
    assert v0["rays"] + v1["rays"] == 288 * 400, (v0["rays"], v1["rays"])
    assert v0["render_finite"] and v0["grid_finite"]

    # one process, rank 0's state at the validated step
    dev = torch.device("cuda")
    cfg = load_config(conf, overrides)
    cfg.mode = "finetune"
    fd = cfg.finetune_dataset
    ckpt = os.path.join(exp, fd.scene[0], f"view{fd.ref_view[0]}",
                        "checkpoints", "model_001.ckpt")
    model = GenSModel(cfg.model).to(dev).eval()
    _, arrays = load_finetune_checkpoint(model, ckpt)
    vols, masks, feats = ([a.to(dev) for a in arrays[k]] for k in (
        "volumes", "mask_volumes", "features"))
    raw = DTUFinetuneDataset(fd, rng=np.random.RandomState(0)).get_rays_at(0)
    inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in raw.items()
              if isinstance(v, np.ndarray) and v.dtype == np.float32}
    view_ids = torch.from_numpy(raw["view_ids"]).to(dev)
    feats = [f.index_select(0, view_ids) for f in feats]
    scene = Scene(volumes=vols, mask_volumes=masks, features=feats,
                  match_features=feats, imgs=inputs["imgs"],
                  intrs=inputs["intrs"], c2ws=inputs["c2ws"])
    got = dict(np.load(os.path.join(PARALLEL_DIR, "split_ft_rank0.json.npz")))
    n, step = inputs["rays_o"].shape[0], 512 * 2
    errs = []
    with torch.no_grad():
        for rows in (slice(0, 2 * step), slice(n - (n % step or step), n)):
            rays = {k: inputs[k][rows] if k.startswith("rays") else inputs[k]
                    for k in RAY_KEYS}
            ref, _ = split_render(model.renderer, scene, rays)
            errs.append(render_rel_err(got, ref, rows))
    print("parallel split finetune two ranks (time-sliced on one card): "
          + json.dumps({**split_line(ranks, wall), "render_rel_err": errs,
                        "step_ms": [s["step_s"] * 1e3 for s in steps],
                        "val_psnr": v0["psnr"], "val_n_tris": v0["n_tris"],
                        "check_s": time.perf_counter() - t0}), flush=True)
    assert max(errs) <= SPLIT_RTOL, errs
    del model, scene, vols, masks, feats, inputs
    torch.cuda.empty_cache()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-main"]:
        # a rank of a parallel run: --rank-main <gens argv...> -- <out>
        sys.path.insert(0, REPO)
        sep = sys.argv.index("--")
        rank_main(sys.argv[2:sep], sys.argv[sep + 1])
    elif sys.argv[1:2] == ["--rank-parity"]:
        sys.path.insert(0, REPO)
        rank_parity(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main())
