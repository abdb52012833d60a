"""The quality protocol's training phases in the port
(gens_torch/eval/quality_train.py, quality_finetune.py) against
scripts/quality_synthetic.py, on the CPU at tiny sizes (32 px, a 32³…2³
cascade, 8+8 samples, 64 rays, a 32³ mesh): the configurations of phases
a, b and ft field by field, the pre-generated batches' sampling laws
(phase b's per-scene counts, seeds and round-robin order; phase ft's
shared ``RandomState(7)``), the JSON's keys and curve rows, interrupted
and resumed runs against uninterrupted ones, the warm start from a JAX
fp16 pickle, every phase end to end with ``--device cpu``, and phase b's
first step against the JAX package's ``make_train_step`` (one JAX
compile; phase ft's against JAX is in tests/test_torch_quality_phases.py).
"""

import dataclasses
import importlib.util
import inspect
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (torch at one thread)
from gens_torch.config import config_to_dict
from gens_torch.convert import params_from_jax, params_to_jax
from gens_torch.eval import quality_finetune as qf
from gens_torch.eval import quality_train as qt
from gens_torch.eval.quality import scene_params
from gens_torch.models.gens import GenSModel as TGenSModel
from gens_torch.train.step import TrainStep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--hw", "32", "--dims", "32", "--samples", "8",
        "--rays", "64", "--mesh-res", "32"]
# the script's metric names (scripts/quality_synthetic.py:559-579, and
# eval_scene's mesh_metrics + psnr)
SCRIPT_KEYS = ("config", "overfit_curve", "overfit_ms_per_step",
               "overfit_compile_s", "overfit_psnr_first",
               "overfit_psnr_last", "overfit_psnr", "overfit_acc_mean",
               "overfit_acc_p50", "overfit_acc_p90", "overfit_comp_mean",
               "overfit_overall", "overfit_verts_raw", "overfit_verts_clean")
# mesh_metrics' keys of a scored mesh (scripts/quality_synthetic.py:134-213)
# and eval_scene's PSNR (:510)
METRIC_KEYS = ("verts_raw", "verts_clean", "verts_bbox", "verts_scored",
               "acc_mean", "acc_p50", "acc_p90", "acc_mean_uncropped",
               "comp_mean", "comp_p90", "overall")
# the script's keys of phase b (:619-621, :633-644), ft (:700, :772-776)
# and eval (:796-808)
PHASE_KEYS = {
    "b": ["gen_curve", "gen_ms_per_step", "gen_compile_s"]
    + [f"{t}_{k}" for t in ("heldout", "heldout_union", "trained")
       for k in METRIC_KEYS + ("psnr",)],
    "ft": ["ft_curve", "ft_ms_per_step", "ft_compile_s"]
    + [f"{t}_{k}" for t in ("ft_init", "ft") for k in METRIC_KEYS],
    "eval": [f"{t}_{k}" for t in ("overfit", "heldout", "heldout_union",
                                  "trained") for k in METRIC_KEYS + ("psnr",)],
}
PORT_KEYS = {"b": ("gen_segments", "gen_k1_launches_per_step",
                   "gen_k3_launches_eval", "gen_steps_done"),
             "ft": ("ft_segments", "ft_k3_launches", "ft_init_volumes_s",
                    "ft_steps_done")}
MODULES = ("feature", "reg", "sdf", "blending", "variance")
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-2


def script():
    """scripts/quality_synthetic.py as a module (it stays unedited)."""
    spec = importlib.util.spec_from_file_location(
        "quality_synthetic", os.path.join(REPO, "scripts",
                                          "quality_synthetic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def walk(a, b, path=""):
    """Every field of ``b`` (the script's config as a dict) equals ``a``'s."""
    if isinstance(b, dict):
        for k in b:
            walk(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, (path, a, b)


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("flags", [[], ["--agg-packed", "pallas", "--bf16"]],
                         ids=["a-table", "a-pallas"])
def test_build_config_is_the_scripts(flags):
    """The port's configuration equals the script's build_config (+ the
    agg_remat and lr_variance_mult of its build_cfg), field by field."""
    args = qt.parse_args(flags)
    cfg = qt.build_cfg(args, args.steps_a)
    ref = script().build_config(args.steps_a, dims=args.dims,
                                samples=args.samples, bf16=args.bf16,
                                agg=args.agg_packed)
    ref.model.volume.agg_remat = args.agg_remat
    ref.train.lr_variance_mult = args.var_lr_mult
    walk(_plain(config_to_dict(cfg)), _plain(dataclasses.asdict(ref)))
    m = cfg.model
    assert tuple(m.volume.volume_dims) == (64, 32, 16, 8, 4)
    assert (m.render.n_samples, m.render.n_importance,
            m.render.n_sparse_pts) == (32, 32, 512)
    assert (cfg.train.epochs, cfg.train.warmup) == (1500, 75)
    bf16 = "--bf16" in flags
    assert (m.volume.dtype == "bfloat16") == bf16
    assert m.volume.packed_bilerp == ("pallas" if bf16 else "table")


def test_pregen_batches_follow_the_scripts_sampling_law():
    """The first batches' pixels, rays and colours, against the script's
    arithmetic (scripts/quality_synthetic.py:326-337) written out here."""
    from gens_torch.data.synthetic import make_scene

    hw, n_rays, seed0 = (32, 40), 64, 10000
    kw = scene_params(1)
    batches, radius = qt.pregen_batches(kw, 3, True, seed0, hw, n_rays, 5,
                                        0.5, torch.device("cpu"))
    base = make_scene(n_views=5, hw=hw, n_rays=n_rays, seed=seed0,
                      spread=0.5, **kw)
    assert radius == base["radius"]
    for b in (0, 2):
        rng = np.random.RandomState((seed0 + 7919 * b) % (2 ** 31))
        px = rng.randint(0, hw[1], size=n_rays).astype(np.float32)
        py = rng.randint(0, hw[0], size=n_rays).astype(np.float32)
        pix = np.stack([px, py, np.ones_like(px)], -1)
        d = pix @ np.linalg.inv(base["intrs"][0]).T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        rd = (d @ base["c2ws"][0][:3, :3].T).astype(np.float32)
        ro = np.broadcast_to(base["c2ws"][0][:3, 3], rd.shape)
        got = batches[b]
        np.testing.assert_array_equal(got["rays_d"].numpy(), rd)
        np.testing.assert_array_equal(got["rays_o"].numpy(), ro)
        np.testing.assert_array_equal(
            got["color"].numpy(),
            base["imgs"][0][py.astype(int), px.astype(int)])
        for k in ("imgs", "intrs", "c2ws", "near", "far"):
            assert got[k] is batches[0][k]  # shared, put on the device once
            np.testing.assert_array_equal(got[k].numpy(), base[k])
        assert got["pseudo_pts"].shape == (512, 3)
        assert got["pseudo_depth"].shape == (n_rays,)
        assert float(got["pseudo_depth"].max()) > 0


def test_json_holds_the_scripts_keys_and_curve_rows(tmp_path, monkeypatch):
    """52 steps (a fixed stand-in for the step's work: the rows' cadence is
    under test, not the training) and the real evaluation: the curve has
    rows at 0, 25, 50 and the last step 51 with the script's keys, and the
    JSON merges in place."""
    from gens_torch.train import step as step_mod

    calls = []

    def stand_in(self, inputs, anneal, use_match_features=False,
                 generator=None, **kw):
        calls.append((anneal, use_match_features,
                      float(torch.rand((), generator=generator))))
        return {k: torch.tensor(float(len(calls))) for k in
                qt.CURVE_KEYS}

    monkeypatch.setattr(step_mod.TrainStep, "__call__", stand_in)
    out = tmp_path / "q.json"
    out.write_text(json.dumps({"earlier_phase": 1}))
    res = qt.main(TINY + ["--steps-a", "52", "--out", str(out),
                          "--runs-dir", str(tmp_path / "runs"),
                          "--ckpt-out", str(tmp_path / "ov.ckpt")])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["earlier_phase"] == 1
    for k in SCRIPT_KEYS:
        assert k in res, k
    curve = res["overfit_curve"]
    assert [r["step"] for r in curve] == [0, 25, 50, 51]
    assert all(set(r) == set(qt.CURVE_KEYS) | {"step"} for r in curve)
    assert res["overfit_psnr_first"] == curve[0]["psnr"] == 1.0
    assert res["overfit_psnr_last"] == 52.0
    # anneal over steps // 4, no match features, step s's draws from seed s
    assert [c[0] for c in calls[:2]] == [0.0, 1 / 13] and calls[13][0] == 1.0
    assert not any(c[1] for c in calls)
    assert calls[5][2] == float(torch.rand(
        (), generator=torch.Generator().manual_seed(5)))
    assert [(g["start"], g["end"]) for g in res["overfit_segments"]] == [
        (0, 52)]
    with open(tmp_path / "ov.ckpt", "rb") as f:
        payload = pickle.load(f)
    assert payload["epoch"] == 0 and payload["step"] == 52
    assert set(payload) == {"epoch", "step", "format_version", "params"}


def test_a_resumed_run_ends_where_an_uninterrupted_one_does(tmp_path):
    """3 steps at once, and 2 steps stopped at an in-flight checkpoint then
    resumed for the third: the same params bit for bit, the same curve."""
    runs = {}
    for name, stops in (("whole", [None]), ("split", [2, None])):
        for stop in stops:
            argv = TINY + ["--steps-a", "3", "--skip-eval",
                           "--out", str(tmp_path / f"{name}.json"),
                           "--runs-dir", str(tmp_path / name),
                           "--ckpt-out", str(tmp_path / f"{name}.ckpt")]
            res = qt.main(argv + ([] if stop is None
                                  else ["--stop-at", str(stop)]))
            if stop is not None:
                assert res["overfit_steps_done"] == stop
                assert not os.path.exists(tmp_path / f"{name}.ckpt")
        with open(tmp_path / f"{name}.ckpt", "rb") as f:
            runs[name] = (pickle.load(f)["params"], res)
    (pw, rw), (ps, rs) = runs["whole"], runs["split"]
    assert [(g["start"], g["end"]) for g in rs["overfit_segments"]] == [
        (0, 2), (2, 3)]
    assert rs["overfit_curve"] == rw["overfit_curve"]
    assert [r["step"] for r in rw["overfit_curve"]] == [0, 2]

    a, b = dict(leaves(pw)), dict(leaves(ps))
    assert a.keys() == b.keys() and len(a) > 50
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("phase", ["b", "ft"])
def test_phase_config_is_the_scripts(phase):
    """build_config + the script's overrides: phase b's at
    scripts/quality_synthetic.py:582-585, phase ft's at :662-667, field by
    field, in the r05 flags."""
    flags = ["--phase", phase, "--dims", "128", "--samples", "64", "--bf16",
             "--agg-packed", "pallas", "--agg-remat", "save_gathers"]
    args = qt.parse_args(flags)
    n = args.steps_b if phase == "b" else args.steps_ft
    ref = script().build_config(n, dims=args.dims, samples=args.samples,
                                bf16=args.bf16, agg=args.agg_packed)
    ref.model.volume.agg_remat = args.agg_remat
    ref.train.lr_variance_mult = args.var_lr_mult
    if phase == "b":
        ref.train.anneal_end = args.steps_b // 8
        ref.train.loss.pseudo_sdf_weight = 1.0
        ref.train.loss.pseudo_depth_weight = 0.05
        cfg = qt.gen_cfg(args)
    else:
        ref.train.anneal_end = max(args.steps_ft // 8, 1)
        ref.train.warmup = 0
        ref.train.loss.sparse_weight = 0.0
        ref.train.loss.smooth_weight = 5e-4
        ref.train.loss.pseudo_depth_weight = 0.0
        cfg = qf.ft_cfg(args)
    walk(_plain(config_to_dict(cfg)), _plain(dataclasses.asdict(ref)))
    t = cfg.train
    assert (t.epochs, t.anneal_end, t.warmup) == (
        (4000, 500, 200) if phase == "b" else (2000, 250, 0))
    assert t.loss.pseudo_sdf_weight == 1.0
    assert t.loss.pseudo_depth_weight == (0.05 if phase == "b" else 0.0)


def test_gen_batches_counts_seeds_and_round_robin(monkeypatch):
    """Per scene ``max(steps_b // n // 4, 8)`` batches with pseudo labels
    from seed ``10000 (i + 1)`` (scripts/quality_synthetic.py:588-592),
    interleaved as at :595-598 (the longest scene's count, each scene's
    list cycled)."""
    calls = []

    def stand_in(kw, n, with_pseudo, seed0, hw, rays, views, spread, dev):
        calls.append((kw, n, with_pseudo, seed0, hw, rays, views, spread))
        return [(seed0, b) for b in range(n)], kw["radius"]

    monkeypatch.setattr(qt, "pregen_batches", stand_in)
    args = qt.parse_args(["--phase", "b", "--steps-b", "8000", "--w", "40",
                          "--hw", "32"])
    batches = qt.gen_batches(args, torch.device("cpu"))
    assert [c[1:4] for c in calls] == [(333, True, 10000 * (i + 1))
                                      for i in range(6)]
    assert [c[0] for c in calls] == [scene_params(i) for i in range(6)]
    assert {c[4:] for c in calls} == {((32, 40), 512, 5, 0.5)}
    assert len(batches) == 333 * 6
    assert batches[:7] == [(10000 * (i + 1), 0) for i in range(6)] + [
        (10000, 1)]
    assert qt.gen_schedule(100, 6) == [(i, 8, 10000 * (i + 1))
                                       for i in range(6)]
    assert qt.interleave([[1, 2, 3], [4]]) == [1, 4, 2, 4, 3, 4]


def test_ft_batches_follow_the_scripts_arithmetic():
    """scripts/quality_synthetic.py:705-735 written out: one RandomState(7)
    draws each batch's px, py, then its 1200 surface samples, batch by
    batch; view b % 3 leads, the views rolled."""
    from gens_torch.data.synthetic import (make_scene, shape_spheres,
                                           shape_surface_samples)

    hw, rays = (24, 32), 48
    kw = scene_params(-2)
    base = make_scene(n_views=3, hw=hw, n_rays=rays, seed=123, spread=0.5,
                      **kw)
    got = qf.ft_batches(base, kw, hw, rays, torch.device("cpu"),
                        n_batches=5)
    prng = np.random.RandomState(7)
    H, W = hw
    intr_inv = np.linalg.inv(base["intrs"][0])
    dist = float(np.linalg.norm(base["c2ws"][0][:3, 3]))
    cc, rr = shape_spheres(kw.get("shape"), base["radius"])
    for b in range(5):
        vid = b % 3
        order = np.roll(np.arange(3), -vid)
        px = prng.randint(0, W, rays).astype(np.float32)
        py = prng.randint(0, H, rays).astype(np.float32)
        pix = np.stack([px, py, np.ones_like(px)], -1)
        d = pix @ intr_inv.T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        c2w = base["c2ws"][vid]
        rays_d = (d @ c2w[:3, :3].T).astype(np.float32)
        rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
        color = base["imgs"][vid][py.astype(int), px.astype(int)]
        spts = shape_surface_samples(cc, rr, 1200, prng)
        spts = np.tile(spts, (-(-512 // len(spts)), 1))[:512]
        want = dict(imgs=base["imgs"][order], intrs=base["intrs"][order],
                    c2ws=base["c2ws"][order], view_ids=order,
                    rays_o=rays_o, rays_d=rays_d, color=color,
                    near=np.full((1, 1), 0.95 * (dist - 1.0), np.float32),
                    far=np.full((1, 1), 1.05 * (dist + 1.0), np.float32),
                    pseudo_pts=spts.astype(np.float32))
        assert set(got[b]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[b][k].numpy(), v, err_msg=k)
    assert got[3]["imgs"] is got[0]["imgs"]  # one stack a view


@pytest.mark.parametrize("phase", ["b", "ft", "all", "eval"])
def test_phase_runs_end_to_end_on_cpu(phase, tmp_path, monkeypatch):
    """``python -m gens_torch.eval.quality_train --phase P --device cpu``
    in a fresh directory (the default checkpoints under runs/): the
    script's keys and the port's, finite curves, the checkpoints in the
    script's layouts. ft and eval start from a phase b checkpoint."""
    monkeypatch.chdir(tmp_path)
    small = ["--steps-a", "2", "--steps-b", "2", "--steps-ft", "2",
             "--n-train-scenes", "2"]
    if phase in ("ft", "eval"):
        qt.main(TINY + small + ["--phase", "b", "--skip-eval",
                                "--out", "b.json"])
    res = qt.main(TINY + small + ["--phase", phase, "--out", "q.json"])
    assert json.loads((tmp_path / "q.json").read_text()) == json.loads(
        json.dumps(res))
    want = {"b": PHASE_KEYS["b"] + list(PORT_KEYS["b"]),
            "ft": PHASE_KEYS["ft"] + list(PORT_KEYS["ft"]),
            "all": SCRIPT_KEYS + tuple(PHASE_KEYS["b"]),
            "eval": [k for k in PHASE_KEYS["eval"]
                     if not k.startswith("overfit")]}[phase]
    # a scene whose mesh is empty after two steps has NaN accuracy and no
    # vertex counts, as in the script's mesh_metrics (:120-121)
    empty = {k[:-len("_acc_mean")] for k, v in res.items()
             if k.endswith("_acc_mean") and not np.isfinite(v)}
    missing = [k for k in want if k not in res and not (
        k.endswith(METRIC_KEYS) and k.rsplit("_", 2)[0] in empty
        or any(k.startswith(e + "_") and k[len(e) + 1:] in METRIC_KEYS
               for e in empty))]
    assert not missing, missing
    for key in ("overfit_curve", "gen_curve", "ft_curve"):
        for row in res.get(key, []):
            assert all(np.isfinite(v) for v in row.values()), (key, row)
    ckpts = {"b": ["quality_gen.ckpt"], "ft": ["quality_ft.ckpt"],
             "all": ["quality_overfit.ckpt", "quality_gen.ckpt"],
             "eval": []}[phase]
    for name in ckpts:
        with open(tmp_path / "runs" / name, "rb") as f:
            payload = pickle.load(f)
        assert payload["epoch"] == 0 and payload["step"] == 2
        params = set(payload["params"])
        assert params == ({"sdf", "blending", "variance", "volumes",
                           "mask_volumes", "features"} if name ==
                          "quality_ft.ckpt" else
                          {"feature", "match_feature", "reg", "sdf",
                           "blending", "variance"}), params
    if phase == "ft":
        assert [r["step"] for r in res["ft_curve"]] == [0, 1]
        assert set(res["ft_curve"][0]) == set(qf.FT_CURVE_KEYS) | {"step"}
        assert not os.path.exists(tmp_path / "runs" / "q_ft_inflight.ckpt")
    if phase == "all":
        assert res["gen_steps_done"] == res["overfit_steps_done"] == 2
    if phase == "b":
        assert res["gen_k1_launches_per_step"] == 0  # the CPU: plain K1
        assert res["gen_k3_launches_eval"] == 0


def test_gen_resumed_run_ends_where_an_uninterrupted_one_does(tmp_path):
    """Phase b for 3 steps at once, and stopped at 2 by --stop-at then
    resumed: the same params bit for bit and the same curve."""
    runs = {}
    for name, stops in (("whole", [None]), ("split", [2, None])):
        for stop in stops:
            argv = TINY + ["--phase", "b", "--steps-b", "3",
                           "--n-train-scenes", "2", "--skip-eval",
                           "--out", str(tmp_path / f"{name}.json"),
                           "--runs-dir", str(tmp_path / name),
                           "--ckpt-out", str(tmp_path / f"{name}.ckpt")]
            res = qt.main(argv + ([] if stop is None
                                  else ["--stop-at", str(stop)]))
        with open(tmp_path / f"{name}.ckpt", "rb") as f:
            runs[name] = (pickle.load(f), res)
    (pw, rw), (ps, rs) = runs["whole"], runs["split"]
    assert [(g["start"], g["end"]) for g in rs["gen_segments"]] == [
        (0, 2), (2, 3)]
    assert rs["gen_curve"] == rw["gen_curve"]
    assert pw["step"] == ps["step"] == 3
    a, b = dict(leaves(pw["params"])), dict(leaves(ps["params"]))
    assert a.keys() == b.keys() and len(a) > 50
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_ft_resumed_run_ends_where_an_uninterrupted_one_does(tmp_path):
    """Phase ft under --bf16 (bfloat16 volumes and Adam moments, kept as
    float32 in the in-flight checkpoint) for 4 steps at once, and stopped
    at 2 then resumed: the same finetune checkpoint bit for bit, the same
    curve, and no in-flight checkpoint left."""
    art = os.path.join(REPO, "artifacts", "quality_gen_r05_sharpen.pkl")
    runs = {}
    for name, stops in (("whole", [None]), ("split", [2, None])):
        for stop in stops:
            argv = TINY + ["--phase", "ft", "--steps-ft", "4", "--bf16",
                           "--agg-packed", "pallas", "--gen-ckpt", art,
                           "--out", str(tmp_path / f"{name}.json"),
                           "--runs-dir", str(tmp_path / name),
                           "--ckpt-out", str(tmp_path / f"{name}.ckpt")]
            res = qt.main(argv + ([] if stop is None
                                  else ["--stop-at", str(stop)]))
        with open(tmp_path / f"{name}.ckpt", "rb") as f:
            runs[name] = (pickle.load(f), res)
        assert not os.path.isdir(tmp_path / name) or not os.listdir(
            tmp_path / name)
    (pw, rw), (ps, rs) = runs["whole"], runs["split"]
    assert [(g["start"], g["end"]) for g in rs["ft_segments"]] == [
        (0, 2), (2, 4)]
    assert rs["ft_curve"] == rw["ft_curve"]
    a, b = dict(leaves(pw["params"])), dict(leaves(ps["params"]))
    assert a.keys() == b.keys() and len(a) > 40
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resume_from_reads_a_jax_fp16_pickle(tmp_path):
    """--resume-from artifacts/quality_gen_r05_sharpen.pkl (the JAX
    package's pickle, float16 leaves): the params start at the exact f32
    widening of the stored ones; an in-flight checkpoint overrides them."""
    from gens_torch.convert import load_checkpoint
    from gens_torch.train.checkpoint import save_params_checkpoint

    art = os.path.join(REPO, "artifacts", "quality_gen_r05_sharpen.pkl")
    payload = load_checkpoint(art)
    stored = dict(leaves(payload["params"]))
    assert {a.dtype for a in stored.values()} == {np.dtype(np.float16)}
    args = qt.parse_args(TINY + ["--phase", "b"])
    cfg = qt.gen_cfg(args)
    torch.manual_seed(0)
    model = TGenSModel(cfg.model)
    run = qt.run_training(model, cfg, [], 0, "gen", torch.device("cpu"),
                          init_params=art)
    assert run["end"] == 0
    got = dict(leaves(params_to_jax(model.state_dict())))
    assert got.keys() == stored.keys()
    for k, v in stored.items():
        np.testing.assert_array_equal(got[k], v.astype(np.float32),
                                      err_msg=k)
    # an in-flight checkpoint of other params wins over the warm start
    torch.manual_seed(1)
    other = TGenSModel(cfg.model)
    step = TrainStep(other, cfg, steps_per_epoch=1)
    inflight = str(tmp_path / "gen_inflight.ckpt")
    qt._save_inflight(inflight, 0, step, [], [])
    model = TGenSModel(cfg.model)
    qt.run_training(model, cfg, [], 0, "gen", torch.device("cpu"),
                    init_params=art, inflight_path=inflight)
    for k, v in other.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    # a port checkpoint warm-starts too
    port = str(tmp_path / "port.ckpt")
    save_params_checkpoint(port, 7, other)
    model = TGenSModel(cfg.model)
    qt.run_training(model, cfg, [], 0, "gen", torch.device("cpu"),
                    init_params=port)
    for k, v in other.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


def leaves(t, path=""):
    for k, v in sorted(t.items()):
        if isinstance(v, dict):
            yield from leaves(v, f"{path}/{k}")
        elif isinstance(v, (list, tuple)):
            for i, a in enumerate(v):
                yield f"{path}/{k}/{i}", a
        else:
            yield f"{path}/{k}", v


def draws(step: int, n_rays: int, n_sparse: int):
    """The JAX key of step ``step`` and the perturb noise and sparse points
    the renderer draws from it (gens_tpu/models/renderer.py:501)."""
    key = jax.random.PRNGKey(step)
    pk, sk = jax.random.split(key)
    noise = np.array(jax.random.uniform(pk, (n_rays, 1)) - 0.5)
    sparse = np.array(jax.random.uniform(sk, (n_sparse, 3), minval=-1.0,
                                         maxval=1.0))
    return key, torch.from_numpy(noise), torch.from_numpy(sparse)


def by_module(grads):
    out = {}
    for name in sorted(grads):
        top = name.split(".")[0]
        if top in MODULES:
            out.setdefault(top, []).append(grads[name].reshape(-1))
    return {k: torch.cat(v) for k, v in out.items()}


def rel(a, b) -> float:
    return float((a - b).norm() / a.norm())


@pytest.fixture(scope="module")
def gen_step():
    """Phase b's first step in both packages from one init (the port's
    seeded one, carried over by params_to_jax) and its first batch: the
    gradient of make_train_step's own loss_fn (gens_tpu/train/step.py:119)
    under one jax.jit, and the port's TrainStep with the JAX key's draws.
    At the geometric init the volume features carry no weight, so the
    JAX step's packed and plain trilerp agree."""
    args = qt.parse_args(TINY + ["--phase", "b", "--steps-b", "64",
                                 "--n-train-scenes", "2"])
    tcfg = qt.gen_cfg(args)
    # scripts/quality_synthetic.py:582-585
    jcfg = script().build_config(args.steps_b, dims=args.dims,
                                 samples=args.samples)
    jcfg.model.volume.agg_remat = args.agg_remat
    jcfg.train.anneal_end = args.steps_b // 8
    jcfg.train.loss.pseudo_sdf_weight = 1.0
    jcfg.train.loss.pseudo_depth_weight = 0.05
    batch = qt.gen_batches(args, torch.device("cpu"))[0]
    torch.manual_seed(0)
    tm = TGenSModel(tcfg.model)
    params = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
    from gens_tpu.models.gens import GenSModel as JGenSModel
    from gens_tpu.train.step import make_train_step

    jm = JGenSModel(jcfg.model)
    _, step_fn = make_train_step(jm, jcfg, steps_per_epoch=1)
    # the step's own loss (gens_tpu/train/step.py:119-126)
    loss_fn = inspect.getclosurevars(step_fn.__wrapped__).nonlocals[
        "loss_fn"]
    key, noise, sparse = draws(0, args.rays, 512)
    grads, jm_metrics = jax.jit(jax.grad(loss_fn, has_aux=True),
                                static_argnums=(4,))(
        params, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, key,
        0.0, False)
    step = TrainStep(tm, tcfg, steps_per_epoch=1)
    metrics = step(batch, 0.0, False, perturb_noise=noise,
                   sparse_pts=sparse)
    port = by_module({n: p.grad for n, p in tm.named_parameters()
                      if p.grad is not None})
    return {"jax": {k: float(v) for k, v in jm_metrics.items()},
            "port": {k: float(v) for k, v in metrics.items()},
            "jax_grads": by_module(params_from_jax(jax.tree.map(
                lambda x: np.asarray(x, np.float32), grads))),
            "port_grads": port}


def test_gen_first_step_losses_match_jax(gen_step):
    jx, pt = gen_step["jax"], gen_step["port"]
    assert jx["pseudo_sdf_loss"] > 0 and jx["pseudo_depth_loss"] > 0
    for k, v in jx.items():
        assert pt[k] == pytest.approx(v, rel=LOSS_RTOL, abs=1e-7), (
            k, pt[k], v)


def test_gen_first_step_gradients_match_jax(gen_step):
    jg, pg = gen_step["jax_grads"], gen_step["port_grads"]
    errs = {k: rel(jg[k], pg[k]) for k in MODULES}
    for k in MODULES:
        assert float(jg[k].norm()) > 0, k
        assert errs[k] <= GRAD_TOL, (k, errs)


