"""Phase a of the quality protocol in the port
(gens_torch/eval/quality_train.py) against scripts/quality_synthetic.py,
on the CPU at tiny sizes (32 px, a 32³…2³ cascade, 8+8 samples, 64 rays, a
32³ mesh): the configuration field by field, the pre-generated batches'
sampling law, the JSON's keys and curve rows, an interrupted and resumed
run against an uninterrupted one, and the refusal of the phases not
ported yet."""

import dataclasses
import importlib.util
import json
import os
import pickle

import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (torch at one thread)
from gens_torch.config import config_to_dict
from gens_torch.eval import quality_train as qt
from gens_torch.eval.quality import scene_params

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


def script():
    """scripts/quality_synthetic.py as a module (it stays unedited)."""
    spec = importlib.util.spec_from_file_location(
        "quality_synthetic", os.path.join(REPO, "scripts",
                                          "quality_synthetic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    got, want = _plain(config_to_dict(cfg)), _plain(dataclasses.asdict(ref))

    def walk(a, b, path=""):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}.{k}")
        else:
            assert a == b, (path, a, b)

    walk(got, want)
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

    def leaves(t, path=""):
        for k, v in sorted(t.items()):
            if isinstance(v, dict):
                yield from leaves(v, f"{path}/{k}")
            else:
                yield f"{path}/{k}", v

    a, b = dict(leaves(pw)), dict(leaves(ps))
    assert a.keys() == b.keys() and len(a) > 50
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("phase", ["b", "ft"])
def test_phases_b_and_ft_are_refused(phase, tmp_path):
    with pytest.raises(SystemExit, match=f"--phase {phase} is not ported"):
        qt.main(TINY + ["--phase", phase, "--out", str(tmp_path / "q.json")])
    assert not os.path.exists(tmp_path / "q.json")
