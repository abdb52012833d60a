"""The port runner's recovery and logging against the JAX runner's
behaviour (tests/test_runner.py, tests/test_checkpoint.py,
tests/test_prefetch.py, tests/test_cli.py): ``latest_checkpoint``, the
SIGTERM guard and ``preempt.ckpt``, ``--resume auto`` past an
``emergency.ckpt``, ``prefetch_map``, ``logs/metrics.jsonl`` and the code
backup, the magma depth colours against matplotlib, and ``python -m
gens_torch.main --conf confs/dtu.yaml`` on a DTU-layout tree on the CPU,
at tiny sizes."""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest

import _torch_common  # noqa: F401  (torch at one thread)
from test_cli import _tiny_overrides
from test_data_loaders import dtu_tree  # noqa: F401

from gens_torch.main import config_from_args, main, parse_args
from gens_torch.runner import Runner
from gens_torch.train.checkpoint import latest_checkpoint, load_checkpoint
from gens_torch.utils.prefetch import prefetch_map


def tiny_runner(tmp, *overrides) -> Runner:
    """A CPU runner on two synthetic scenes at tests/test_cli.py's sizes."""
    cfg = config_from_args(parse_args(
        ["--mode", "train", "--set"] + _tiny_overrides(str(tmp))
        + list(overrides)))
    return Runner(cfg, "cpu")


def records(exp_dir):
    with open(os.path.join(exp_dir, "logs", "metrics.jsonl")) as f:
        return [json.loads(l) for l in f if l.strip()]


# -- latest_checkpoint --------------------------------------------------------


def test_latest_checkpoint_orders(tmp_path):
    """Newest by mtime: a preemption checkpoint written after model_002
    wins, a newer epoch checkpoint beats the stale preempt.ckpt, and
    emergency.ckpt never counts."""
    d = tmp_path / "ckpts"
    assert latest_checkpoint(str(d)) is None
    os.makedirs(d)
    assert latest_checkpoint(str(d)) is None

    def write(name, t):
        (d / name).write_bytes(b"x")
        os.utime(d / name, (t, t))

    for i in (0, 1, 2):
        write(f"model_{i:03d}.ckpt", 1000 + i)
    assert latest_checkpoint(str(d)).endswith("model_002.ckpt")
    write("preempt.ckpt", 1010)
    assert latest_checkpoint(str(d)).endswith("preempt.ckpt")
    write("model_003.ckpt", 1020)
    write("emergency.ckpt", 1030)
    write("notes.txt", 1040)
    assert latest_checkpoint(str(d)).endswith("model_003.ckpt")
    # equal mtimes: the name decides
    write("model_004.ckpt", 1020)
    assert latest_checkpoint(str(d)).endswith("model_004.ckpt")


# -- SIGTERM and preempt.ckpt ------------------------------------------------


@pytest.mark.parametrize("when", ["mid_epoch", "epoch_end"])
def test_sigterm_writes_preempt_ckpt_and_auto_resume_continues(tmp_path,
                                                               when):
    """A SIGTERM sets the guard's flag, not the process's end; the loop
    writes preempt.ckpt at the next check (a log point mid-epoch, recorded
    as epoch - 1; the epoch's end, recorded as that epoch) and returns;
    ``--resume auto`` in a fresh runner continues from it to the end, and
    the previous SIGTERM handler is back after each run."""
    overrides = ("train.epochs=2", "train.save_freq=100")
    if when == "epoch_end":
        overrides += ("train.log_freq=100",)  # batch 0 the only log point
    before = signal.getsignal(signal.SIGTERM)
    runner = tiny_runner(tmp_path, *overrides)
    guard = runner._preempt_guard()
    if when == "mid_epoch":
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested, "SIGTERM did not reach the guard"
    else:
        step = runner._train_step

        def signal_in_second_step(*a, **k):
            out = step(*a, **k)
            if len(runner.train_stats) == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        runner._train_step = signal_in_second_step
    runner.train()
    runner.close()
    assert signal.getsignal(signal.SIGTERM) is before
    ckpt_dir = os.path.join(str(tmp_path), "checkpoints")
    path = latest_checkpoint(ckpt_dir)
    assert path.endswith("preempt.ckpt")
    payload = load_checkpoint(path)
    n_steps = 1 if when == "mid_epoch" else 2
    assert len(runner.train_stats) == n_steps
    assert payload["step"] == n_steps
    assert payload["epoch"] == (-1 if when == "mid_epoch" else 0)

    resumed = tiny_runner(tmp_path, *overrides)
    resumed.train(resume="auto")
    resumed.close()
    assert signal.getsignal(signal.SIGTERM) is before
    start = 0 if when == "mid_epoch" else 1
    assert resumed.start_epoch == start
    stats = resumed.train_stats
    assert [s["epoch"] for s in stats] == [e for e in range(start, 2)
                                           for _ in range(2)]
    assert [s["step"] for s in stats] == list(
        range(n_steps + 1, n_steps + 1 + len(stats)))
    assert latest_checkpoint(ckpt_dir).endswith("model_001.ckpt")


# -- --resume auto past emergency.ckpt ---------------------------------------


def _nan_at_first_step(runner):
    step = runner._train_step

    def nan_step(*a, **k):
        scalars, seconds = step(*a, **k)
        return {**scalars, "loss": float("nan")}, seconds

    runner._train_step = nan_step


@pytest.mark.parametrize("good_first", [False, True])
def test_auto_resume_skips_emergency_ckpt(tmp_path, good_first):
    """A non-finite loss writes emergency.ckpt and raises; ``--resume
    auto`` then starts from the last good checkpoint, or from scratch when
    emergency.ckpt is the only one."""
    ckpt_dir = os.path.join(str(tmp_path), "checkpoints")
    if good_first:
        runner = tiny_runner(tmp_path, "train.epochs=1")
        runner.train()
        runner.close()
        good = latest_checkpoint(ckpt_dir)
        assert good.endswith("model_000.ckpt")
    failing = tiny_runner(tmp_path, "train.epochs=2")
    _nan_at_first_step(failing)
    with pytest.raises(FloatingPointError, match="emergency"):
        failing.train(resume="auto")
    failing.close()
    emergency = os.path.join(ckpt_dir, "emergency.ckpt")
    assert os.path.exists(emergency)
    assert latest_checkpoint(ckpt_dir) == (good if good_first else None)

    resumed = tiny_runner(tmp_path, "train.epochs=2")
    resumed.train(resume="auto")
    resumed.close()
    first = resumed.train_stats[0]
    if good_first:
        assert resumed.start_epoch == 1 and first["step"] == 3
    else:
        assert resumed.start_epoch == 0 and first["step"] == 1
    assert np.isfinite([s["loss"] for s in resumed.train_stats]).all()


# -- prefetch_map -------------------------------------------------------------


def test_prefetch_order_and_plain_map():
    assert list(prefetch_map(lambda x: x * 2, list(range(20)), depth=3)) \
        == [x * 2 for x in range(20)]
    assert list(prefetch_map(lambda x: x + 1, [1, 2, 3], depth=0)) \
        == [2, 3, 4]


def test_prefetch_exception_surfaces_at_its_yield():
    def fn(x):
        if x == 2:
            raise ValueError("boom")
        return x

    it = prefetch_map(fn, [0, 1, 2, 3], depth=2)
    assert next(it) == 0
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_prefetch_draws_in_item_order_and_reaps_its_worker():
    """Items drawing from one shared RandomState get the draws of a plain
    map (one worker), and the worker is gone when the generator is closed
    early."""
    def run(depth):
        rng = np.random.RandomState(0)

        def draw(i):
            time.sleep(0.002 * (i % 3))
            return rng.randint(0, 1 << 30, size=4)

        return np.stack(list(prefetch_map(draw, list(range(8)),
                                          depth=depth)))

    np.testing.assert_array_equal(run(2), run(0))
    before = threading.active_count()
    it = prefetch_map(lambda x: x, list(range(10)), depth=2)
    next(it)
    it.close()
    assert threading.active_count() <= before


# -- magma depth PNGs ---------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_magma_matches_matplotlib(dtype):
    import matplotlib as mpl
    import matplotlib.cm as cm

    from gens_torch.data.image_io import magma

    rng = np.random.RandomState(0)
    d = rng.uniform(-1.0, 3.5, (64, 300)).astype(dtype)
    edges = (np.arange(256) / 256 * 2.5).astype(dtype)
    d[0, :256] = edges
    d[1, :256] = np.nextafter(edges, dtype(-10))
    d[2, :8] = [0.0, 2.5, np.nan, np.inf, -np.inf, -0.0, 1e-30, -1e-30]
    mapper = cm.ScalarMappable(norm=mpl.colors.Normalize(vmin=0.0, vmax=2.5),
                               cmap="magma")
    want = (mapper.to_rgba(d)[:, :, :3] * 255).astype(np.uint8)
    np.testing.assert_array_equal(magma(d, 0.0, 2.5), want)


# -- the CLI on a DTU-layout tree ---------------------------------------------


def test_main_dtu_train_resume_val_on_cpu(dtu_tree, tmp_path):  # noqa: F811
    """``--conf confs/dtu.yaml`` with only the data paths, scenes and
    sizes overridden: train one epoch, ``--resume auto`` a second, then
    ``--mode val``; metrics.jsonl holds every record kind, the package is
    backed up, and the depth PNGs are in colour."""
    from PIL import Image

    root, scan = dtu_tree
    exp = str(tmp_path / "exp")
    model = [o for o in _tiny_overrides(exp) if o.startswith("model.")]
    data = [f"base_exp_dir={exp}", "mesh_resolution=32"]
    for ds, views in (("train_dataset", "[0,1]"), ("val_dataset", "[0]")):
        data += [f"{ds}.data_dir={root}", f'{ds}.scene=["{scan}"]',
                 f"{ds}.ref_view={views}", f"{ds}.img_hw=[64,64]"]
    data += ["train_dataset.num_src_view=2", "train_dataset.n_rays=32",
             "train_dataset.n_pseudo_pts=64"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = ["--conf", os.path.join(repo, "confs", "dtu.yaml"), "--device",
            "cpu"]
    runner = main(base + ["--mode", "train", "--set"] + model + data
                  + ["train.epochs=1"])
    assert runner.cfg.train_dataset.dataset_name == "dtu"
    assert [s["step"] for s in runner.train_stats] == [1, 2]
    assert all(np.isfinite(s["loss"]) and s["decode_s"] > 0
               for s in runner.train_stats)
    runner = main(base + ["--mode", "train", "--resume", "auto", "--set"]
                  + model + data + ["train.epochs=2"])
    assert runner.start_epoch == 1
    assert [s["step"] for s in runner.train_stats] == [3, 4]
    ckpt = os.path.join(exp, "checkpoints", "model_001.ckpt")
    runner = main(base + ["--mode", "val", "--resume", ckpt, "--set"]
                  + model + data)
    (st,) = runner.stats
    assert st["scene"] == scan and st["grid_finite"] and st["render_finite"]
    assert np.isfinite(runner.metrics["psnr"])
    kinds = [r["mode"] for r in records(exp)]
    assert kinds.count("train") == 4 and kinds.count("train_avg") == 2
    # confs/dtu.yaml validates every 2 epochs: once in training, once in
    # val mode
    assert kinds.count("val") == 2 and kinds.count("val_avg") == 2
    val = [r for r in records(exp) if r["mode"] == "val_avg"][-1]
    assert val["step"] == 1 and val["psnr"] == runner.metrics["psnr"]
    assert os.path.isfile(os.path.join(exp, "codes_recording", "gens_torch",
                                       "runner.py"))
    name = f"{scan}_view0_light3_epoch1.png"
    for sub in ("val_render_depth", "val_sdf_depth"):
        with Image.open(os.path.join(exp, sub, name)) as im:
            assert im.mode == "RGB" and im.size == (16, 16)
