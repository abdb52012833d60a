"""The port's multi-process training and validation on the CPU, in gloo
groups of separate processes (tests/_torch_mp_worker.py and ``python -m
gens_torch.main``, torch only): rank detection and the epoch order against
the JAX package, ``pad_views`` against its JAX counterpart, each collective
Function against the one-process math, the sharded step at (data, view) =
(1, 2), (2, 1) and (2, 2) against the port's one-process step (which
tests/test_torch_train.py holds to the JAX ``make_train_step``), a SIGTERM
to one rank, and a validation split over two ranks.

The slow test pins the JAX sharded step's gradient scale (ROADMAP §C)."""

import ast
import os
import pickle
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (torch at one thread)
from _torch_common import tiny_configs
from test_cli import _tiny_overrides
from test_data_loaders import dtu_tree  # noqa: F401

import gens_tpu.parallel.distributed as jdist
from gens_torch.data.synthetic import SyntheticDataset as TData
from gens_torch.main import main
from gens_torch.models.gens import GenSModel
from gens_torch.parallel import distributed as tdist
from gens_torch.parallel.sharded import pad_views
from gens_torch.runner import epoch_order, materialize_schema
from gens_torch.train.step import TrainStep, make_optimizer
from gens_torch.utils.preemption import PreemptionGuard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mp_worker.py")
GROUPS = ("feature", "reg", "sdf", "blending", "variance")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _spawn(cmd, log, env):
    """A rank with its output in the file ``log`` (``.log`` on the
    process)."""
    with open(log, "wb") as f:
        p = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=f,
                             stderr=subprocess.STDOUT)
    p.log = log
    return p


def _finish(procs, timeout=180):
    """Wait for every rank; a failed rank fails the test and the others
    are killed. Returns their output."""
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.returncode not in (None, 0)]
            assert not bad and time.time() < deadline, [
                p.returncode for p in procs]
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = [open(p.log, errors="replace").read() for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    return logs


# -- rank detection, layout, padding, order -----------------------------------


ENVS = {
    "single": {},
    "env_vars": {"RANK": "3", "WORLD_SIZE": "8",
                 "COORDINATOR_ADDRESS": "10.0.0.1:1234"},
    "torchrun": {"RANK": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "hostA",
                 "MASTER_PORT": "5555", "LOCAL_RANK": "1"},
    "slurm": {"SLURM_PROCID": "2", "SLURM_NTASKS": "4",
              "SLURM_NODELIST": "node[3-7],node9", "SLURM_LOCALID": "0"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_detect_process_env_matches_jax(name, monkeypatch):
    """The env sets of tests/test_distributed.py through both functions."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "COORDINATOR_ADDRESS",
              "MASTER_ADDR", "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS",
              "SLURM_NODELIST", "SLURM_LOCALID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[name].items():
        monkeypatch.setenv(k, v)
    want = jdist.detect_process_env(default_port=999)
    got = tdist.detect_process_env(default_port=999)
    assert (got.rank, got.world_size, got.coordinator) == (
        want.rank, want.world_size, want.coordinator)
    assert got.is_distributed == want.is_distributed
    local = {"single": 0, "env_vars": 3, "torchrun": 1, "slurm": 0}[name]
    assert tdist.detect_local_rank(got) == local


def test_device_rule():
    """A bare "cuda" is the local rank's card, which must exist; a named
    device is shared only on request."""
    assert tdist.rank_device("cuda", 1, 2) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="no card of its own"):
        tdist.rank_device("cuda", 1, 1)
    assert tdist.rank_device("cuda:0", 3, 1) == torch.device("cuda", 0)
    assert tdist.rank_device("cpu", 5, 0) == torch.device("cpu")
    assert tdist.default_backend(torch.device("cuda", 0)) == "nccl"
    assert tdist.default_backend(torch.device("cpu")) == "gloo"


def test_layout_and_single_process_helpers():
    lay = tdist.RankLayout(n_data=2, n_view=3, rank=4)
    assert (lay.data_row, lay.view_col) == (1, 1)
    assert tdist.process_count() == 1 and tdist.is_main_process()
    np.testing.assert_array_equal(tdist.allreduce_host_sums([2.0, 3.5]),
                                  [2.0, 3.5])
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tdist.make_layout(2, 2)
    with PreemptionGuard() as guard:
        assert not guard.requested_global()
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested_global()


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pad_views_matches_jax(n_shards):
    from gens_tpu.parallel.sharded import pad_views as j_pad_views

    rng = np.random.RandomState(0)
    item = {"imgs": rng.rand(3, 8, 10, 3).astype(np.float32),
            "intrs": rng.rand(3, 3, 3).astype(np.float32),
            "c2ws": rng.rand(3, 4, 4).astype(np.float32)}
    want, n_want = j_pad_views({k: v[None] for k, v in item.items()},
                               n_shards)
    got, n_got = pad_views({k: torch.from_numpy(v) for k, v in item.items()},
                           n_shards)
    assert n_got == n_want == 3
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v[0])


@pytest.mark.parametrize("n,n_data", [(5, 1), (5, 2), (3, 4), (6, 3),
                                      (2, 5)])
def test_epoch_order_matches_jax_runner(n, n_data):
    """gens_tpu/runner.py:420-428 on the same RandomState: the wrapped
    order, and a rank's share (every n_data-th item from its row)."""
    rng = np.random.RandomState(7)
    steps_per_epoch = max(-(-n // n_data), 1)
    need = steps_per_epoch * n_data
    reps = -(-need // n)
    want = np.concatenate([rng.permutation(n) for _ in range(reps)])[:need]
    got = epoch_order(np.random.RandomState(7), n, n_data)
    np.testing.assert_array_equal(got, want)
    for row in range(n_data):
        np.testing.assert_array_equal(
            got[row::n_data], [want[b * n_data + row]
                               for b in range(steps_per_epoch)])
    # one data row: the one-device runner's permutation
    if n_data == 1:
        np.testing.assert_array_equal(
            got, np.random.RandomState(7).permutation(n))


@pytest.mark.parametrize("has_pseudo", [True, False])
def test_materialize_schema_matches_jax(has_pseudo):
    from gens_tpu.runner import Runner as JRunner

    item = {"rays_o": np.zeros((6, 3), np.float32)}
    if has_pseudo:
        item["pseudo_pts"] = np.ones((4, 3), np.float32)
        item["pseudo_depth"] = np.ones(6, np.float32)
    want = JRunner._materialize_schema(None, dict(item), True, 4)
    got = materialize_schema(dict(item), True, 4)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.float32
    assert materialize_schema(item, False, 4) is item


# -- the sharded step in gloo groups ------------------------------------------


CASES = {  # name: (n_data, n_view, packed_bilerp, collectives)
    "data1_view2_pallas": (1, 2, "pallas", True),
    "data2_view1": (2, 1, "table", False),
    "data2_view2": (2, 2, "table", False),
}


def _case_cfg(packed_bilerp):
    _, cfg = tiny_configs()
    # pallas: K1's route at the 32³ and 16³ scales, its plain version here
    cfg.model.volume.packed_bilerp = packed_bilerp
    return cfg


def _one_process(cfg, state, batch, noise, sparse, anneal=0.5):
    model = GenSModel(cfg.model)
    model.load_state_dict(state)
    step = TrainStep(model, cfg, 1)
    m = step({k: torch.from_numpy(v) for k, v in batch.items()}, anneal,
             perturb_noise=torch.from_numpy(noise),
             sparse_pts=torch.from_numpy(sparse))
    return ({k: float(v) for k, v in m.items()},
            {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None})


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """Every case launched at once (8 ranks), the one-process references
    computed while they run."""
    tmp = tmp_path_factory.mktemp("sharded")
    data = TData(2, 3, (64, 64), n_rays=32, n_pseudo_pts=64, mode="train")
    batches = [{k: v for k, v in data[i].items()
                if isinstance(v, np.ndarray) and v.dtype == np.float32}
               for i in range(2)]
    rng = np.random.RandomState(11)
    noise = [(rng.rand(32, 1) - 0.5).astype(np.float32) for _ in range(2)]
    sparse = [rng.uniform(-1, 1, (64, 3)).astype(np.float32)
              for _ in range(2)]
    torch.manual_seed(0)
    launched = {}
    for name, (n_data, n_view, packed, coll) in CASES.items():
        cfg = _case_cfg(packed)
        state = GenSModel(cfg.model).state_dict()
        payload = tmp / f"{name}.pkl"
        with open(payload, "wb") as f:
            pickle.dump({"n_data": n_data, "n_view": n_view, "cfg": cfg,
                         "state": state, "batches": batches[:n_data],
                         "noise": noise, "sparse": sparse, "anneal": 0.5,
                         "collectives": coll}, f)
        world, port = n_data * n_view, _free_port()
        outs = [tmp / f"{name}_rank{r}.pkl" for r in range(world)]
        procs = [_spawn([sys.executable, WORKER, str(r), str(world),
                         str(port), str(payload), str(outs[r])],
                        tmp / f"{name}_rank{r}.log", _env())
                 for r in range(world)]
        launched[name] = (cfg, state, procs, outs)
    results = {}
    for name, (cfg, state, procs, outs) in launched.items():
        n_data = CASES[name][0]
        refs = [_one_process(cfg, state, batches[d], noise[d], sparse[d])
                for d in range(n_data)]
        metrics = {k: float(np.mean([r[0][k] for r in refs]))
                   for k in refs[0][0]}
        grads = {k: sum(r[1][k] for r in refs) / n_data for k in refs[0][1]}
        # the one-device update on the mean gradient
        model = GenSModel(cfg.model)
        model.load_state_dict(state)
        opt, _ = make_optimizer(model, cfg.train, 1)
        for k, p in model.named_parameters():
            p.grad = grads.get(k)
        opt.step()
        results[name] = {"metrics": metrics, "grads": grads,
                         "params": {k: p.detach().clone() for k, p in
                                    model.named_parameters()}}
    for name, (cfg, state, procs, outs) in launched.items():
        _finish(procs)
        ranks = []
        for o in outs:
            with open(o, "rb") as f:
                ranks.append(pickle.load(f))
        results[name]["ranks"] = ranks
    return results


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_one_process(sharded_runs, case):
    """Loss (and every term) within rtol 1e-5; each module's gradient
    within 1e-4 in relative norm of the one-process gradient (with two
    data rows the mean of the two scenes'); the updated parameters within
    rtol 1e-2, atol 1e-4 of the one-device update, and equal on every
    rank."""
    res = sharded_runs[case]
    ranks = res["ranks"]
    for k, v in res["metrics"].items():
        for r in ranks:
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5,
                                       atol=1e-8, err_msg=k)
    got = ranks[0]["grads"]
    assert set(got) == set(res["grads"])
    for top in GROUPS:
        keys = [k for k in got if k.split(".")[0] == top]
        a = torch.cat([res["grads"][k].reshape(-1) for k in keys])
        b = torch.cat([torch.from_numpy(got[k]).reshape(-1) for k in keys])
        err = float((a - b).norm() / a.norm())
        assert err <= 1e-4, (top, err)
    for k, want in res["params"].items():
        for r in ranks:
            np.testing.assert_array_equal(r["params"][k],
                                          ranks[0]["params"][k])
        np.testing.assert_allclose(ranks[0]["params"][k], want.numpy(),
                                   rtol=1e-2, atol=1e-4, err_msg=k)


def test_collectives_match_one_process_math(sharded_runs):
    """Forward and backward of each collective Function in a two-rank
    group, against the sums and slices they stand for (float64)."""
    col = [r["collectives"] for r in sharded_runs["data1_view2_pallas"][
        "ranks"]]
    for name in ("all_reduce_sum", "all_gather_views", "share_sum"):
        x = [c[name]["x"] for c in col]
        ct = [c[name]["ct"] for c in col]
        want_y = (np.concatenate(x) if name == "all_gather_views"
                  else x[0] + x[1])
        for r in range(2):
            np.testing.assert_allclose(col[r][name]["y"], want_y, rtol=1e-12)
            if name == "all_reduce_sum":
                want_g = ct[0] + ct[1]
            elif name == "all_gather_views":
                want_g = (ct[0] + ct[1])[3 * r:3 * (r + 1)]
            else:
                want_g = ct[r]
            np.testing.assert_allclose(col[r][name]["grad"], want_g,
                                       rtol=1e-12, err_msg=name)


# -- the entry point on two ranks ---------------------------------------------


def _launch_main(argvs, logs):
    """``python -m gens_torch.main --device cpu`` on len(argvs) ranks, set
    up by env vars as a launcher would."""
    port = _free_port()
    world = len(argvs)
    return [_spawn(
        [sys.executable, "-m", "gens_torch.main", "--device", "cpu"] + argv,
        logs / f"rank{r}.log",
        _env(RANK=r, WORLD_SIZE=world, LOCAL_RANK=r,
             MASTER_ADDR="localhost", MASTER_PORT=port))
        for r, argv in enumerate(argvs)]


def test_sigterm_to_one_rank_stops_every_rank(tmp_path):
    """SIGTERM to rank 1 (which writes nothing): the ranks agree at the
    next log point, rank 0 writes the one preempt.ckpt, and both stop
    cleanly."""
    argv = (["--mode", "train", "--set"] + _tiny_overrides(str(tmp_path))
            + ["parallel.view=2", "train.epochs=50"])
    procs = _launch_main([argv, argv], tmp_path)
    deadline = time.time() + 120
    while "[train] epoch 0 step 1:" not in open(procs[0].log).read():
        assert time.time() < deadline and procs[0].poll() is None
        time.sleep(0.05)
    procs[1].send_signal(signal.SIGTERM)
    logs = _finish(procs, timeout=120)
    for log in logs:
        assert "preemption checkpoint saved" in log, log[-2000:]
    ckpts = os.listdir(tmp_path / "checkpoints")
    assert ckpts.count("preempt.ckpt") == 1
    assert not [c for c in ckpts if c.endswith(".tmp")]


def test_two_rank_val_splits_scenes_and_merges(dtu_tree,  # noqa: F811
                                                tmp_path):
    """Two ranks validate two reference views of a DTU-layout scan under
    confs/dtu.yaml: each renders its own (rank r's experiment directory
    holds item r's images only), and both report the one-process means of
    the two items' metrics (as the entry point prints them, to 6
    decimals)."""
    root, scan = dtu_tree
    _, cfg = tiny_configs()
    torch.manual_seed(0)
    model = GenSModel(cfg.model)
    from gens_torch.train.checkpoint import save_checkpoint

    ckpt = str(tmp_path / "model.ckpt")
    save_checkpoint(ckpt, 0, 0, model, make_optimizer(model, cfg.train, 1)[0])
    common = [o for o in _tiny_overrides("") if o.startswith("model.")] + [
        "mesh_resolution=32", f"val_dataset.data_dir={root}",
        f'val_dataset.scene=["{scan}"]', "val_dataset.ref_view=[0,1]",
        "val_dataset.img_hw=[64,64]"]
    argvs = [["--conf", os.path.join(REPO, "confs", "dtu.yaml"), "--mode",
              "val", "--resume", ckpt, "--set",
              f"base_exp_dir={tmp_path / name}"] + common
             for name in ("rank0", "rank1", "one")]
    procs = _launch_main(argvs[:2], tmp_path)
    one = main(argvs[2] + ["--device", "cpu"])
    logs = _finish(procs)
    assert one.stats[0]["psnr"] != one.stats[1]["psnr"]
    rendered = [sorted(os.listdir(tmp_path / f"rank{r}" / "val_img"))
                for r in range(2)]
    assert len(rendered[0]) == len(rendered[1]) == 1, rendered
    assert sorted(rendered[0] + rendered[1]) == sorted(
        os.listdir(tmp_path / "one" / "val_img"))
    for log in logs:
        merged = ast.literal_eval(log.strip().splitlines()[-1])
        assert merged == {k: round(v, 6) for k, v in one.metrics.items()}


# -- the reference's gradient scale (slow: the JAX sharded compile) -----------


@pytest.mark.slow
def test_jax_sharded_gradient_is_data_times_view_the_ports(tmp_path,
                                                           monkeypatch):
    """On the 2x2 virtual mesh, with the update swapped for sgd(1.0) (so
    the update is -g), the JAX sharded step's gradient is data x view = 4
    times the port's sharded gradient, and the port's equals the
    one-device gradient (same scene on both data rows, no perturbation,
    sparse weight 0 as tests/test_sharded.py)."""
    import jax
    import jax.numpy as jnp
    import optax

    import gens_tpu.parallel.sharded as jsharded
    from gens_tpu.data.synthetic import make_scene
    from gens_tpu.models.gens import GenSModel as JGenSModel
    from gens_torch.convert import params_from_jax

    from _torch_common import jax_init_params, to_np_tree
    from test_torch_train import GRAD_TOL

    jcfg, tcfg = tiny_configs()
    for c in (jcfg, tcfg):
        c.model.render.perturb = 0.0
        c.train.loss.sparse_weight = 0.0
    params = jax_init_params(0)
    scene = make_scene(n_views=3, hw=(64, 64), n_rays=32)
    batch = {k: v for k, v in scene.items()
             if isinstance(v, np.ndarray) and v.dtype == np.float32}
    monkeypatch.setattr(jsharded, "make_optimizer",
                        lambda *a, **k: optax.sgd(1.0))
    jm = JGenSModel(jcfg.model)
    mesh = jsharded.make_mesh(2, 2, jax.devices("cpu")[:4])
    jb = {k: jnp.stack([jnp.asarray(v)] * 2) for k, v in batch.items()}
    jb, n_views = jsharded.pad_views(jb, 2)
    step = jsharded.make_sharded_train_step(jm, jcfg, mesh, n_views=n_views)
    from gens_tpu.train.step import TrainState

    state = TrainState(params, optax.sgd(1.0).init(params), jnp.asarray(0))
    new, _ = step(state, jb, jax.random.PRNGKey(7), 1.0, False)
    j_grad = params_from_jax(to_np_tree(jax.tree.map(
        lambda a, b: a - b, params, new.params)))

    state = params_from_jax(to_np_tree(params))
    payload = tmp_path / "p.pkl"
    zeros = np.zeros((32, 1), np.float32)
    with open(payload, "wb") as f:
        pickle.dump({"n_data": 2, "n_view": 2, "cfg": tcfg, "state": state,
                     "batches": [batch, batch], "noise": [zeros, zeros],
                     "sparse": [np.zeros((64, 3), np.float32)] * 2,
                     "anneal": 1.0, "collectives": False}, f)
    port, outs = _free_port(), [tmp_path / f"r{r}.pkl" for r in range(4)]
    procs = [_spawn([sys.executable, WORKER, str(r), "4", str(port),
                     str(payload), str(outs[r])], tmp_path / f"r{r}.log",
                    _env()) for r in range(4)]
    _finish(procs, timeout=300)
    with open(outs[0], "rb") as f:
        t_grad = {k: torch.from_numpy(v) for k, v in
                  pickle.load(f)["grads"].items()}
    _, one = _one_process(tcfg, state, batch, zeros,
                          np.zeros((64, 3), np.float32), anneal=1.0)
    for top in GROUPS:
        keys = [k for k in t_grad if k.split(".")[0] == top]
        a = torch.cat([one[k].reshape(-1) for k in keys])
        b = torch.cat([t_grad[k].reshape(-1) for k in keys])
        j = torch.cat([j_grad[k].reshape(-1) for k in keys])
        assert float((a - b).norm() / a.norm()) <= 1e-4, top
        # the JAX sharded gradient is data x view times the port's: the
        # least-squares scale, and the residual at that scale
        scale = float(j @ b / (b @ b))
        err = float((j / 4 - b).norm() / b.norm())
        print(f"{top}: JAX sharded / port sharded = {scale:.4f}, "
              f"residual {err:.2e}")
        assert abs(scale / 4 - 1) <= GRAD_TOL[top], (top, scale)
        assert err <= GRAD_TOL[top], (top, err)
