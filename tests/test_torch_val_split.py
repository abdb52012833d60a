"""A scene's validation render split over a group of ranks, on the CPU in
gloo groups of separate processes (tests/_torch_val_split_worker.py, torch
only): the validation's partition into groups, the chunk layout against
the devices of the JAX ``Runner._render_chunked``'s ``shard_map``, a 2- and
a 3-rank split render against the one-process render bit for bit and
against the JAX render over 8 host devices, and ``python -m
gens_torch.main`` on two ranks in ``--mode val`` of one DTU-layout item and
in ``--mode finetune`` against one process."""

import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (torch at one thread)
from _torch_common import scene_numpy, tiny_configs, tiny_models
from test_data_loaders import dtu_tree  # noqa: F401
from test_torch_finetune import TINY_FT
from test_torch_parallel import _env, _finish, _free_port, _spawn

from gens_torch.data.synthetic import SyntheticDataset as TData
from gens_torch.main import main
from gens_torch.models.gens import GenSModel
from gens_torch.parallel.distributed import val_partition
from gens_torch.parallel.render_split import (RAY_KEYS, RENDER_KEYS,
                                              chunk_rows, render_chunk)
from gens_torch.runner import Runner
from gens_torch.train.checkpoint import save_checkpoint
from gens_torch.train.step import make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_val_split_worker.py")
CHUNK = 64
N_RAYS = 300  # 2 ranks: 384 padded rows, 3 ranks: 384, 8 devices: 512


# -- the partition and the chunk layout ---------------------------------------


@pytest.mark.parametrize("world", [1, 2, 3, 8])
@pytest.mark.parametrize("n_scenes", [1, 2, 3, 15])
def test_val_partition(world, n_scenes):
    """Every rank in one group of contiguous ranks, every scene in one
    group, group sizes within one of each other; with at least as many
    scenes as ranks, the round-robin of one rank a group (the JAX
    ``validate``'s ``range(process_index(), n, process_count())``)."""
    groups = val_partition(world, n_scenes)
    assert len(groups) == min(world, n_scenes)
    ranks = [r for rs, _ in groups for r in rs]
    assert ranks == list(range(world))
    assert sorted(s for _, ss in groups for s in ss) == list(range(n_scenes))
    sizes = [len(rs) for rs, _ in groups]
    assert max(sizes) - min(sizes) <= 1
    if n_scenes >= world:
        assert groups == [((r,), tuple(range(r, n_scenes, world)))
                          for r in range(world)]


def _owner_model(n_dev):
    """A stand-in model whose render returns, per ray, the ray's index
    (``color_fine``, from rays_o) and the device that rendered it
    (``sdf_depth``)."""
    def render(params, ro, rd, near, far, scene, **kw):
        r = ro.shape[0]
        dev = jax.lax.axis_index("rays") if n_dev > 1 else 0
        z = jnp.zeros((r, 1))
        return {"color_fine": ro, "gradients": jnp.zeros((r, 1, 3)),
                "weights": z, "inside_sphere": z,
                "sdf_depth": jnp.full((r,), dev, jnp.float32),
                "render_depth": z[:, 0]}

    return types.SimpleNamespace(renderer=types.SimpleNamespace(
        render=render))


@pytest.mark.parametrize("size", [1, 2, 3, 8])
def test_chunk_rows_match_jax_devices(size, monkeypatch):
    """``chunk_rows`` of rank j against the device that renders each ray
    in ``gens_tpu.runner.Runner._render_chunked`` over ``size`` devices,
    and the padded length (the rows every call of the chunk function
    takes)."""
    from gens_tpu.runner import Runner as JRunner

    devices = jax.local_devices()
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k:
                        devices[:size])
    runner = JRunner.__new__(JRunner)
    runner._jit_cache = {}
    runner.model = _owner_model(size)
    real, rows_seen = runner._render_chunk_jit, []

    def recording(chunk):
        fn = real(chunk)

        def call(params, scene, ro, rd, near, far):
            rows_seen.append(ro.shape[0])
            return fn(params, scene, ro, rd, near, far)
        return call

    runner._render_chunk_jit = recording
    n, chunk = N_RAYS, 32
    ro = np.zeros((n, 3), np.float32)
    ro[:, 0] = np.arange(n)
    out = runner._render_chunked(None, None, {
        "rays_o": ro, "rays_d": ro, "near": jnp.zeros((1, 1)),
        "far": jnp.ones((1, 1))}, chunk=chunk)
    np.testing.assert_array_equal(out["color_fine"][:, 0], np.arange(n))
    owner = np.full(n, -1)
    padded = []
    for j in range(size):
        rows = chunk_rows(n, chunk, size, j)
        padded.append(rows)
        owner[rows[rows < n]] = j
    np.testing.assert_array_equal(np.sort(np.concatenate(padded)),
                                  np.arange(sum(rows_seen)))
    np.testing.assert_array_equal(out["sdf_depth"], owner)


# -- the split render in gloo groups ------------------------------------------


def _plain_chunked(model, scene, rays, chunk):
    """The one-process chunked render written out: the rays padded with
    copies of the last to a multiple of ``chunk``, chunk by chunk."""
    n = rays["rays_o"].shape[0]
    pad = (-n) % chunk
    ro, rd = (torch.cat([rays[k], rays[k][-1:].expand(pad, 3)])
              for k in ("rays_o", "rays_d"))
    outs = {k: [] for k in RENDER_KEYS}
    for i in range(0, n + pad, chunk):
        out = render_chunk(model.renderer, scene, ro[i:i + chunk],
                           rd[i:i + chunk], rays["near"], rays["far"])
        for k in RENDER_KEYS:
            outs[k].append(out[k].float())
    return {k: torch.cat(v)[:n].numpy() for k, v in outs.items()}


def _split_scenes():
    """Scene A (make_scene's 300 rays, which the JAX render also takes)
    and scene B (a synthetic val item's 16 x 16 grid)."""
    s = scene_numpy(n_rays=N_RAYS)
    a = {k: s[k] for k in ("imgs", "intrs", "c2ws") + RAY_KEYS}
    v = TData(2, 3, (64, 64), val_res_level=4)[1]
    b = {k: np.ascontiguousarray(v[k]) for k in ("imgs", "intrs", "c2ws")
         + RAY_KEYS}
    return [a, b]


def _launch_render(tmp, name, world, runs, state, cfg):
    """``world`` worker ranks, one scene list a run."""
    payload = tmp / f"{name}.pkl"
    with open(payload, "wb") as f:
        pickle.dump({"cfg": cfg, "state": state, "chunk": CHUNK,
                     "runs": runs}, f)
    port = _free_port()
    outs = [tmp / f"{name}_rank{r}.pkl" for r in range(world)]
    procs = [_spawn([sys.executable, WORKER, "render", str(r), str(world),
                     str(port), str(payload), str(outs[r])],
                    tmp / f"{name}_rank{r}.log", _env())
             for r in range(world)]
    return procs, outs


def _launch_main(tmp, name, argvs):
    """``gens_torch.main --device cpu`` on len(argvs) worker ranks."""
    port, world = _free_port(), len(argvs)
    outs = [tmp / f"{name}_rank{r}.pkl" for r in range(world)]
    procs = [_spawn([sys.executable, WORKER, "main", str(outs[r]),
                     "--device", "cpu"] + argv, tmp / f"{name}_rank{r}.log",
                    _env(RANK=r, WORLD_SIZE=world, LOCAL_RANK=r,
                         MASTER_ADDR="localhost", MASTER_PORT=port))
             for r, argv in enumerate(argvs)]
    return procs, outs


def _load(outs):
    res = []
    for o in outs:
        with open(o, "rb") as f:
            res.append(pickle.load(f))
    return res


def _checkpoint(path):
    _, cfg = tiny_configs()
    torch.manual_seed(0)
    model = GenSModel(cfg.model)
    save_checkpoint(str(path), 0, 0, model,
                    make_optimizer(model, cfg.train, 1)[0])
    return str(path)


def _val_argvs(tmp, root, scan, ckpt):
    common = [o for o in TINY_FT if o.startswith("model.")] + [
        "mesh_resolution=32", f"val_dataset.data_dir={root}",
        f'val_dataset.scene=["{scan}"]', "val_dataset.ref_view=[0]",
        "val_dataset.img_hw=[128,160]"]  # 32 x 40 val rays: 3 chunks
    return [["--conf", os.path.join(REPO, "confs", "dtu.yaml"), "--mode",
             "val", "--resume", ckpt, "--set",
             f"base_exp_dir={tmp / name}"] + common
            for name in ("val_rank0", "val_rank1", "val_one")]


def _ft_argvs(tmp, ckpt):
    # 32 x 32 val rays: 2 chunks
    return [["--mode", "finetune", "--resume", ckpt, "--scene", "s0",
             "--ref_view", "4", "--set", f"base_exp_dir={tmp / name}"]
            + TINY_FT + ["train.epochs=2", "train.val_freq=1",
                         "finetune_dataset.val_res_level=2"]
            for name in ("ft_rank0", "ft_rank1", "ft_one")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, dtu_tree):  # noqa: F811
    """Every group launched at once (10 ranks): the split render on 2
    ranks (scene A) and on 3 (scene A, then A and B over the groups [0],
    [1, 2]); ``--mode val`` and ``--mode finetune`` on 2 ranks. The
    one-process references are computed while they run."""
    tmp = tmp_path_factory.mktemp("val_split")
    root, scan = dtu_tree
    _, _, _, tcfg, tm = tiny_models()
    state = tm.state_dict()
    scenes = _split_scenes()
    ckpt = _checkpoint(tmp / "model.ckpt")
    val_argvs, ft_argvs = _val_argvs(tmp, root, scan, ckpt), _ft_argvs(
        tmp, ckpt)
    launched = {
        "split2": _launch_render(tmp, "split2", 2, [scenes[:1]], state,
                                 tcfg),
        "split3": _launch_render(tmp, "split3", 3, [scenes[:1], scenes],
                                 state, tcfg),
        "val": _launch_main(tmp, "val", val_argvs[:2]),
        "ft": _launch_main(tmp, "ft", ft_argvs[:2]),
    }
    res = {"tmp": tmp, "scenes": scenes, "refs": []}
    try:
        with torch.no_grad():
            for s in scenes:
                t = {k: torch.from_numpy(v) for k, v in s.items()}
                scene = tm.build_scene(t["imgs"], t["intrs"], t["c2ws"])
                rays = {k: t[k] for k in RAY_KEYS}
                res["refs"].append({
                    "runner": Runner.render_chunked(
                        types.SimpleNamespace(model=tm), scene, rays,
                        CHUNK),
                    "plain": _plain_chunked(tm, scene, rays, CHUNK)})
        res["val_one"] = main(val_argvs[2] + ["--device", "cpu"])
        res["ft_one"] = main(ft_argvs[2] + ["--device", "cpu"])
    except BaseException:
        for procs, _ in launched.values():
            for p in procs:
                p.kill()
        raise
    for name, (procs, outs) in launched.items():
        _finish(procs)
        res[name] = _load(outs)
    return res


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_one_process_render_is_the_plain_loop(runs):
    for ref in runs["refs"]:
        _assert_same(ref["runner"], ref["plain"])


@pytest.mark.parametrize("world", [2, 3])
def test_split_render_equals_one_process(runs, world):
    """The leader's gathered render equals the one-process render bit for
    bit; every rank rendered its chunks' real rays, the padding left
    out."""
    ranks = [r["runs"][0] for r in runs[f"split{world}"]]
    assert [r["ranks"] for r in ranks] == [tuple(range(world))] * world
    _assert_same(ranks[0]["scenes"][0]["render"], runs["refs"][0]["plain"])
    for j, r in enumerate(ranks):
        st = r["scenes"][0]["stats"]
        assert st["rays"] == np.count_nonzero(
            chunk_rows(N_RAYS, CHUNK, world, j) < N_RAYS)
        assert (r["scenes"][0]["render"] is None) == (j > 0)
    assert sum(r["scenes"][0]["stats"]["rays"] for r in ranks) == N_RAYS


def test_three_ranks_two_scenes_split_one_group(runs):
    """Three ranks, two scenes: rank 0 renders scene A alone, ranks 1 and 2
    split scene B (a group made by ``dist.new_group``); both equal their
    one-process renders."""
    ranks = [r["runs"][1] for r in runs["split3"]]
    assert ranks[0]["ranks"] == (0,)
    assert ranks[1]["ranks"] == ranks[2]["ranks"] == (1, 2)
    _assert_same(ranks[0]["scenes"][0]["render"], runs["refs"][0]["plain"])
    _assert_same(ranks[1]["scenes"][1]["render"], runs["refs"][1]["plain"])
    assert ranks[2]["scenes"][1]["render"] is None


def test_split_render_matches_jax_render(runs):
    """The port's 2-rank split render against ``gens_tpu.runner.Runner.
    _render_chunked`` over the 8 host devices, same params and inputs: at
    least 90% of rays agree within 1e-3 on every output (the hierarchical
    sampler may flip on the small differences of the two scenes)."""
    from gens_tpu.runner import Runner as JRunner

    _, jm, params, _, _ = tiny_models()
    assert len(jax.local_devices()) == 8
    s = runs["scenes"][0]
    jscene = jax.jit(jm.build_scene)(params, jnp.asarray(s["imgs"]),
                                     jnp.asarray(s["intrs"]),
                                     jnp.asarray(s["c2ws"]))
    runner = JRunner.__new__(JRunner)
    runner._jit_cache, runner.model = {}, jm
    want = runner._render_chunked(params, jscene, {
        "rays_o": s["rays_o"], "rays_d": s["rays_d"],
        "near": jnp.asarray(s["near"]), "far": jnp.asarray(s["far"])},
        chunk=CHUNK)
    got = runs["split2"][0]["runs"][0]["scenes"][0]["render"]
    agree = np.ones(N_RAYS, bool)
    for k in RENDER_KEYS:
        a, b = np.asarray(want[k]).reshape(N_RAYS, -1), got[k].reshape(
            N_RAYS, -1)
        assert a.shape == b.shape, k
        agree &= np.isclose(b, a, rtol=1e-3, atol=1e-3).all(axis=1)
    print(f"split render vs JAX: {1 - agree.mean():.4f} of rays differ")
    assert agree.mean() >= 0.9


# -- the entry point on two ranks ---------------------------------------------


def _files(d):
    return sorted(os.path.relpath(os.path.join(p, f), d)
                  for p, _, fs in os.walk(d) for f in fs)


def _same_outputs(tmp, got, want, subs):
    """The image and mesh files under ``got`` equal those under ``want``,
    byte for byte."""
    names = [f for f in _files(tmp / want) if f.split(os.sep)[0] in subs]
    assert names and names == [f for f in _files(tmp / got)
                               if f.split(os.sep)[0] in subs]
    for f in names:
        with open(tmp / got / f, "rb") as a, open(tmp / want / f, "rb") as b:
            assert a.read() == b.read(), f


OUTPUTS = ("meshes", "val_img", "val_normal", "val_render_depth",
           "val_sdf_depth")
# the stats of a rank's own share and its seconds
PER_RANK = ("rays", "rays_per_s", "group_size", "broadcast_bytes", "scene")


def _shared(st):
    return {k: v for k, v in st.items()
            if not k.endswith("_s") and k not in PER_RANK}


def test_main_val_one_item_on_two_ranks(runs):
    """One DTU-layout item on two ranks: rank 0 writes the one-process
    images and mesh, rank 1 writes nothing, both report the one-process
    metrics, and rank 0's stats are the one-process stats but for the
    rays it rendered."""
    tmp, one = runs["tmp"], runs["val_one"]
    r0, r1 = runs["val"]
    _same_outputs(tmp, "val_rank0", "val_one", OUTPUTS)
    assert not os.path.exists(tmp / "val_rank1")
    assert r0["metrics"] == r1["metrics"] == one.metrics
    (st0,), (st1,), (st,) = r0["stats"], r1["stats"], one.stats
    assert _shared(st0) == _shared(st)
    assert st0["rays"] + st1["rays"] == st["rays"]
    assert st0["group_size"] == st1["group_size"] == 2
    assert st1["scene"] == st["scene"] and "psnr" not in st1
    assert st0["broadcast_bytes"] == st1["broadcast_bytes"] > 0


def test_main_finetune_on_two_ranks(runs):
    """``--mode finetune`` on two ranks: rank 0's steps and validations are
    the one-process run's bit for bit (its images and meshes too), rank 1
    runs no step, writes nothing, renders its share of each validation
    and returns rank 0's means."""
    tmp, one = runs["tmp"], runs["ft_one"]
    r0, r1 = runs["ft"]
    ft = os.path.join("s0", "view4")
    _same_outputs(tmp, os.path.join("ft_rank0", ft),
                  os.path.join("ft_one", ft), OUTPUTS)
    assert not os.path.exists(tmp / "ft_rank1")
    want = [_shared(st) for st in one.finetune_stats]
    assert [_shared(st) for st in r0["finetune_stats"]] == want
    assert [st["val_step"] for st in one.finetune_stats
            if "val_step" in st] == [0, 1]
    assert [st["val_step"] for st in r1["finetune_stats"]] == [0, 1]
    assert not [st for st in r1["finetune_stats"] if "loss" in st]
    for a, b, c in zip([s for s in r0["finetune_stats"] if "val_step" in s],
                       r1["finetune_stats"],
                       [s for s in one.finetune_stats if "val_step" in s]):
        assert a["rays"] + b["rays"] == c["rays"]
    assert r0["metrics"] == r1["metrics"] == one.metrics
