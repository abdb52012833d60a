"""The port's command line and config against the JAX package's: the same
argument lists set the same mode and mesh options, the config keys that
the port does not carry out are refused, not ignored, and
``reg_network.use_global_attn`` builds the JAX layout."""

import os
import shlex

import jax
import pytest

import gens_tpu.main as jmain
import gens_tpu.parallel.distributed as jdist
from gens_torch.main import config_from_args, main, parse_args
from gens_torch.models.gens import GenSModel as TGenSModel

from _torch_common import tiny_configs
from test_cli import _tiny_overrides

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _queue_r04_train_argv():
    """The arguments of the JAX train command in scripts/tpu_queue_r04.sh
    (the one that passes ``--mesh_resolution 192``)."""
    with open(os.path.join(REPO, "scripts", "tpu_queue_r04.sh")) as f:
        text = f.read().replace("\\\n", " ")
    (line,) = [l for l in text.splitlines()
               if "gens_tpu.main" in l and "--mesh_resolution" in l]
    words = shlex.split(line)
    return words[words.index("gens_tpu.main") + 1:]


ARGV = {
    "queue_r04": _queue_r04_train_argv(),
    "clean_mesh": ["--conf", "confs/dtu.yaml", "--mode", "val", "--resume",
                   "ckpt", "--clean_mesh", "--mesh_resolution", "256"],
    "no_mode": ["--conf", "confs/dtu.yaml", "--set", "train.epochs=2"],
    "test_cli": ["--mode", "train", "--set"] + _tiny_overrides("/unused"),
}


def _jax_config(argv, monkeypatch):
    """The config that gens_tpu/main.py hands its Runner for ``argv``,
    with the Runner, the multi-host set-up and the compile-cache update
    stubbed out: nothing runs."""
    seen = []

    class Capture:
        def __init__(self, cfg):
            seen.append(cfg)

        def run(self, resume=None):
            pass

    monkeypatch.setattr(jmain, "Runner", Capture)
    monkeypatch.setattr(jdist, "initialize", lambda: None)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    jmain.main(argv)
    (cfg,) = seen
    return cfg


@pytest.mark.parametrize("name", sorted(ARGV))
def test_cli_sets_what_the_jax_cli_sets(name, monkeypatch):
    argv = ARGV[name]
    monkeypatch.chdir(REPO)
    want = _jax_config(argv, monkeypatch)
    args = parse_args(argv)
    got = config_from_args(args)
    assert args.device == "cuda"
    for key in ("mode", "mesh_resolution", "clean_mesh"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.model.volume.volume_dims == tuple(
        want.model.volume.volume_dims)
    if name == "queue_r04":
        assert (got.mode, got.mesh_resolution) == ("train", 192)
    if name == "no_mode":
        assert got.mode == "train"
    if name == "clean_mesh":
        assert got.clean_mesh and got.mesh_resolution == 256


def test_global_attn_builds_the_jax_layout():
    """reg_network.use_global_attn builds GlobalAttn at the U-Net's
    bottleneck: the port's reg params, carried to JAX, have the names and
    shapes of the JAX RegNetwork's (GlobalAttn_0 beside the conv blocks)."""
    from gens_torch.convert import params_to_jax
    from gens_tpu.models.reg_net import RegNetwork as JRegNetwork

    jcfg, tcfg = tiny_configs()
    for c in (jcfg, tcfg):
        c.model.reg_network.use_global_attn = True
    dims = jcfg.model.volume.volume_dims
    vols = [jax.ShapeDtypeStruct((1, d, d, d, c), "float32") for d, c in
            zip(dims, jcfg.model.reg_network.d_volume)]
    want = jax.eval_shape(JRegNetwork(jcfg.model.reg_network).init,
                          jax.random.PRNGKey(0), vols)
    got = params_to_jax({k: v for k, v in
                         TGenSModel(tcfg.model).state_dict().items()
                         if k.startswith("reg.")})["reg"]
    flat = jax.tree_util.tree_flatten_with_path
    assert ([(p, x.shape) for p, x in flat(got)[0]]
            == [(p, x.shape) for p, x in flat(want)[0]])
    assert "GlobalAttn_0" in got["params"]


@pytest.mark.parametrize("axis", ["data", "view"])
def test_parallel_axes_are_refused_before_the_first_step(axis, tmp_path,
                                                         monkeypatch):
    """parallel.data x parallel.view must equal the number of ranks: one
    process asked for 4 is refused before a training step is built."""
    import gens_torch.runner as runner_mod

    def no_step(*a, **k):
        raise AssertionError("a training step was built")

    monkeypatch.setattr(runner_mod, "TrainStep", no_step)
    monkeypatch.setattr(runner_mod, "ShardedTrainStep", no_step)
    argv = (["--mode", "train", "--device", "cpu", "--set",
             f"parallel.{axis}=4"] + _tiny_overrides(str(tmp_path)))
    with pytest.raises(ValueError, match=f"parallel.{axis}=4.* needs 4 "
                       "ranks, and 1 are running"):
        main(argv)
