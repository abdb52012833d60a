"""Training checkpoints across the two packages: a JAX pickle checkpoint
with optax's optimizer state loads in the port without jax, flax or optax
(gens_torch.convert.JAX_PICKLE_CLASSES), its Adam state carries into the
port's Adam (gens_torch.train.checkpoint.adam_state_from_jax) and takes
optax's next update, a train ``--resume`` from it continues from the
carried moments, and a port checkpoint unpickles without torch.

No model step compiles here: the JAX optimizer state comes from
``gens_tpu.train.step.make_optimizer`` and optax updates under ``jax.jit``
on random gradients, over the params of a seeded port model at
tiny_config sizes."""

import importlib
import io
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gens_torch.convert import (JAX_PICKLE_CLASSES, MaskedNode,
                                UnknownJaxClassError, _CheckpointUnpickler,
                                load_checkpoint, params_from_jax,
                                params_to_jax)
from gens_torch.models.gens import GenSModel as TGenSModel
from gens_torch.train.checkpoint import (AdamStateMismatch,
                                         adam_state_from_jax,
                                         jax_adam_moments,
                                         load_optimizer_state,
                                         save_checkpoint)
from gens_torch.train.step import TrainStep
from gens_tpu.train import checkpoint as jckpt
from gens_tpu.train.step import make_optimizer as j_make_optimizer

from _torch_common import tiny_configs

K_UPDATES = 3
OPTAX_CLASSES = {
    "optax.transforms._combining.PartitionState",
    "optax.transforms._masking.MaskedState",
    "optax.transforms._masking.MaskedNode",
    "optax._src.transform.ScaleByAdamState",
    "optax._src.transform.ScaleByScheduleState",
    "optax._src.base.EmptyState"}


def close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(b.detach(), np.float32),
                               np.asarray(a, np.float32), rtol=rtol,
                               atol=atol)


def block(mp, *roots):
    """Make ``import`` of the packages ``roots`` fail while ``mp`` (a
    monkeypatch context) is open, as on a machine without them."""
    for name in list(sys.modules):
        if name.split(".")[0] in roots:
            mp.delitem(sys.modules, name)
    for root in roots:
        mp.setitem(sys.modules, root, None)


def tiny_port_model(seed: int = 0) -> TGenSModel:
    torch.manual_seed(seed)
    return TGenSModel(tiny_configs()[1].model)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """K_UPDATES optax updates of the tiny model's params (taken from a
    seeded port model) on random gradients, the next gradient and the
    update it makes, and the JAX pickle checkpoint of the state after
    K_UPDATES, written by gens_tpu's save_checkpoint."""
    jcfg, _ = tiny_configs()
    params0 = params_to_jax(tiny_port_model().state_dict())
    opt = j_make_optimizer(jcfg.train, steps_per_epoch=1)
    rng = np.random.RandomState(0)
    grads = [jax.tree.map(lambda a: np.asarray(rng.randn(*a.shape), np.float32),
                          params0) for _ in range(K_UPDATES + 1)]

    @jax.jit
    def update(g, st, p):
        u, st = opt.update(g, st, p)
        return optax.apply_updates(p, u), st

    p = jax.tree.map(jnp.asarray, params0)
    st = opt.init(p)
    for g in grads[:K_UPDATES]:
        p, st = update(g, st, p)
    p_next, _ = update(grads[K_UPDATES], st, p)
    path = str(tmp_path_factory.mktemp("jax") / "model_000.ckpt")
    jckpt.save_checkpoint(path, {"epoch": 0, "step": K_UPDATES,
                                 "params": p, "opt_state": st},
                          use_orbax=False)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"path": path, "params": np_tree(p), "grad": grads[K_UPDATES],
            "params_next": np_tree(p_next)}


def test_jax_pickle_with_opt_state_loads_without_jax(jax_run, monkeypatch):
    with monkeypatch.context() as mp:
        block(mp, "optax", "flax", "jax", "jaxlib", "chex")
        with pytest.raises(ImportError):
            importlib.import_module("optax.transforms")
        payload = load_checkpoint(jax_run["path"])
    assert int(payload["step"]) == K_UPDATES
    st = payload["opt_state"]
    assert type(st).__name__ == "PartitionState"
    assert sorted(st.inner_states) == ["feat", "frozen", "mlp", "variance"]
    adam, sched = st.inner_states["mlp"].inner_state
    assert type(sched).__name__ == "ScaleByScheduleState"
    assert int(adam.count) == K_UPDATES
    assert type(adam.mu["feature"]).__name__ == "MaskedNode"
    assert isinstance(adam.mu["sdf"]["params"]["lin0"]["v"], np.ndarray)
    assert type(st.inner_states["frozen"].inner_state).__name__ == \
        "EmptyState"


def test_jax_pickle_classes_cover_an_optax_checkpoint(jax_run):
    """Every class the JAX pickle names has a stand-in with the real
    class's fields; a JAX-side class outside the table raises by name."""
    seen = set()

    class Recording(pickle.Unpickler):
        def find_class(self, module, name):
            seen.add(f"{module}.{name}")
            return super().find_class(module, name)

    with open(jax_run["path"], "rb") as f:
        Recording(f).load()
    jax_side = {c for c in seen if c.split(".")[0] in ("optax", "flax",
                                                        "jax")}
    assert jax_side == OPTAX_CLASSES
    for path in jax_side:
        module, name = path.rsplit(".", 1)
        real = getattr(__import__(module, fromlist=[name]), name)
        assert JAX_PICKLE_CLASSES[path]._fields == real._fields, path

    # GLOBAL "optax._src.nothing Gone", STOP
    data = io.BytesIO(b"coptax._src.nothing\nGone\n.")
    with pytest.raises(UnknownJaxClassError, match="optax._src.nothing.Gone"):
        _CheckpointUnpickler(data).load()


def test_adam_state_from_jax_takes_optax_next_update(jax_run):
    """The port's Adam, loaded with the params and the optax state after
    K_UPDATES, takes the same next update as optax on the same gradient,
    in every group (tests/test_torch_train.py's f32 update tolerances)."""
    _, tcfg = tiny_configs()
    payload = load_checkpoint(jax_run["path"])
    model = TGenSModel(tcfg.model)
    model.load_state_dict(params_from_jax(payload["params"]), strict=True)
    step = TrainStep(model, tcfg, steps_per_epoch=1,
                     start_step=int(payload["step"]))
    assert load_optimizer_state(step.optimizer, model,
                                payload["opt_state"]) == "optax"
    grad = params_from_jax(jax_run["grad"])
    for name, p in model.named_parameters():
        p.grad = grad[name].clone()
    step.optimizer.step()
    want = params_from_jax(jax_run["params_next"])
    before = params_from_jax(jax_run["params"])
    moved = {}
    for group in step.optimizer.param_groups:
        for p in group["params"]:
            assert float(step.optimizer.state[p]["step"]) == K_UPDATES + 1
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        if top == "match_feature":
            torch.testing.assert_close(p.detach(), want[name])
            continue
        close(want[name], p, 1e-5, 2e-6)
        moved[top] = moved.get(top, 0.0) + float(
            (want[name] - before[name]).abs().sum())
    assert set(moved) == {"feature", "reg", "sdf", "blending", "variance"}
    assert all(v > 0 for v in moved.values()), moved


def _mismatch(case, st):
    """A copy of the optax state ``st`` with one fault."""
    st = pickle.loads(pickle.dumps(st))
    inner = st.inner_states
    if case == "label":
        del inner["variance"]
        return st
    adam, _ = inner["mlp"].inner_state
    sdf = adam.mu["sdf"]["params"]
    if case == "leaf":
        del sdf["lin0"]["v"]
    elif case == "shape":
        sdf["lin0"]["v"] = sdf["lin0"]["v"][:-1]
    elif case == "extra":
        sdf["lin99"] = {"v": sdf["lin0"]["v"]}
    elif case == "group":  # the sdf moments under the "feat" label
        feat, _ = inner["feat"].inner_state
        for a, b in ((feat.mu, adam.mu), (feat.nu, adam.nu)):
            a["sdf"], b["sdf"] = b["sdf"], MaskedNode()
    return st


@pytest.mark.parametrize("case", ["label", "leaf", "shape", "extra",
                                  "group"])
def test_adam_state_from_jax_refuses_a_mismatched_tree(jax_run, case):
    _, tcfg = tiny_configs()
    payload = load_checkpoint(jax_run["path"])
    model = TGenSModel(tcfg.model)
    step = TrainStep(model, tcfg, steps_per_epoch=1)
    with pytest.raises(AdamStateMismatch):
        adam_state_from_jax(_mismatch(case, payload["opt_state"]), model,
                            step.optimizer)


def test_port_checkpoint_unpickles_without_torch(tmp_path, monkeypatch):
    """A port checkpoint's optimizer state is numpy: the file unpickles
    with torch blocked, and gens_tpu's load_checkpoint reads its params in
    the JAX tree."""
    _, tcfg = tiny_configs()
    model = tiny_port_model(1)
    step = TrainStep(model, tcfg, steps_per_epoch=1)
    gen = torch.Generator().manual_seed(0)
    for name, p in model.named_parameters():
        if not name.startswith("match_feature"):
            p.grad = torch.randn(p.shape, generator=gen)
    step.optimizer.step()
    path = str(tmp_path / "model_000.ckpt")
    save_checkpoint(path, 0, 1, model, step.optimizer)
    want = params_to_jax(model.state_dict())
    with monkeypatch.context() as mp:
        block(mp, "torch")
        with pytest.raises(ImportError):
            importlib.import_module("torch._utils")
        payload = jckpt.load_checkpoint(path)
    assert (jax.tree_util.tree_structure(payload["params"])
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(payload["params"]),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    st = payload["opt_state"]
    assert all(isinstance(v, np.ndarray) for s in st["state"].values()
               for v in s.values())
    assert [g["name"] for g in st["param_groups"]] == ["mlp", "variance",
                                                      "feat"]


def test_main_train_resumes_a_jax_checkpoint_from_its_moments(jax_run,
                                                              tmp_path):
    """``gens_torch.main --mode train --resume`` of the JAX checkpoint
    (params and optax state after K_UPDATES): the first step starts from
    the carried moments, exp_avg = b1 · mu + (1 - b1) · g."""
    from gens_torch.main import main
    from test_torch_train import TINY_TRAIN

    payload = load_checkpoint(jax_run["path"])
    carried = jax_adam_moments(payload["opt_state"])[0]
    runner = main(["--mode", "train", "--device", "cpu", "--resume",
                   jax_run["path"], "--set",
                   f"base_exp_dir={tmp_path / 'exp'}", "train.epochs=2"]
                  + TINY_TRAIN)
    assert runner.opt_state_form == "optax"
    (st,) = runner.train_stats
    assert st["epoch"] == 1 and st["step"] == K_UPDATES + 1
    opt = runner.step_fn.optimizer
    checked = []
    for name, p in runner.model.named_parameters():
        if name.startswith("match_feature"):
            continue
        state = opt.state[p]
        assert float(state["step"]) == K_UPDATES + 1, name
        close(0.9 * carried[name] + 0.1 * p.grad, state["exp_avg"], 1e-5,
              1e-7)
        checked.append(name)
    assert sorted(checked) == sorted(carried)
