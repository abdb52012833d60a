"""Training checkpoints (counterpart of the pickle format of
gens_tpu/train/checkpoint.py).

One pickle file holds ``{epoch, step, format_version, params, opt_state}``.
``params`` is the JAX-layout numpy tree (``convert.params_to_jax``), so
``convert.load_params`` and the val path read a checkpoint the port wrote,
as they read the JAX package's; ``opt_state`` is the torch optimizer's
``state_dict`` with its tensors as numpy arrays and its ``param_groups``
as plain Python, so the file unpickles without torch (the JAX package's
``load_checkpoint`` reads its params for ``--mode val``).

:func:`load_optimizer_state` takes either form of ``opt_state`` into the
port's Adam: the port's (numpy, or the torch tensors that checkpoints of
earlier versions pickled) through ``load_state_dict``, and the JAX
package's optax tree through :func:`adam_state_from_jax`.

A JAX checkpoint may also be an orbax directory (gens_tpu's default
format), which ``convert.load_checkpoint`` reads into the same payload; a
checkpoint written where one stands replaces it.

A finetune checkpoint is the JAX runner's: ``{epoch, format_version,
params}`` with the step in ``epoch`` and ``params`` in the finetune format
(``convert.finetune_params_to_jax``); like the JAX one it holds no
optimizer state. Only load checkpoints this project wrote: unpickling runs
code.

:func:`latest_checkpoint` picks what ``--resume auto`` continues from.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gens_torch.convert import (FINETUNE_MODULES, MaskedNode, PartitionState,
                                ScaleByAdamState, finetune_params_from_jax,
                                finetune_params_to_jax, load_checkpoint,
                                params_from_jax, params_to_jax)

CKPT_FORMAT_VERSION = 2
# gens_tpu/train/step.py::_param_labels: the optax partition's labels
JAX_LABELS = ("mlp", "variance", "feat", "frozen")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _to_numpy(tree):
    """Tensors as numpy; bfloat16 ones as float32 (numpy has no bfloat16;
    the optimizer's ``load_state_dict`` casts its state back to each
    parameter's dtype)."""
    return _map(lambda x: (x.detach().cpu().float() if x.dtype ==
                           torch.bfloat16 else x.detach().cpu()).numpy()
                if torch.is_tensor(x) else x, tree)


def _to_torch(tree):
    return _map(lambda x: torch.from_numpy(np.array(x))
                if isinstance(x, np.ndarray) else x, tree)


def save_checkpoint(path: str, epoch: int, step: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Write the checkpoint atomically (a temporary file, then a rename)
    and return its payload; ``extra`` adds keys of plain Python."""
    return _write(path, {"epoch": int(epoch), "step": int(step),
                         "format_version": CKPT_FORMAT_VERSION,
                         "params": params_to_jax(model.state_dict()),
                         "opt_state": _to_numpy(optimizer.state_dict()),
                         **(extra or {})})


def save_params_checkpoint(path: str, step: int, model: torch.nn.Module,
                           params: Optional[Dict[str, Any]] = None,
                           extra: Optional[Dict[str, Any]] = None
                           ) -> Dict[str, Any]:
    """``{epoch: 0, step, format_version, params}``: the params alone in
    the JAX layout, as scripts/quality_synthetic.py saves a trained
    model; ``params`` replaces the model's tree (a finetune's, from
    ``convert.finetune_params_to_jax``) and ``extra`` adds keys."""
    if params is None:
        params = params_to_jax(model.state_dict())
    return _write(path, {"epoch": 0, "step": int(step),
                         "format_version": CKPT_FORMAT_VERSION,
                         "params": params, **(extra or {})})


def _write(path: str, payload: Dict[str, Any]) -> Dict[str, Any]:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    if os.path.isdir(path):
        # a JAX orbax checkpoint of the same name (a resumed JAX run's
        # preempt.ckpt): the new file supersedes it, as orbax's force=True
        # save would
        old = path + ".replaced"
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
    return payload


class AdamStateMismatch(ValueError):
    """A JAX optimizer state whose labels, leaves or shapes do not match
    the port's model and Adam groups."""


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module, opt_state) -> str:
    """Load a checkpoint's ``opt_state`` of either package into the port's
    Adam (:class:`~gens_torch.train.step.TrainStep`'s groups). Returns the
    form it read: "optax", "numpy", or "torch" (the port's checkpoints
    before their ``opt_state`` became numpy)."""
    if isinstance(opt_state, PartitionState):
        adam_state_from_jax(opt_state, model, optimizer)
        return "optax"
    form = ("torch" if any(torch.is_tensor(v)
                           for st in opt_state["state"].values()
                           for v in st.values()) else "numpy")
    optimizer.load_state_dict(_to_torch(opt_state))
    return form


def _merge(a, b, path: Tuple[str, ...] = ()):
    """Two labels' moment trees as one; a MaskedNode (or absence) yields
    to the other side."""
    if b is None or isinstance(b, MaskedNode):
        return a
    if a is None or isinstance(a, MaskedNode):
        return b
    if isinstance(a, dict) and isinstance(b, dict):
        return {k: _merge(a.get(k), b.get(k), path + (k,))
                for k in {**a, **b}}
    raise AdamStateMismatch(f"two labels hold moments at {'/'.join(path)}")


def _prune(tree):
    """``tree`` without its MaskedNodes (and the dicts left empty)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _prune(v) for k, v in tree.items()
           if not isinstance(v, MaskedNode)}
    return {k: v for k, v in out.items() if not (isinstance(v, dict)
                                                 and not v)}


def _moment_state(tree) -> Dict[str, torch.Tensor]:
    """A JAX moment tree (the params' tree, without ``match_feature``) ->
    port parameter names, through the params' layout maps (the conv
    permutes, the ConvTranspose flip and the U-Net kernel split are
    permutations, so they carry the moments unchanged)."""
    if "feature" not in tree:
        raise AdamStateMismatch(
            f"the moments hold no 'feature' tree: {sorted(tree)}")
    # match_feature is frozen and carries no moments; its names are dropped
    try:
        state = params_from_jax({**tree, "match_feature": tree["feature"]})
    except (KeyError, TypeError, AttributeError) as e:
        raise AdamStateMismatch(
            f"the moments do not have the params' tree: {e!r}") from e
    return {k: v for k, v in state.items()
            if not k.startswith("match_feature.")}


def jax_adam_moments(opt_state):
    """optax's Adam state (``gens_tpu.train.step.make_optimizer``:
    ``multi_transform`` of ``adam`` per label) in the port's names:
    (exp_avg, exp_avg_sq) as {parameter name: tensor}, each label's
    ``count`` and the label of each top-level module.

    The tree is ``PartitionState.inner_states[label]`` -> ``MaskedState``
    -> ``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState |
    EmptyState)``; ``mu`` and ``nu`` have the params' tree with
    ``MaskedNode`` where another label rules. The labels' trees merge and
    go through the params' layout maps. The ``frozen`` label
    (``match_feature``, the MnasNet ``batch_stats``) carries none."""
    inner = opt_state.inner_states
    if set(inner) != set(JAX_LABELS):
        raise AdamStateMismatch(f"optax labels {sorted(inner)}, expected "
                                f"{sorted(JAX_LABELS)}")
    counts, owner, mu, nu = {}, {}, None, None
    for label in JAX_LABELS[:-1]:
        states = getattr(inner[label], "inner_state", None)
        adam = [s for s in (states if isinstance(states, tuple) else ())
                if isinstance(s, ScaleByAdamState)]
        if len(adam) != 1:
            raise AdamStateMismatch(
                f"label {label!r} holds no single Adam state: {states!r}")
        (adam,) = adam
        counts[label] = int(np.asarray(adam.count))
        for top, sub in adam.mu.items():
            if not isinstance(sub, MaskedNode) and _prune(sub):
                owner[top] = label
        mu, nu = _merge(mu, adam.mu), _merge(nu, adam.nu)
    return (_moment_state(_prune(mu)), _moment_state(_prune(nu)), counts,
            owner)


def adam_state_from_jax(opt_state, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer) -> None:
    """Carry optax's Adam state into the port's Adam: the moments of
    :func:`jax_adam_moments` become ``exp_avg`` / ``exp_avg_sq`` of each
    port parameter and its label's ``count`` becomes ``step``. optax's
    ``adam`` and torch's ``Adam`` (eps outside the square root, no
    eps_root) then take the same next update. Raises
    :class:`AdamStateMismatch` when a label, leaf, group or shape
    differs."""
    exp_avg, exp_avg_sq, counts, owner = jax_adam_moments(opt_state)
    names = {id(p): n for n, p in model.named_parameters()}
    expected = set()
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            top = name.split(".")[0]
            expected.add(name)
            if name not in exp_avg or name not in exp_avg_sq:
                raise AdamStateMismatch(f"no moments for {name}")
            if owner.get(top) != group["name"]:
                raise AdamStateMismatch(
                    f"{name} is in the port's group {group['name']!r} but "
                    f"under the optax label {owner.get(top)!r}")
            if exp_avg[name].shape != p.shape:
                raise AdamStateMismatch(
                    f"{name}: moments of shape {tuple(exp_avg[name].shape)}, "
                    f"parameter of shape {tuple(p.shape)}")
    extra = sorted(set(exp_avg) - expected)
    if extra:
        raise AdamStateMismatch(f"moments for no port parameter: {extra}")
    for group in optimizer.param_groups:
        step = torch.tensor(float(counts[group["name"]]))
        for p in group["params"]:
            name = names[id(p)]
            optimizer.state[p] = {
                "step": step.clone(),
                "exp_avg": exp_avg[name].to(p.device, p.dtype),
                "exp_avg_sq": exp_avg_sq[name].to(p.device, p.dtype)}


def save_finetune_checkpoint(path: str, step: int, model: torch.nn.Module,
                             volumes: Sequence[torch.Tensor],
                             mask_volumes: Sequence[torch.Tensor],
                             features: Sequence[torch.Tensor]
                             ) -> Dict[str, Any]:
    """Write a finetune checkpoint atomically and return its payload."""
    arrays = {"volumes": volumes, "mask_volumes": mask_volumes,
              "features": features}
    return _write(path, {"epoch": int(step),
                         "format_version": CKPT_FORMAT_VERSION,
                         "params": finetune_params_to_jax(model, arrays)})


def load_finetune_checkpoint(model: torch.nn.Module, source
                             ) -> Tuple[Dict[str, Any],
                                        Dict[str, List[torch.Tensor]]]:
    """Load a finetune checkpoint (its path or payload) into ``model``'s
    sdf, blending and variance modules, every one of their parameters
    matched. Returns (payload, {volumes, mask_volumes, features}) with the
    arrays as f32 CPU tensors."""
    payload = load_checkpoint(source) if isinstance(source, str) else source
    state, arrays = finetune_params_from_jax(payload["params"])
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if k.split(".")[0] in FINETUNE_MODULES]
    if missing or unexpected:
        raise KeyError(f"finetune checkpoint does not match the model: "
                       f"missing {missing}, unexpected {unexpected}")
    return payload, arrays


def latest_checkpoint(ckpt_dir: str,
                      exclude: tuple = ("emergency.ckpt",)) -> Optional[str]:
    """The newest ``*.ckpt`` in ``ckpt_dir`` by mtime, the name breaking
    ties; None when there is none. Epoch and preemption checkpoints
    interleave, so the names' order would rank a stale ``preempt.ckpt``
    above a newer ``model_NNN.ckpt``. ``emergency.ckpt`` (the params that
    produced a non-finite loss) is skipped: resuming it would fail
    again."""
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = [os.path.join(ckpt_dir, p) for p in os.listdir(ckpt_dir)
             if p.endswith(".ckpt") and p not in exclude]
    return max(ckpts, key=lambda p: (os.path.getmtime(p), p), default=None)
