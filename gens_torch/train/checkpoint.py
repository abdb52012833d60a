"""Training checkpoints (counterpart of the pickle format of
gens_tpu/train/checkpoint.py).

One pickle file holds ``{epoch, step, format_version, params, opt_state}``.
``params`` is the JAX-layout numpy tree (``convert.params_to_jax``), so
``convert.load_params`` and the val path read a checkpoint the port wrote,
as they read the JAX package's; ``opt_state`` is the torch optimizer's
``state_dict`` with its tensors on the CPU.

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
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from gens_torch.convert import (FINETUNE_MODULES, finetune_params_from_jax,
                                finetune_params_to_jax, load_checkpoint,
                                params_to_jax)

CKPT_FORMAT_VERSION = 2


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, epoch: int, step: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """Write the checkpoint atomically (a temporary file, then a rename)
    and return its payload."""
    return _write(path, {"epoch": int(epoch), "step": int(step),
                         "format_version": CKPT_FORMAT_VERSION,
                         "params": params_to_jax(model.state_dict()),
                         "opt_state": _to_cpu(optimizer.state_dict())})


def _write(path: str, payload: Dict[str, Any]) -> Dict[str, Any]:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)
    return payload


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
