"""Training checkpoints (counterpart of the pickle format of
gens_tpu/train/checkpoint.py).

One pickle file holds ``{epoch, step, format_version, params, opt_state}``.
``params`` is the JAX-layout numpy tree (``convert.params_to_jax``), so
``convert.load_params`` and the val path read a checkpoint the port wrote,
as they read the JAX package's; ``opt_state`` is the torch optimizer's
``state_dict`` with its tensors on the CPU. Only load checkpoints this
project wrote: unpickling runs code.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import torch

from gens_torch.convert import params_to_jax

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
    payload = {"epoch": int(epoch), "step": int(step),
               "format_version": CKPT_FORMAT_VERSION,
               "params": params_to_jax(model.state_dict()),
               "opt_state": _to_cpu(optimizer.state_dict())}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)
    return payload
