"""The weights both sides are given, by the measured program's state-dict
names: a GenS checkpoint file read here (its JAX parameter tree mapped to
those names), never through the program's own reader."""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict

import numpy as np
import torch


def cell_weights(cell, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights: its checkpoint file, a path under the
    checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return checkpoint_state(os.path.join(root, cell.config["weights"]),
                            device)


# -- a GenS checkpoint file (pickle of numpy arrays) ---------------------


class _NumpyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("numpy", "builtins", "collections"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not allowed")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _inner(tree):
    return tree["params"] if "params" in tree else tree


def checkpoint_state(path: str, device) -> Dict[str, torch.Tensor]:
    """The ``params`` of a GenS checkpoint pickle as a float32 state dict
    on ``device``: flax's HWIO convolution kernels to OIHW, transposed
    convolutions spatially flipped, the U-Net's [w_up | w_mid | w_dn]
    kernels to one Conv3d's kx = 0, 1, 2 taps (w_dn, w_mid, w_up), dense
    kernels transposed."""
    with open(path, "rb") as f:
        tree = _NumpyUnpickler(f).load()["params"]
    state = {}
    for top in ("feature", "match_feature"):
        p = _inner(tree[top])
        for name, sub in p.items():
            m = re.fullmatch(r"(ConvBlock|DeconvBlock|Conv)_(\d+)", name)
            i = int(m.group(2))
            if m.group(1) == "ConvBlock":
                state[f"{top}.enc.{i}.conv.weight"] = _t(
                    sub["Conv_0"]["kernel"]).permute(3, 2, 0, 1)
            elif m.group(1) == "DeconvBlock":
                state[f"{top}.dec.{i}.weight"] = _t(
                    sub["ConvTranspose_0"]["kernel"]).permute(
                        2, 3, 0, 1).flip(2, 3)
            else:
                state[f"{top}.heads.{i}.weight"] = _t(
                    sub["kernel"]).permute(3, 2, 0, 1)
    for name, sub in _inner(tree["reg"]).items():
        m = re.fullmatch(r"(?:Checkpoint)?(Conv3dBlock|Upsample3dBlock)_(\d+)",
                         name)
        i = int(m.group(2))
        if m.group(1) == "Conv3dBlock":
            state[f"reg.blocks.{i}.weight"] = _conv3d(sub["kernel"])
            if "bias" in sub:
                state[f"reg.blocks.{i}.bias"] = _t(sub["bias"])
        else:
            state[f"reg.ups.{i}.conv.weight"] = _conv3d(
                sub["Conv3dBlock_0"]["kernel"])
    for name, sub in _inner(tree["sdf"]).items():
        for leaf in ("v", "g", "b"):
            state[f"sdf.{name}.{leaf}"] = _t(sub[leaf])
    for name, sub in _inner(tree["blending"]).items():
        if name == "s":
            state["blending.s"] = _t(sub)
            continue
        i = int(re.fullmatch(r"MLP_(\d+)", name).group(1))
        for dname, dense in sub.items():
            j = int(re.fullmatch(r"Dense_(\d+)", dname).group(1))
            pre = f"blending.mlps.{i}.layers.{j}"
            state[f"{pre}.weight"] = _t(dense["kernel"]).t()
            state[f"{pre}.bias"] = _t(dense["bias"])
    state["variance.variance"] = _t(_inner(tree["variance"])["variance"])
    return {k: v.contiguous().to(device) for k, v in state.items()}


def _conv3d(k) -> torch.Tensor:
    k = _t(k)
    c = k.shape[2] // 3
    w = torch.stack([k[:, :, 2 * c:], k[:, :, c:2 * c], k[:, :, :c]], dim=0)
    return w.permute(4, 3, 0, 1, 2)
