"""Parameter bridge from the JAX package's checkpoints to the port's modules.

* :func:`load_checkpoint` reads the JAX pickle checkpoint format (a pickled
  dict of numpy arrays: ``epoch``, ``step``, ``format_version``, ``params``
  and, in a training checkpoint, optax's ``opt_state``) without jax, flax
  or optax: the optax classes that such a pickle names
  (:data:`JAX_PICKLE_CLASSES`) load as plain stand-ins whose fields are the
  numpy arrays, and any other class of jax, flax or optax raises
  :class:`UnknownJaxClassError`. Everything else resolves as plain
  ``pickle`` resolves it. A directory is gens_tpu's default format, an
  orbax checkpoint, which :mod:`gens_torch.train.orbax` reads into the same
  payload without orbax, tensorstore or zstandard.
* :func:`params_from_jax` turns a JAX parameter tree (nested dicts of numpy
  arrays, any float dtype) into a ``GenSModel`` state dict in f32.
* :func:`load_params` does both into a model.
* :func:`params_to_jax` is the inverse of :func:`params_from_jax`: a port
  state dict as the JAX parameter tree (numpy f32 leaves, flax names), the
  ``params`` of the port's training checkpoints.
* :func:`finetune_params_from_jax` / :func:`finetune_params_to_jax` carry
  the finetune-format ``params`` -- ``volumes``, ``mask_volumes`` and
  ``features`` (lists of arrays) beside the ``sdf``, ``blending`` and
  ``variance`` subtrees -- in both directions.

Layout changes at the bridge: flax Conv kernels (kh, kw, in, out) become
torch (out, in, kh, kw); ConvTranspose kernels become (in, out, kh, kw),
spatially flipped (see ``models/feature_net.py``); the U-Net's stacked
(3, 3, 3C, out) kernels [w_up | w_mid | w_dn] become Conv3d (out, C, 3, 3, 3)
with kx = 0, 1, 2 holding w_dn, w_mid, w_up; Dense kernels (in, out) become
Linear (out, in). The SDF network and the idr colour head keep the (in,
out) ``v`` layout. The MnasNet backbone's tree (``encoder/...``,
``decod_layer{k}``, ``out_layer{i}``) carries a ``batch_stats`` collection
beside ``params``: its BatchNorm ``mean`` / ``var`` are the port's
``running_mean`` / ``running_var`` buffers, and its ``scale`` the BN
``weight``. LayerNorm ``scale`` (``reg/GlobalAttn_0``) is ``weight`` too.

Only load checkpoints this project wrote: unpickling runs code.
"""

from __future__ import annotations

import collections
import os
import pickle
import re
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

# -- the JAX-side classes of a pickled checkpoint ------------------------------

# optax's states are NamedTuples; a pickle rebuilds one as cls(*fields)
PartitionState = collections.namedtuple("PartitionState", "inner_states")
MaskedState = collections.namedtuple("MaskedState", "inner_state")
MaskedNode = collections.namedtuple("MaskedNode", "")
ScaleByAdamState = collections.namedtuple("ScaleByAdamState",
                                          "count mu nu")
ScaleByScheduleState = collections.namedtuple("ScaleByScheduleState",
                                              "count")
EmptyState = collections.namedtuple("EmptyState", "")


# "module.Class" -> stand-in: the classes of a gens_tpu training
# checkpoint's optax state (optax 0.2)
JAX_PICKLE_CLASSES = {
    "optax.transforms._combining.PartitionState": PartitionState,
    "optax.transforms._masking.MaskedState": MaskedState,
    "optax.transforms._masking.MaskedNode": MaskedNode,
    "optax._src.transform.ScaleByAdamState": ScaleByAdamState,
    "optax._src.transform.ScaleByScheduleState": ScaleByScheduleState,
    "optax._src.base.EmptyState": EmptyState,
}
_JAX_SIDE = ("jax", "jaxlib", "flax", "optax", "chex", "orbax")


class UnknownJaxClassError(pickle.UnpicklingError):
    """A checkpoint names a class of jax, flax or optax that
    :data:`JAX_PICKLE_CLASSES` has no stand-in for."""


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        path = f"{module}.{name}"
        if path in JAX_PICKLE_CLASSES:
            return JAX_PICKLE_CLASSES[path]
        if module.split(".")[0] in _JAX_SIDE:
            raise UnknownJaxClassError(
                f"the checkpoint names {path}, which has no stand-in in "
                "gens_torch.convert.JAX_PICKLE_CLASSES")
        return super().find_class(module, name)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a JAX (or port) checkpoint, a pickle file or an orbax
    directory; its ``params`` stay numpy arrays, an optax ``opt_state``
    comes back as the stand-ins of :data:`JAX_PICKLE_CLASSES`."""
    if os.path.isdir(path):
        # imported here: the orbax reader builds this module's stand-ins
        from gens_torch.train.orbax import load_orbax_checkpoint
        payload = load_orbax_checkpoint(path)
    else:
        with open(path, "rb") as f:
            payload = _CheckpointUnpickler(f).load()
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path} is not a GenS checkpoint (no 'params')")
    payload.setdefault("format_version", 1)
    return payload


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _inner(tree):
    return tree["params"] if "params" in tree else tree


def _conv2d(k) -> torch.Tensor:
    return _t(k).permute(3, 2, 0, 1).contiguous()


def _conv_transpose2d(k) -> torch.Tensor:
    return _t(k).permute(2, 3, 0, 1).flip(2, 3).contiguous()


def _conv3d(k) -> torch.Tensor:
    k = _t(k)  # (3 ky, 3 kz, 3C, out) = [w_up | w_mid | w_dn]
    c = k.shape[2] // 3
    w_up, w_mid, w_dn = k[:, :, :c], k[:, :, c:2 * c], k[:, :, 2 * c:]
    w = torch.stack([w_dn, w_mid, w_up], dim=0)  # (kx, ky, kz, C, out)
    return w.permute(4, 3, 0, 1, 2).contiguous()


def _feature_state(tree, prefix: str) -> Dict[str, torch.Tensor]:
    p = _inner(tree)
    out = {}
    for name, sub in p.items():
        m = re.fullmatch(r"(ConvBlock|DeconvBlock|Conv)_(\d+)", name)
        if m is None:
            raise KeyError(f"unexpected feature-net param {name!r}")
        kind, i = m.group(1), int(m.group(2))
        if kind == "ConvBlock":
            out[f"{prefix}.enc.{i}.conv.weight"] = _conv2d(
                sub["Conv_0"]["kernel"])
        elif kind == "DeconvBlock":
            out[f"{prefix}.dec.{i}.weight"] = _conv_transpose2d(
                sub["ConvTranspose_0"]["kernel"])
        else:
            out[f"{prefix}.heads.{i}.weight"] = _conv2d(sub["kernel"])
    return out


def _leaves(tree, path=()):
    """(path, leaf) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


_BN_PARAM = {"scale": "weight", "bias": "bias"}
_BN_STAT = {"mean": "running_mean", "var": "running_var"}


def mnasnet_state(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A MnasNet ``{"params", "batch_stats"}`` tree (the feature network's,
    or the encoder's alone as the ``pretrained_path`` pickle holds it) ->
    the port module's state dict, keys prefixed by ``prefix``."""
    out = {}
    for (*mods, leaf), a in _leaves(tree["params"]):
        if mods[-1] == "bn":
            out[".".join(mods) + "." + _BN_PARAM[leaf]] = _t(a)
        elif mods[-1] == "ConvTranspose_0" and leaf == "kernel":
            out[".".join(mods[:-1]) + ".weight"] = _conv_transpose2d(a)
        elif leaf == "kernel" and (mods[-1] == "conv" or re.fullmatch(
                r"out_layer\d", mods[-1])):
            out[".".join(mods) + ".weight"] = _conv2d(a)
        else:
            raise KeyError(f"unexpected mnasnet param {'/'.join(mods)}/{leaf}")
    for (*mods, leaf), a in _leaves(tree.get("batch_stats", {})):
        out[".".join(mods) + "." + _BN_STAT[leaf]] = _t(a)
    return {prefix + k: v for k, v in out.items()}


def _dense(prefix: str, sub) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(sub["kernel"]).t().contiguous(),
            f"{prefix}.bias": _t(sub["bias"])}


def _global_attn_state(tree) -> Dict[str, torch.Tensor]:
    out = {}
    for name, sub in tree.items():
        pre = f"reg.global_attn.{name}"
        if name in ("norm1", "norm2"):
            out[f"{pre}.weight"] = _t(sub["scale"])
            out[f"{pre}.bias"] = _t(sub["bias"])
        else:
            out.update(_dense(pre, sub))
    return out


def _agg_state(tree) -> Dict[str, torch.Tensor]:
    out = {}
    for name, sub in _inner(tree).items():
        if re.fullmatch(r"agg_mlp_\d+_(hidden|out)", name) is None:
            raise KeyError(f"unexpected agg param {name!r}")
        out.update(_dense(f"agg.{name}", sub))
    return out


def _reg_state(tree) -> Dict[str, torch.Tensor]:
    out = {}
    for name, sub in _inner(tree).items():
        if name == "GlobalAttn_0":
            out.update(_global_attn_state(sub))
            continue
        m = re.fullmatch(r"(?:Checkpoint)?(Conv3dBlock|Upsample3dBlock)_(\d+)",
                         name)
        if m is None:
            raise KeyError(f"unexpected reg-net param {name!r}")
        i = int(m.group(2))
        if m.group(1) == "Conv3dBlock":
            out[f"reg.blocks.{i}.weight"] = _conv3d(sub["kernel"])
            if "bias" in sub:
                out[f"reg.blocks.{i}.bias"] = _t(sub["bias"])
        else:
            out[f"reg.ups.{i}.conv.weight"] = _conv3d(
                sub["Conv3dBlock_0"]["kernel"])
    return out


def sdf_state(tree, prefix: str = "sdf.") -> Dict[str, torch.Tensor]:
    """The ``sdf`` subtree alone; ``prefix=""`` for a bare SDFNetwork."""
    out = {}
    for name, sub in _inner(tree).items():
        for leaf in ("v", "g", "b"):
            if leaf in sub:
                out[f"{prefix}{name}.{leaf}"] = _t(sub[leaf])
    return out


def _blending_state(tree) -> Dict[str, torch.Tensor]:
    out = {}
    for name, sub in _inner(tree).items():
        if name == "s":
            out["blending.s"] = _t(sub)
            continue
        if re.fullmatch(r"lin\d+", name):  # the idr head
            out.update({f"blending.{name}.{leaf}": _t(a)
                        for leaf, a in sub.items()})
            continue
        i = int(re.fullmatch(r"MLP_(\d+)", name).group(1))
        for dname, dense in sub.items():
            j = int(re.fullmatch(r"Dense_(\d+)", dname).group(1))
            pre = f"blending.mlps.{i}.layers.{j}"
            out[f"{pre}.weight"] = _t(dense["kernel"]).t().contiguous()
            out[f"{pre}.bias"] = _t(dense["bias"])
    return out


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX GenS param tree (numpy leaves) -> ``GenSModel`` state dict, f32."""
    state = {}
    for top in ("feature", "match_feature"):
        if "encoder" in _inner(tree[top]):
            state.update(mnasnet_state(tree[top], f"{top}."))
        else:
            state.update(_feature_state(tree[top], top))
    if "agg" in tree:
        state.update(_agg_state(tree["agg"]))
    state.update(_reg_state(tree["reg"]))
    state.update(sdf_state(tree["sdf"]))
    state.update(_blending_state(tree["blending"]))
    state["variance.variance"] = _t(_inner(tree["variance"])["variance"])
    return state


FINETUNE_ARRAYS = ("volumes", "mask_volumes", "features")
FINETUNE_MODULES = ("sdf", "blending", "variance")


def _mlp_state(tree) -> Dict[str, torch.Tensor]:
    state = sdf_state(tree["sdf"])
    state.update(_blending_state(tree["blending"]))
    state["variance.variance"] = _t(_inner(tree["variance"])["variance"])
    return state


def finetune_params_from_jax(tree: Dict[str, Any]
                             ) -> Tuple[Dict[str, torch.Tensor],
                                        Dict[str, List[torch.Tensor]]]:
    """A finetune-format JAX ``params`` tree -> (the state of the model's
    sdf, blending and variance modules, {volumes, mask_volumes, features}
    as f32 tensor lists)."""
    arrays = {k: [_t(a) for a in tree[k]] for k in FINETUNE_ARRAYS}
    return _mlp_state(tree), arrays


def finetune_params_to_jax(model: torch.nn.Module,
                           arrays: Dict[str, Sequence[torch.Tensor]]
                           ) -> Dict[str, Any]:
    """The inverse of :func:`finetune_params_from_jax`: the model's sdf,
    blending and variance modules and the finetune arrays as the JAX
    finetune ``params`` tree (numpy f32)."""
    tree = params_to_jax({k: v for k, v in model.state_dict().items()
                          if k.split(".")[0] in FINETUNE_MODULES})
    tree.update({k: [_np(a) for a in arrays[k]] for k in FINETUNE_ARRAYS})
    return tree


def load_params(model: torch.nn.Module, source) -> Dict[str, Any]:
    """Load a checkpoint (its path, or the payload :func:`load_checkpoint`
    returned) into ``model``; every parameter must be matched. Returns the
    payload."""
    payload = load_checkpoint(source) if isinstance(source, str) else source
    state = params_from_jax(payload["params"])
    model.load_state_dict(state, strict=True)
    return payload


# -- port state dict -> JAX tree (the inverse of the maps above) --------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def _set(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _conv2d_to_jax(w: torch.Tensor) -> np.ndarray:
    return _np(w.permute(2, 3, 1, 0))


def _conv_transpose2d_to_jax(w: torch.Tensor) -> np.ndarray:
    return _np(w.flip(2, 3).permute(2, 3, 0, 1))


def _conv3d_to_jax(w: torch.Tensor) -> np.ndarray:
    w = w.permute(2, 3, 4, 1, 0)  # (kx, ky, kz, C, out)
    return _np(torch.cat([w[2], w[1], w[0]], dim=2))  # [w_up|w_mid|w_dn]


_TO_JAX = [
    (r"(feature|match_feature)\.enc\.(\d+)\.conv\.weight",
     lambda m: (m[1], "params", f"ConvBlock_{m[2]}", "Conv_0", "kernel"),
     _conv2d_to_jax),
    (r"(feature|match_feature)\.dec\.(\d+)\.weight",
     lambda m: (m[1], "params", f"DeconvBlock_{m[2]}", "ConvTranspose_0",
                "kernel"), _conv_transpose2d_to_jax),
    (r"(feature|match_feature)\.heads\.(\d+)\.weight",
     lambda m: (m[1], "params", f"Conv_{m[2]}", "kernel"), _conv2d_to_jax),
    (r"(feature|match_feature)\.encoder\.(.+)\.conv\.weight",
     lambda m: (m[1], "params", "encoder", *m[2].split("."), "conv",
                "kernel"), _conv2d_to_jax),
    (r"(feature|match_feature)\.encoder\.(.+)\.bn\.(weight|bias)",
     lambda m: (m[1], "params", "encoder", *m[2].split("."), "bn",
                {"weight": "scale", "bias": "bias"}[m[3]]), _np),
    (r"(feature|match_feature)\.encoder\.(.+)\.bn\.running_(mean|var)",
     lambda m: (m[1], "batch_stats", "encoder", *m[2].split("."), "bn",
                m[3]), _np),
    (r"(feature|match_feature)\.(decod_layer\d)\.weight",
     lambda m: (m[1], "params", m[2], "ConvTranspose_0", "kernel"),
     _conv_transpose2d_to_jax),
    (r"(feature|match_feature)\.(out_layer\d)\.weight",
     lambda m: (m[1], "params", m[2], "kernel"), _conv2d_to_jax),
    (r"agg\.(agg_mlp_\d+_(?:hidden|out))\.weight",
     lambda m: ("agg", "params", m[1], "kernel"), lambda w: _np(w.t())),
    (r"agg\.(agg_mlp_\d+_(?:hidden|out))\.bias",
     lambda m: ("agg", "params", m[1], "bias"), _np),
    (r"reg\.global_attn\.(norm\d)\.(weight|bias)",
     lambda m: ("reg", "params", "GlobalAttn_0", m[1],
                {"weight": "scale", "bias": "bias"}[m[2]]), _np),
    (r"reg\.global_attn\.(\w+)\.weight",
     lambda m: ("reg", "params", "GlobalAttn_0", m[1], "kernel"),
     lambda w: _np(w.t())),
    (r"reg\.global_attn\.(\w+)\.bias",
     lambda m: ("reg", "params", "GlobalAttn_0", m[1], "bias"), _np),
    (r"reg\.blocks\.(\d+)\.weight",
     lambda m: ("reg", "params", f"CheckpointConv3dBlock_{m[1]}", "kernel"),
     _conv3d_to_jax),
    (r"reg\.blocks\.(\d+)\.bias",
     lambda m: ("reg", "params", f"CheckpointConv3dBlock_{m[1]}", "bias"),
     _np),
    (r"reg\.ups\.(\d+)\.conv\.weight",
     lambda m: ("reg", "params", f"CheckpointUpsample3dBlock_{m[1]}",
                "Conv3dBlock_0", "kernel"), _conv3d_to_jax),
    (r"sdf\.(lin\d+)\.(v|g|b)",
     lambda m: ("sdf", "params", m[1], m[2]), _np),
    (r"blending\.(lin\d+)\.(v|g|b)",
     lambda m: ("blending", "params", m[1], m[2]), _np),
    (r"blending\.mlps\.(\d+)\.layers\.(\d+)\.weight",
     lambda m: ("blending", "params", f"MLP_{m[1]}", f"Dense_{m[2]}",
                "kernel"), lambda w: _np(w.t())),
    (r"blending\.mlps\.(\d+)\.layers\.(\d+)\.bias",
     lambda m: ("blending", "params", f"MLP_{m[1]}", f"Dense_{m[2]}",
                "bias"), _np),
    (r"blending\.s", lambda m: ("blending", "params", "s"), _np),
    (r"variance\.variance",
     lambda m: ("variance", "params", "variance"), _np),
]


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``GenSModel`` state dict -> JAX GenS param tree (numpy f32)."""
    tree: Dict[str, Any] = {}
    for name, value in state.items():
        for pattern, path, fn in _TO_JAX:
            m = re.fullmatch(pattern, name)
            if m is not None:
                _set(tree, path(m), fn(value))
                break
        else:
            raise KeyError(f"no JAX name for port parameter {name!r}")
    return tree
