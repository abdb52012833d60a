"""gens_tpu's default checkpoint format, the orbax directory, read without
orbax, tensorstore, ``zstandard`` or jax.

``gens_tpu.train.checkpoint.save_checkpoint`` (``use_orbax=None``) writes
a payload through orbax's ``StandardCheckpointer``:

* ``_METADATA`` (JSON): ``tree_metadata`` maps each leaf's key path to its
  keys (``key_type`` 2 a dict key or a NamedTuple field, 1 a sequence
  index) and its ``value_type`` (``jax.Array``, ``np.ndarray``,
  ``scalar``, or ``None`` for an empty node: optax's ``MaskedNode`` and
  ``EmptyState``); ``use_ocdbt`` and ``use_zarr3`` say how the arrays are
  stored.
* Each leaf is a zarr v2 array named by its keys joined with ".": a
  ``<name>/.zarray`` (shape, chunks, dtype, order, fill value, compressor)
  and its chunks ``<name>/<i>.<j>...`` (``<name>/0`` for a shape-[]
  array), zstd-compressed. With ``use_ocdbt`` they are keys of the OCDBT
  store under the directory (:class:`~gens_torch.train.ocdbt.OcdbtStore`),
  else files of one directory per array.

:func:`load_orbax_checkpoint` rebuilds the payload in the form
``gens_torch.convert.load_checkpoint`` gives a pickle of it: numpy arrays
in their stored dtype (``epoch``, ``step`` and ``format_version`` as
shape-[] arrays, as the pickle's ``np.asarray`` makes them), lists for
sequences (a finetune checkpoint's ``volumes``, ``mask_volumes`` and
``features``), and an optax ``opt_state`` as the stand-ins of
``convert.JAX_PICKLE_CLASSES``, told apart by their fields' names (orbax
stores a NamedTuple as a dict), each label's chain of states a tuple.
Anything else raises :class:`UnsupportedOrbaxCheckpoint`, naming the key
and what was found.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from gens_torch.convert import (EmptyState, MaskedNode, MaskedState,
                                PartitionState, ScaleByAdamState,
                                ScaleByScheduleState)
from gens_torch.train.ocdbt import OcdbtStore
from gens_torch.utils.zstd import decompress

_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
_DTYPE_KINDS = "biuf"  # bool, int, uint, float


class UnsupportedOrbaxCheckpoint(ValueError):
    """An orbax checkpoint in a form this reader does not know: a zarr3
    array, another compressor or a filter, an unknown ``value_type``, a
    tree that is no optax state the port knows."""


class _DirectoryStore:
    """The arrays of a checkpoint written with ``use_ocdbt=False``: each
    key is a file under ``root``."""

    def __init__(self, root: str):
        self.root = root

    def __contains__(self, key: str) -> bool:
        return os.path.isfile(os.path.join(self.root, key))

    def read(self, key: str) -> bytes:
        with open(os.path.join(self.root, key), "rb") as f:
            return f.read()


def _fill(value, name: str):
    """A missing chunk's value: zarr's ``fill_value``, 0 when null."""
    if value is None:
        return 0
    if isinstance(value, (bool, int, float)):
        return value
    raise UnsupportedOrbaxCheckpoint(f"{name}: fill_value {value!r}")


def read_zarr_array(store, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``, its chunks assembled."""
    meta_key = f"{name}/.zarray"
    if meta_key not in store:
        if f"{name}/zarr.json" in store:
            raise UnsupportedOrbaxCheckpoint(
                f"{name}: a zarr3 array (zarr.json); only zarr v2 is read")
        raise UnsupportedOrbaxCheckpoint(f"{name}: no {meta_key}")
    meta = json.loads(store.read(meta_key))
    if meta.get("zarr_format") != 2:
        raise UnsupportedOrbaxCheckpoint(
            f"{name}: zarr_format {meta.get('zarr_format')!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise UnsupportedOrbaxCheckpoint(
            f"{name}: compressor {compressor!r}; only zstd and none are read")
    if meta.get("filters"):
        raise UnsupportedOrbaxCheckpoint(
            f"{name}: filters {meta['filters']!r}")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError as e:
        raise UnsupportedOrbaxCheckpoint(
            f"{name}: dtype {meta['dtype']!r}") from e
    if dtype.kind not in _DTYPE_KINDS or dtype.fields is not None:
        raise UnsupportedOrbaxCheckpoint(f"{name}: dtype {meta['dtype']!r}")
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    if order not in ("C", "F") or sep != ".":
        raise UnsupportedOrbaxCheckpoint(
            f"{name}: order {order!r}, dimension_separator {sep!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise UnsupportedOrbaxCheckpoint(
            f"{name}: chunks {list(chunks)} for shape {list(shape)}")
    out = np.empty(shape, dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*(len(g) for g in grid)) if shape else [()]:
        key = f"{name}/" + (sep.join(map(str, index)) if index else "0")
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        if key not in store:
            out[region] = _fill(meta.get("fill_value"), name)
            continue
        data = store.read(key)
        if compressor is not None:
            data = decompress(data)
        if len(data) != chunk_bytes:
            raise UnsupportedOrbaxCheckpoint(
                f"{key}: {len(data)} bytes, a chunk of {list(chunks)} "
                f"{dtype} has {chunk_bytes}")
        chunk = np.frombuffer(data, dtype).reshape(chunks, order=order)
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out


def _insert(tree: Dict, keys: List[Tuple[Any, int]], value, name: str):
    """Set ``value`` at ``keys`` in a tree of dicts; a sequence is a dict of
    int keys until :func:`_lists` turns it into a list."""
    node = tree
    for i, (key, key_type) in enumerate(keys):
        if key_type == 1:
            key = int(key)
        elif key_type != 2:
            raise UnsupportedOrbaxCheckpoint(f"{name}: key_type {key_type}")
        if i == len(keys) - 1:
            node[key] = value
        else:
            node = node.setdefault(key, {})
            if not isinstance(node, dict):
                raise UnsupportedOrbaxCheckpoint(f"{name}: a leaf above a "
                                                 "subtree")


def _lists(tree, name: str = ""):
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v, f"{name}.{k}".lstrip(".")) for k, v in tree.items()}
    ints = [k for k in out if isinstance(k, int)]
    if not ints:
        return out
    if len(ints) != len(out) or sorted(ints) != list(range(len(ints))):
        raise UnsupportedOrbaxCheckpoint(
            f"{name}: sequence indices {sorted(out, key=str)}")
    return [out[i] for i in range(len(ints))]


def _moments(tree):
    """An Adam moment tree, which has the params' tree: a ``None`` leaf is
    a masked-out parameter."""
    if tree is None:
        return MaskedNode()
    if isinstance(tree, dict):
        return {k: _moments(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_moments(v) for v in tree]
    return tree


def _optax(tree, name: str = "opt_state"):
    """The stand-ins of ``gens_tpu.train.step.make_optimizer``'s state
    (and of ``make_finetune_optimizer``'s), from orbax's dicts and lists;
    the chain of a label's states is a tuple."""
    if isinstance(tree, list):
        return tuple(_optax(v, f"{name}.{i}") for i, v in enumerate(tree))
    fields = set(tree) if isinstance(tree, dict) else None
    if fields == {"inner_states"}:
        return PartitionState({k: _optax(v, f"{name}.inner_states.{k}")
                               for k, v in tree["inner_states"].items()})
    if fields == {"inner_state"}:
        inner = tree["inner_state"]
        return MaskedState(EmptyState() if inner is None
                           else _optax(inner, f"{name}.inner_state"))
    if fields == {"count", "mu", "nu"}:
        return ScaleByAdamState(tree["count"], _moments(tree["mu"]),
                                _moments(tree["nu"]))
    if fields == {"count"}:
        return ScaleByScheduleState(tree["count"])
    found = sorted(fields) if fields is not None else type(tree).__name__
    raise UnsupportedOrbaxCheckpoint(f"{name}: an optimizer state of "
                                     f"{found}, which is no optax state the "
                                     "port knows")


def load_orbax_checkpoint(path: str) -> Dict[str, Any]:
    """Read the orbax checkpoint directory ``path`` into the payload a
    pickle of the same checkpoint gives (see the module's docstring)."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise UnsupportedOrbaxCheckpoint(f"{path}: no _METADATA (not an "
                                         "orbax checkpoint of this era)")
    with open(meta_path) as f:
        meta = json.load(f)
    if "tree_metadata" not in meta:
        raise UnsupportedOrbaxCheckpoint(f"{meta_path}: no tree_metadata")
    if meta.get("use_zarr3"):
        raise UnsupportedOrbaxCheckpoint(f"{meta_path}: use_zarr3 (only "
                                         "zarr v2 arrays are read)")
    store = (OcdbtStore(path) if meta.get("use_ocdbt", True)
             else _DirectoryStore(path))
    tree: Dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        name = ".".join(str(k) for k, _ in keys)
        value_meta = entry["value_metadata"]
        value_type = value_meta.get("value_type")
        if value_type == "None":
            if keys[0][0] != "opt_state":
                raise UnsupportedOrbaxCheckpoint(
                    f"{name}: an empty node outside the optimizer state")
            value = None
        elif value_type in _ARRAY_TYPES:
            if value_meta.get("skip_deserialize"):
                raise UnsupportedOrbaxCheckpoint(
                    f"{name}: an array saved with skip_deserialize")
            value = read_zarr_array(store, name)
        else:
            raise UnsupportedOrbaxCheckpoint(
                f"{name}: value_type {value_type!r}")
        _insert(tree, keys, value, name)
    payload = _lists(tree)
    if "opt_state" in payload:
        payload["opt_state"] = _optax(payload["opt_state"])
    return payload
