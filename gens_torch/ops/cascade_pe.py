"""K4: the SDF grid's cascade lookup and positional encoding -- the CUDA
kernel ``csrc/cascade_pe.cu`` and its plain PyTorch version.

Counterpart of the lookup + PE that gens_tpu/ops/pallas_mlp.py::sdf_fused_fn
runs in XLA ahead of the Pallas MLP (``lookup_volume_cascade_packed``, then
``positional_encoding`` of the features and of ``pts * scale``); the JAX
package has no Pallas kernel for it. :func:`cascade_pe` writes K3's two
inputs, ``x_pe`` and ``feats_pe``, in the layouts K3 takes.

:func:`cascade_pe` launches the kernel for CUDA tensors and takes
:func:`cascade_pe_plain` only when every tensor is on the CPU; on any other
device, and on inputs the kernel does not take (dtype, contiguity, mixed
devices, more than ``MAX_SCALES`` scales), it raises. The counter
``k4.launches`` (``utils/profiling.py``) counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from gens_torch.models.embedder import (positional_encoding,
                                        positional_encoding_dim)
from gens_torch.ops.interp import lookup_volume_cascade
from gens_torch.utils import libraries
from gens_torch.utils.profiling import count

MAX_SCALES = 8
MAX_MULTIRES = 30
DTYPES = (torch.float32, torch.bfloat16)


def cascade_pe_plain(pts: torch.Tensor, volumes: Sequence[torch.Tensor],
                     scale: float, multires: int, feat_multires: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(PE(pts·scale) (N, 3(1+2 multires)), PE(cascade features)
    (N, ΣC_i (1+2 feat_multires))), f32: ``SDFNetwork.encode`` on a
    cascade already in its lookup dtype."""
    feats = lookup_volume_cascade(volumes, pts).float()
    return (positional_encoding(pts * scale, multires),
            positional_encoding(feats, feat_multires))


def check_inputs(pts: torch.Tensor, volumes: Sequence[torch.Tensor],
                 multires: int, feat_multires: int) -> None:
    """Raise ValueError on what the kernel does not take."""
    if not 1 <= len(volumes) <= MAX_SCALES:
        raise ValueError(f"K4 takes 1 to {MAX_SCALES} scales, got "
                         f"{len(volumes)}")
    if max(multires, feat_multires) > MAX_MULTIRES:
        raise ValueError(f"K4 takes multires up to {MAX_MULTIRES}")
    if (pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[1] != 3
            or not pts.is_contiguous()):
        raise ValueError(f"K4 takes contiguous f32 (N, 3) points, got "
                         f"{tuple(pts.shape)} {pts.dtype}")
    dtypes = {v.dtype for v in volumes}
    if len(dtypes) != 1 or dtypes.pop() not in DTYPES:
        raise ValueError(f"K4 takes a cascade all f32 or all bf16, got "
                         f"{[v.dtype for v in volumes]}")
    for v in volumes:
        if v.dim() != 4 or not v.is_contiguous():
            raise ValueError(f"K4 takes contiguous (X, Y, Z, C) volumes, got "
                             f"{tuple(v.shape)} with strides {v.stride()}")
    devices = {pts.device, *(v.device for v in volumes)}
    if len(devices) != 1 or pts.device.type != "cuda":
        raise ValueError(f"K4 has no path for devices "
                         f"{sorted(map(str, devices))}: every tensor on one "
                         f"CUDA device, or all on the CPU")


LIBRARY = libraries.Library("gens_torch/csrc/cascade_pe.cu", {
    "cascade_pe_forward": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])})


def _launch(pts: torch.Tensor, volumes: Sequence[torch.Tensor], scale: float,
            multires: int, feat_multires: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    n, s = pts.shape[0], len(volumes)
    c_total = sum(v.shape[3] for v in volumes)
    x_pe = torch.empty((n, positional_encoding_dim(multires, 3)),
                       dtype=torch.float32, device=pts.device)
    feats_pe = torch.empty((n, positional_encoding_dim(feat_multires,
                                                       c_total)),
                           dtype=torch.float32, device=pts.device)
    libraries.check_launch("K4", libraries.load(LIBRARY).cascade_pe_forward(
        pts.data_ptr(), n, s, (ctypes.c_void_p * s)(
            *[v.data_ptr() for v in volumes]),
        (ctypes.c_int * (4 * s))(*[d for v in volumes for d in v.shape]),
        int(volumes[0].dtype == torch.bfloat16), scale, max(multires, 0),
        max(feat_multires, 0), x_pe.data_ptr(), feats_pe.data_ptr(),
        libraries.stream(pts.device)))
    count("k4.launches")
    return x_pe, feats_pe


def cascade_pe(pts: torch.Tensor, volumes: Sequence[torch.Tensor],
               scale: float, multires: int, feat_multires: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_pe, feats_pe) of ``pts (N, 3)`` on the cascade ``volumes``
    ((X, Y, Z, C) each, all f32 or all bf16), as :func:`cascade_pe_plain`.
    CUDA tensors launch the kernel; tensors all on the CPU take the plain
    version; anything else raises."""
    if all(t.device.type == "cpu" for t in (pts, *volumes)):
        return cascade_pe_plain(pts, volumes, scale, multires, feat_multires)
    check_inputs(pts, volumes, multires, feat_multires)
    return _launch(pts, volumes, scale, multires, feat_multires)
