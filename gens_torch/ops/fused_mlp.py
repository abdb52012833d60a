"""K3: the fused, gradient-free SDF-MLP forward -- the CUDA kernel
``csrc/sdf_mlp.cu`` and its plain PyTorch version.

Counterpart of gens_tpu/ops/pallas_mlp.py (``sdf_mlp_fused``,
``sdf_fused_fn``). It serves dense SDF-grid evaluation for mesh extraction.

:func:`sdf_mlp_fused` launches the kernel for CUDA tensors and takes
:func:`sdf_mlp_plain` only for tensors on the CPU; any other device raises.
The kernel is compiled at first use with ``nvcc`` from ``csrc/sdf_mlp.cu``
into ``build/gens_torch/`` (named by the source's hash) and loaded with
ctypes. ``sdf_mlp_fused.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from gens_torch.config import SDFNetConfig
from gens_torch.ops.cuda_build import build_library

_INV_SQRT2 = 0.70710678118654752


@dataclass
class FoldedMLP:
    """The SDF MLP with weight norm folded in, as K3 takes it.

    ``weights``: per layer (W (in, out), b (out,)) f32; ``params``: all of
    them packed into one flat f32 tensor at ``w_off`` / ``b_off``;
    ``skip[l]``: layer l's input is [h, PE(x)] / √2 (+ feats)."""

    weights: List[Tuple[torch.Tensor, torch.Tensor]]
    params: torch.Tensor
    w_off: List[int]
    b_off: List[int]
    skip: List[int]
    d_x: int
    d_feat: int
    d_hidden: int


def fold_sdf_mlp(sdf_net, device=None) -> FoldedMLP:
    """Fold an ``SDFNetwork``'s weight norm into dense f32 (W, b) pairs and
    pack them for the kernel. Checks the layer structure the kernel's
    in-place input buffer relies on."""
    cfg: SDFNetConfig = sdf_net.cfg
    with torch.no_grad():
        weights = [(w.detach().float().contiguous(),
                    b.detach().float().contiguous())
                   for w, b in sdf_net.effective_weights()]
    if device is not None:
        weights = [(w.to(device), b.to(device)) for w, b in weights]
    d_x, d_feat = sdf_net.d_in_embedded, sdf_net.d_feat_embedded
    d_hidden = cfg.d_hidden
    skip = [int(l in cfg.skip_in) for l in range(len(weights))]
    if skip[0] or weights[0][0].shape[0] != d_x or d_x > d_hidden:
        raise ValueError("K3 needs layer 0 to read PE(x) alone, "
                         "no wider than d_hidden")
    for l in range(1, len(weights)):
        hidden = weights[l - 1][0].shape[1] + (d_x if skip[l] else 0)
        if hidden != d_hidden or weights[l][0].shape[0] != d_hidden + d_feat:
            raise ValueError(f"layer {l}: input is not [hidden {d_hidden} | "
                             f"feats {d_feat}]")
    flat, w_off, b_off, off = [], [], [], 0
    for w, b in weights:
        w_off.append(off)
        off += w.numel()
        b_off.append(off)
        off += b.numel()
        flat += [w.reshape(-1), b]
    return FoldedMLP(weights, torch.cat(flat).contiguous(), w_off, b_off,
                     skip, d_x, d_feat, d_hidden)


def sdf_mlp_plain(fm: FoldedMLP, x_pe: torch.Tensor,
                  feats_pe: torch.Tensor) -> torch.Tensor:
    """The same function as the kernel in torch ops: (N, d_out) raw head."""
    h = x_pe
    n = len(fm.weights)
    for l, (w, b) in enumerate(fm.weights):
        if fm.skip[l]:
            h = torch.cat([h, x_pe], dim=-1) * _INV_SQRT2
        if 0 < l:
            h = torch.cat([h, feats_pe], dim=-1)
        h = h @ w + b
        if l < n - 1:
            z = h * 100.0
            h = (torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-z.abs()))
                 ) / 100.0
    return h


# -- build and bind -----------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library("sdf_mlp.cu")[0])
        lib.sdf_mlp_forward.restype = ctypes.c_int
        lib.sdf_mlp_forward.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int]
            + [ctypes.POINTER(ctypes.c_int)] * 3
            + [ctypes.POINTER(ctypes.c_longlong)] * 2
            + [ctypes.c_void_p])
        lib.sdf_mlp_max_width.restype = ctypes.c_int
        lib.sdf_mlp_max_width.argtypes = []
        _lib = lib
    return _lib


def _launch(fm: FoldedMLP, x_pe: torch.Tensor, feats_pe: torch.Tensor
            ) -> torch.Tensor:
    lib = _load()
    n = x_pe.shape[0]
    for t, width in ((x_pe, fm.d_x), (feats_pe, fm.d_feat)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != n
                or t.shape[1] != width or not t.is_contiguous()):
            raise ValueError(f"K3 takes contiguous f32 ({n}, {width}) inputs, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if fm.params.device != x_pe.device or feats_pe.device != x_pe.device:
        raise ValueError("K3 inputs and weights must be on one device")
    widths = [w.shape[1] for w, _ in fm.weights]
    if max(widths) > lib.sdf_mlp_max_width():
        raise ValueError(f"K3 handles layers up to {lib.sdf_mlp_max_width()} "
                         f"wide, got {max(widths)}")
    L = len(fm.weights)
    ints = ctypes.c_int * L
    longs = ctypes.c_longlong * L
    out = torch.empty((n, widths[-1]), dtype=torch.float32,
                      device=x_pe.device)
    stream = torch.cuda.current_stream(x_pe.device).cuda_stream
    rc = lib.sdf_mlp_forward(
        x_pe.data_ptr(), feats_pe.data_ptr(), fm.params.data_ptr(),
        out.data_ptr(), n, L, fm.d_x, fm.d_feat, fm.d_hidden,
        ints(*[w.shape[0] for w, _ in fm.weights]), ints(*widths),
        ints(*fm.skip), longs(*fm.w_off), longs(*fm.b_off), stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {rc}")
    sdf_mlp_fused.launches += 1
    return out


def sdf_mlp_fused(fm: FoldedMLP, x_pe: torch.Tensor,
                  feats_pe: torch.Tensor) -> torch.Tensor:
    """Run K3 on pre-encoded inputs: x_pe (N, PE(xyz)), feats_pe
    (N, PE(feats)). Returns the (N, d_out) raw head (the caller divides the
    SDF channel by cfg.scale). CUDA tensors launch the kernel; CPU tensors
    take :func:`sdf_mlp_plain`."""
    if x_pe.device.type == "cuda":
        return _launch(fm, x_pe, feats_pe)
    if x_pe.device.type == "cpu":
        return sdf_mlp_plain(fm, x_pe, feats_pe)
    raise ValueError(f"K3 has no path for device {x_pe.device}")


sdf_mlp_fused.launches = 0


def sdf_fused_fn(sdf_net, volumes, fm: Optional[FoldedMLP] = None):
    """Gradient-free ``pts (N, 3) -> sdf (N,)`` for dense grid evaluation:
    cascade lookup + PE in torch, the MLP through :func:`sdf_mlp_fused`."""
    if fm is None:
        fm = fold_sdf_mlp(sdf_net, device=volumes[0].device)
    scale = sdf_net.cfg.scale

    def f(pts):
        with torch.no_grad():
            x_pe, feats_pe = sdf_net.encode(pts, volumes)
            out = sdf_mlp_fused(fm, x_pe.contiguous(), feats_pe.contiguous())
            return out[:, 0] / scale

    return f
