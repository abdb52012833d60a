"""K3: the fused, gradient-free SDF-MLP forward -- the CUDA kernel
``csrc/sdf_mlp.cu`` (tensor cores, 3xTF32) and its plain PyTorch version.

Counterpart of gens_tpu/ops/pallas_mlp.py (``sdf_mlp_fused``,
``sdf_fused_fn``). It serves dense SDF-grid evaluation for mesh extraction;
:func:`sdf_fused_fn` feeds it from K4 (``ops/cascade_pe.py``).

:func:`sdf_mlp_fused` launches the kernel for CUDA tensors and takes
:func:`sdf_mlp_plain` only for tensors on the CPU; any other device raises.
The counter ``k3.launches`` (``utils/profiling.py``) counts kernel
launches.

The kernel multiplies in 3xTF32: each operand v is split into
``hi = tf32_rna(v)`` and ``lo = tf32_rna(v - hi)`` and the product taken as
hi·hi + hi·lo + lo·hi with f32 sums. :func:`fold_sdf_mlp` splits the weights
once, on the host, into the packed K-major tiles the kernel streams
(:func:`pack_tc`); the kernel splits the activations in registers.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from gens_torch.config import SDFNetConfig
from gens_torch.ops.cascade_pe import cascade_pe
from gens_torch.utils import libraries
from gens_torch.utils.profiling import count, span

_INV_SQRT2 = 0.70710678118654752
TC_N = 136   # the kernel's wgmma width: every layer's outputs padded to it
TC_KS = 16   # weight K-rows per TMA stage (one 64-byte row of f32)


@dataclass
class FoldedMLP:
    """The SDF MLP with weight norm folded in, as K3 takes it.

    ``weights``: per layer (W (in, out), b (out,)) f32, the plain
    version's truth; ``skip[l]``: layer l's input is [h, PE(x)] / √2
    (+ feats); ``tc`` and ``bias``: the weights as the kernel takes them
    (:func:`pack_tc`), None when a layer is wider than ``TC_N``."""

    weights: List[Tuple[torch.Tensor, torch.Tensor]]
    skip: List[int]
    d_x: int
    d_feat: int
    d_hidden: int
    tc: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 explicit mantissa bits, the low 13 bits zero)
    to nearest, ties away from zero, as ``cvt.rna.tf32.f32``; inf and NaN
    pass unchanged."""
    b = x.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    finite = (b & 0x7F800000) != 0x7F800000
    r = torch.where(finite, (b + 0x1000) & 0xFFFFE000, b)
    r = torch.where(r >= 1 << 31, r - (1 << 32), r)
    return r.to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32_rna(x), lo = tf32_rna(x - hi)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def tc_k_alloc(weights) -> int:
    """Row length of the packed tiles: the widest K, rounded up to a k-step
    of 8, then to a TMA stage."""
    k_pad = max(-(-w.shape[0] // 8) * 8 for w, _ in weights)
    return -(-k_pad // TC_KS) * TC_KS


def pack_tc(weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weights as the kernel streams them: (2 L TC_N, ka) f32, layer l's
    hi tile at rows [2l TC_N, (2l+1) TC_N) and its lo tile after it, each
    W^T (K-major) split by :func:`split_tf32`, zero padded to TC_N outputs
    and ka = :func:`tc_k_alloc` inputs; and the biases, (L, TC_N) f32,
    zero padded."""
    ka = tc_k_alloc(weights)
    dev = weights[0][0].device
    tiles = torch.zeros((2 * len(weights) * TC_N, ka), dtype=torch.float32,
                        device=dev)
    bias = torch.zeros((len(weights), TC_N), dtype=torch.float32, device=dev)
    for l, (w, b) in enumerate(weights):
        k, n = w.shape
        hi, lo = split_tf32(w.t())
        tiles[2 * l * TC_N:2 * l * TC_N + n, :k] = hi
        tiles[(2 * l + 1) * TC_N:(2 * l + 1) * TC_N + n, :k] = lo
        bias[l, :n] = b
    return tiles, bias


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
    if max(w.shape[1] for w, _ in weights) > TC_N:
        return FoldedMLP(weights, skip, d_x, d_feat, d_hidden)
    return FoldedMLP(weights, skip, d_x, d_feat, d_hidden, *pack_tc(weights))


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


LIBRARY = libraries.Library("gens_torch/csrc/sdf_mlp.cu", {
    "sdf_mlp_forward": (ctypes.c_int, [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong] + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_void_p]),
    "sdf_mlp_max_width": (ctypes.c_int, [])})


def _launch(fm: FoldedMLP, x_pe: torch.Tensor, feats_pe: torch.Tensor
            ) -> torch.Tensor:
    lib = libraries.load(LIBRARY)
    n = x_pe.shape[0]
    for t, width in ((x_pe, fm.d_x), (feats_pe, fm.d_feat)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != n
                or t.shape[1] != width or not t.is_contiguous()):
            raise ValueError(f"K3 takes contiguous f32 ({n}, {width}) inputs, "
                             f"got {tuple(t.shape)} {t.dtype}")
    widths = [w.shape[1] for w, _ in fm.weights]
    if fm.tc is None or lib.sdf_mlp_max_width() != TC_N:
        raise ValueError(f"K3 handles layers up to {TC_N} wide, got "
                         f"{max(widths)}")
    if {fm.tc.device, fm.bias.device, feats_pe.device} != {x_pe.device}:
        raise ValueError("K3 inputs and weights must be on one device")
    L = len(fm.weights)
    ints = ctypes.c_int * L
    out = torch.empty((n, widths[-1]), dtype=torch.float32,
                      device=x_pe.device)
    libraries.check_launch("K3", lib.sdf_mlp_forward(
        x_pe.data_ptr(), feats_pe.data_ptr(), fm.tc.data_ptr(),
        fm.bias.data_ptr(), out.data_ptr(), n, L, fm.d_x, fm.d_feat,
        fm.d_hidden, fm.tc.shape[1],
        ints(*[w.shape[0] for w, _ in fm.weights]), ints(*widths),
        ints(*fm.skip), libraries.stream(x_pe.device)))
    count("k3.launches")
    return out


def sdf_mlp_fused(fm: FoldedMLP, x_pe: torch.Tensor,
                  feats_pe: torch.Tensor) -> torch.Tensor:
    """Run K3 on pre-encoded inputs: x_pe (N, PE(xyz)), feats_pe
    (N, PE(feats)). Returns the (N, d_out) raw head (the caller divides the
    SDF channel by cfg.scale). CUDA tensors launch the kernel; CPU tensors
    take :func:`sdf_mlp_plain`."""
    if libraries.cuda_path("K3", x_pe.device):
        return _launch(fm, x_pe, feats_pe)
    return sdf_mlp_plain(fm, x_pe, feats_pe)


def sdf_fused_fn(sdf_net, volumes, fm: Optional[FoldedMLP] = None):
    """Gradient-free ``pts (N, 3) -> sdf (N,)`` for dense grid evaluation:
    cascade lookup + PE through K4 (``ops/cascade_pe.py``, span
    ``gens/sdf/lookup``), the MLP through :func:`sdf_mlp_fused` (span
    ``gens/sdf/mlp``). ``sdf_network.volume_dtype`` bf16 rounds the cascade
    here, once, as ``SDFNetwork.encode`` does before its lookup."""
    if fm is None:
        fm = fold_sdf_mlp(sdf_net, device=volumes[0].device)
    c = sdf_net.cfg
    vdt = torch.bfloat16 if c.volume_dtype == "bfloat16" else None
    volumes = [v.detach().to(vdt or v.dtype).contiguous() for v in volumes]

    def f(pts):
        with torch.no_grad():
            with span("gens/sdf/lookup"):
                x_pe, feats_pe = cascade_pe(pts.contiguous(), volumes,
                                            c.scale, c.multires,
                                            c.feat_multires)
            with span("gens/sdf/mlp"):
                out = sdf_mlp_fused(fm, x_pe, feats_pe)
                return out[:, 0] / c.scale

    return f
