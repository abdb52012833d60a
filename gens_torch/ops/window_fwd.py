"""K2: the bilinear forward of the volume aggregation under ``splat_impl``
"kernel2f" -- the CUDA kernel ``csrc/window_fwd.cu`` and its plain PyTorch
version.

Counterpart of ``bilerp_window_fwd`` in gens_tpu/ops/pallas_splat.py, the
windowed hat-matrix forward. For each query (u, v) of ``xy (N, 2)`` on an
``image (H, W, C)``::

    vals[n, k] = sum_q hat_u(n, q) * sum_p R(hat_v(n, p)) * img[p, q, k]

with hat(t) = max(0, 1 - |t|) against the integer column q or row p and
zeros padding. ``mm_dtype="bfloat16"`` is the TPU kernel's operand rounding:
the image and hat_v are rounded to bf16 (round-to-nearest-even), hat_u is
not, and the sums are f32; ``"float32"`` is the exact bilerp. The TPU
kernel's window is a VMEM device: on every query it covers, its value is
this windowless formula, so the window, ``required_window`` and its guards
are not ported. A query outside (-1, W) x (-1, H), or with a non-finite
coordinate, gives exactly 0.

:func:`bilerp_window_fwd` launches the kernel for CUDA tensors and takes
:func:`window_fwd_plain` only for tensors on the CPU; any other device
raises. The counter ``k2.launches`` (``utils/profiling.py``) counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from gens_torch.utils import libraries
from gens_torch.utils.profiling import count

MM_DTYPES = ("float32", "bfloat16")


def _check_mm_dtype(mm_dtype: str) -> None:
    if mm_dtype not in MM_DTYPES:
        raise ValueError(f"mm_dtype must be one of {MM_DTYPES}, got {mm_dtype!r}")


def _operand(image: torch.Tensor, mm_dtype: str) -> torch.Tensor:
    """The image in the kernel's operand dtype, contiguous."""
    dt = torch.bfloat16 if mm_dtype == "bfloat16" else torch.float32
    return image.to(dt).contiguous()


def window_fwd_plain(image: torch.Tensor, xy: torch.Tensor,
                     mm_dtype: str = "float32") -> torch.Tensor:
    """The kernel's function in torch ops, in the kernel's order of
    operations. Returns (N, C) f32."""
    _check_mm_dtype(mm_dtype)
    H, W, C = image.shape
    flat = _operand(image, mm_dtype).float().reshape(H * W, C)
    x, y = xy[:, 0].float(), xy[:, 1].float()
    live = (x > -1) & (x < W) & (y > -1) & (y < H)  # NaN is not live
    # dead queries take (0, 0) before the long() conversion; their value is
    # zeroed at the end
    x = torch.where(live, x, torch.zeros_like(x))
    y = torch.where(live, y, torch.zeros_like(y))
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = x0f.long(), y0f.long()
    wu = [torch.clamp(1.0 - (x - (x0f + d)).abs(), min=0.0) for d in (0, 1)]
    wv = [torch.clamp(1.0 - (y - (y0f + d)).abs(), min=0.0) for d in (0, 1)]
    if mm_dtype == "bfloat16":
        wv = [w.to(torch.bfloat16).float() for w in wv]

    def corner(dy, dx):
        iy, ix = y0 + dy, x0 + dx
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        v = flat[iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)]
        return torch.where(valid[:, None], v, torch.zeros_like(v))

    bv0, bv1 = wv[0][:, None], wv[1][:, None]
    m0 = bv0 * corner(0, 0) + bv1 * corner(1, 0)
    m1 = bv0 * corner(0, 1) + bv1 * corner(1, 1)
    vals = wu[0][:, None] * m0 + wu[1][:, None] * m1
    return torch.where(live[:, None], vals, torch.zeros_like(vals))


LIBRARY = libraries.Library("gens_torch/csrc/window_fwd.cu", {
    "bilerp_window_forward": (ctypes.c_int, [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])})


def _launch(image: torch.Tensor, xy: torch.Tensor,
            mm_dtype: str) -> torch.Tensor:
    if image.dim() != 3 or not image.is_floating_point():
        raise ValueError(f"K2 takes a float image (H, W, C), got "
                         f"{tuple(image.shape)} {image.dtype}")
    H, W, C = image.shape
    if xy.dtype != torch.float32 or xy.dim() != 2 or xy.shape[1] != 2 \
            or not xy.is_contiguous():
        raise ValueError(f"K2 takes contiguous f32 xy (N, 2), got "
                         f"{tuple(xy.shape)} {xy.dtype}")
    if image.device != xy.device:
        raise ValueError("K2 inputs must be on one device")
    img = _operand(image, mm_dtype)
    n = xy.shape[0]
    out = torch.empty((n, C), dtype=torch.float32, device=xy.device)
    if xy.data_ptr() % 8 or (C == 4 and (img.data_ptr() % (4 * img.element_size())
                                         or out.data_ptr() % 16)):
        raise ValueError("K2 reads xy as float2 and a 4-channel pixel as one "
                         "8-byte (bf16) or 16-byte (f32) load: they must be "
                         "aligned")
    lib = libraries.load(LIBRARY)
    libraries.check_launch("K2", lib.bilerp_window_forward(
        xy.data_ptr(), img.data_ptr(), out.data_ptr(), n, H, W, C,
        int(mm_dtype == "bfloat16"), libraries.stream(xy.device)))
    count("k2.launches")
    return out


def bilerp_window_fwd(image: torch.Tensor, xy: torch.Tensor,
                      mm_dtype: str = "bfloat16") -> torch.Tensor:
    """Bilinear sample of ``image (H, W, C)`` at pixel coords ``xy (N, 2)``
    with the operand rounding of ``mm_dtype``; (N, C) f32. CUDA tensors
    launch K2; CPU tensors take :func:`window_fwd_plain`."""
    _check_mm_dtype(mm_dtype)
    if libraries.cuda_path("K2", xy.device):
        return _launch(image, xy, mm_dtype)
    return window_fwd_plain(image, xy, mm_dtype)
