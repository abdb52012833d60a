"""K1: the bilinear splat -- the CUDA kernel ``csrc/splat.cu``, its plain
PyTorch version -- and :class:`BilerpAggSplat`, the volume aggregation's
bilinear sampling whose backward is the splat.

Counterpart of gens_tpu/ops/pallas_splat.py (``splat_bilinear``,
``bilerp_agg_splat``, ``resolve_splat_impl``). The splat is the adjoint of
``bilerp``::

    dimg[y, x, c] = sum_n hat(v_n - y) * hat(u_n - x) * ct[n, c]

with zeros padding and hat(t) = max(0, 1 - |t|); a query whose cotangent
row is all zero contributes nothing. ``mm_dtype="bfloat16"`` reproduces the
TPU kernel's operand rounding, summed in f32, which depends on its
``layout``: "fused_u" (the shipped one) rounds each term as bf16(hat_v) *
bf16(hat_u * ct), "per_channel" (the r03 kernel) as bf16(hat_v * ct) *
bf16(hat_u). ``"float32"`` is the exact adjoint.

:func:`splat_bilinear` launches the kernel for CUDA tensors and takes
:func:`splat_plain` only for tensors on the CPU; any other device raises.
The counter ``k1.launches`` (``utils/profiling.py``) counts kernel
launches. Its ``dim`` says that
the queries are the aggregation's dim³ voxel grid, which the kernel walks
in 8³ bricks (:func:`brick_counts` reads how many took the shared tile).

``volume.splat_impl`` chooses the aggregation's sampling at the scales the
JAX Pallas kernels run (see :func:`resolve_splat_impl`): "kernel2" (and
"auto") a bf16 gather forward and K1 in the fused_u rounding; "kernel" the
same forward and K1 in the per_channel rounding; "kernel2f" K2
(``ops/window_fwd.py``) forward and K1 in the fused_u rounding; "adjoint"
the bf16 gather forward and the exact f32 adjoint, whatever
``splat_mm_dtype`` says.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gens_torch.ops.interp import bilerp
from gens_torch.ops.window_fwd import bilerp_window_fwd
from gens_torch.utils import libraries
from gens_torch.utils.profiling import count, span

MM_DTYPES = ("float32", "bfloat16")
LAYOUTS = ("fused_u", "per_channel")
SPLAT_IMPLS = ("kernel", "kernel2", "kernel2f", "adjoint")


def resolve_splat_impl(impl: str) -> str:
    """A ``volume.splat_impl`` value as one of :data:`SPLAT_IMPLS`. "auto"
    resolves to "kernel2", as the JAX function does on a TPU (on its CPU
    it resolves to "adjoint"): the port's aggregation keeps the shipped
    kernel's rounding on every device."""
    if impl == "auto":
        return "kernel2"
    if impl not in SPLAT_IMPLS:
        raise ValueError(f"splat_impl must be 'auto' or one of {SPLAT_IMPLS}, "
                         f"got {impl!r}")
    return impl


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _check_mm_dtype(mm_dtype: str, layout: str = "fused_u") -> None:
    if mm_dtype not in MM_DTYPES:
        raise ValueError(f"mm_dtype must be one of {MM_DTYPES}, got {mm_dtype!r}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")


def splat_plain(xy: torch.Tensor, ct: torch.Tensor, hw: Tuple[int, int],
                mm_dtype: str = "float32",
                layout: str = "fused_u") -> torch.Tensor:
    """The kernel's function in torch ops: four corner weights and one
    ``index_add_`` into an (H·W, C) image. Returns (H, W, C) f32."""
    _check_mm_dtype(mm_dtype, layout)
    H, W = hw
    C = ct.shape[1]
    ct = ct.float()
    x, y = xy[:, 0], xy[:, 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    # corners of queries outside (-1, W) x (-1, H) (NaN included) carry
    # zero weight: drop them before the long() conversion
    live = ((ct != 0).any(dim=1) & (x > -1) & (x < W) & (y > -1) & (y < H))
    x0f = torch.where(live, x0f, torch.zeros_like(x0f))
    y0f = torch.where(live, y0f, torch.zeros_like(y0f))
    x0, y0 = x0f.long(), y0f.long()
    idxs, terms = [], []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ix, iy = x0 + dx, y0 + dy
        valid = live & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        # hat weights as the TPU kernel evaluates them: 1 - |u - column|
        wu = torch.clamp(1.0 - (x - (x0f + dx)).abs(), min=0.0)
        wv = torch.clamp(1.0 - (y - (y0f + dy)).abs(), min=0.0)
        if mm_dtype == "bfloat16" and layout == "per_channel":
            t = _bf16(wv[:, None] * ct) * _bf16(wu)[:, None]
        elif mm_dtype == "bfloat16":
            t = _bf16(wv)[:, None] * _bf16(wu[:, None] * ct)
        else:
            t = wv[:, None] * (wu[:, None] * ct)
        terms.append(torch.where(valid[:, None], t, torch.zeros_like(t)))
        idxs.append(iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1))
    out = torch.zeros((H * W, C), dtype=torch.float32, device=ct.device)
    out.index_add_(0, torch.cat(idxs), torch.cat(terms))
    return out.reshape(H, W, C)


LIBRARY = libraries.Library("gens_torch/csrc/splat.cu", {
    "splat_bilinear_forward": (ctypes.c_int, [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
    "splat_vector_atomics": (ctypes.c_int, []),
    "splat_brick_counts": (ctypes.c_int, [ctypes.c_void_p])})


def vector_atomics() -> bool:
    """Whether the built kernel adds a float4 per corner (CUDA 12.1+)."""
    return bool(libraries.load(LIBRARY).splat_vector_atomics())


def brick_counts() -> Tuple[int, int]:
    """(bricks with a live corner, bricks among them whose footprint did not
    fit the shared tile and went straight to the image) over the launches
    since the last call, which zeroes both. Synchronises the device: for
    measurement only."""
    counts = (ctypes.c_ulonglong * 2)()
    libraries.check_launch("K1 brick counts", libraries.load(
        LIBRARY).splat_brick_counts(ctypes.addressof(counts)))
    return int(counts[0]), int(counts[1])


def _check_dim(n: int, dim: int) -> None:
    if dim < 0 or (dim > 0 and n != dim ** 3):
        raise ValueError(f"dim={dim}: the queries are not a dim³ grid "
                         f"({n} queries)")


def _launch(xy: torch.Tensor, ct: torch.Tensor, hw: Tuple[int, int],
            mm_dtype: str, layout: str, dim: int) -> torch.Tensor:
    if ct.dtype != torch.float32 or ct.dim() != 2 or not ct.is_contiguous():
        raise ValueError(f"K1 takes contiguous f32 ct (N, C), got "
                         f"{tuple(ct.shape)} {ct.dtype}")
    n, C = ct.shape
    if (xy.dtype != torch.float32 or tuple(xy.shape) != (n, 2)
            or not xy.is_contiguous()):
        raise ValueError(f"K1 takes contiguous f32 xy ({n}, 2), got "
                         f"{tuple(xy.shape)} {xy.dtype}")
    if ct.device != xy.device:
        raise ValueError("K1 inputs must be on one device")
    if xy.data_ptr() % 8 or (C == 4 and ct.data_ptr() % 16):
        raise ValueError("K1 reads xy as float2 and ct as float4: they must "
                         "be 8- and 16-byte aligned")
    H, W = int(hw[0]), int(hw[1])
    out = torch.zeros((H, W, C), dtype=torch.float32, device=xy.device)
    lib = libraries.load(LIBRARY)
    libraries.check_launch("K1", lib.splat_bilinear_forward(
        xy.data_ptr(), ct.data_ptr(), out.data_ptr(), n, H, W, C,
        int(mm_dtype == "bfloat16"), int(layout == "per_channel"), dim,
        libraries.stream(xy.device)))
    count("k1.launches")
    return out


def splat_bilinear(xy: torch.Tensor, ct: torch.Tensor, hw: Tuple[int, int],
                   mm_dtype: str = "float32", layout: str = "fused_u",
                   dim: int = 0) -> torch.Tensor:
    """Splat ``ct (N, C)`` at pixel coords ``xy (N, 2)`` into an (H, W, C)
    f32 image. ``dim`` > 0 says that the queries are the aggregation's
    dim³ voxel grid (x-major, z fastest), which the kernel walks in bricks;
    0 takes ``xy`` as unstructured. It changes the kernel's speed, never the
    image. CUDA tensors launch K1; CPU tensors take :func:`splat_plain`."""
    _check_mm_dtype(mm_dtype, layout)
    _check_dim(ct.shape[0], dim)
    if libraries.cuda_path("K1", xy.device):
        return _launch(xy, ct, hw, mm_dtype, layout, dim)
    return splat_plain(xy, ct, hw, mm_dtype, layout)


class BilerpAggSplat(torch.autograd.Function):
    """The volume aggregation's bilinear sampling of ``image (H, W, C)`` at
    ``xy (N, 2)``, whose backward splats the f32 cotangent into the image
    through :func:`splat_bilinear` (the counterpart of ``bilerp_agg_splat``,
    ``impl`` a resolved ``splat_impl``). The forward is ``bilerp`` of the
    bf16-rounded image, or, under "kernel2f", :func:`bilerp_window_fwd`
    with ``mm_dtype``'s rounding. The backward takes ``mm_dtype`` in the
    per_channel rounding under "kernel", the exact f32 adjoint under
    "adjoint", and the fused_u rounding otherwise; ``dim`` > 0 says that
    ``xy`` is a dim³ voxel grid (see :func:`splat_bilinear`). ``xy`` gets
    no gradient; only it is saved."""

    @staticmethod
    def forward(ctx, image, xy, mm_dtype, impl="kernel2", dim=0):
        ctx.save_for_backward(xy)
        ctx.dim = dim
        ctx.hw = (image.shape[0], image.shape[1])
        ctx.mm_dtype = "float32" if impl == "adjoint" else mm_dtype
        ctx.layout = "per_channel" if impl == "kernel" else "fused_u"
        if impl == "kernel2f":
            return bilerp_window_fwd(image, xy.contiguous(), mm_dtype)
        return bilerp(_bf16(image), xy)

    @staticmethod
    def backward(ctx, ct):
        (xy,) = ctx.saved_tensors
        xy, ct = xy.contiguous(), ct.float().contiguous()
        with span("gens/backward/splat"):
            dimg = splat_bilinear(xy, ct, ctx.hw, ctx.mm_dtype, ctx.layout,
                                  ctx.dim)
        return dimg, None, None, None, None


def bilerp_agg_splat(image: torch.Tensor, xy: torch.Tensor,
                     mm_dtype: str = "float32", impl: str = "kernel2",
                     dim: int = 0) -> torch.Tensor:
    return BilerpAggSplat.apply(image, xy, mm_dtype, resolve_splat_impl(impl),
                                dim)
