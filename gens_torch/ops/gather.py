"""P1, P2 and P3: the gather probes' kernels -- the CUDA kernels
``csrc/gather_probe.cu`` and their plain PyTorch versions.

Counterparts of the Pallas kernels of the TPU gather-cost probes:

* P1, ``vmem_gather_kernel`` (scripts/gather_probe.py:94):
  ``jnp.take(table, idx, axis=0)`` from a VMEM-resident table;
* P2, ``k_tala`` (scripts/gather_probe2.py:54): the same gather in the
  ``take_along_axis`` form;
* P3, ``k_onehot`` (scripts/gather_probe2.py:59): the gather as a one-hot
  bf16 matmul with f32 accumulation, cast to the table's dtype.

P1 and P2 compute one function, ``out[n] = table[idx[n]]``, and differ only
in how Mosaic lowers it; one CUDA kernel serves both, through two wrappers
(:func:`row_gather_take`, :func:`row_gather_take_along`) with two launch
counts. :func:`onehot_gather` is P3 on the tensor cores (wgmma, the
one-hot operand built in registers, the table streamed by TMA). Indices
outside [0, rows) are outside the probes' contract; the row gather clamps
them (as XLA's gather does) and the one-hot product gives a zero row for
them, in the kernels and in the plain versions alike.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for tensors on the CPU; any other device raises. The counters
``p1.launches``, ``p2.launches`` and ``p3.launches`` (``utils/profiling.py``)
count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from gens_torch.utils import libraries
from gens_torch.utils.profiling import count

DTYPES = (torch.float32, torch.bfloat16)
# the plain one-hot product builds its f32 one-hot (indices x table rows)
# in slices of at most this many elements (1 GiB)
_PLAIN_ELEMS = 1 << 28


def _check(table: torch.Tensor, idx: torch.Tensor, name: str) -> None:
    if table.dim() != 2 or table.dtype not in DTYPES \
            or not table.is_contiguous() or table.shape[0] < 1:
        raise ValueError(f"{name} takes a contiguous f32 or bf16 table "
                         f"(rows >= 1, W), got {tuple(table.shape)} "
                         f"{table.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{name} takes contiguous int32 idx (N,), got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if table.device != idx.device:
        raise ValueError(f"{name} inputs must be on one device")


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[clamp(idx, 0, rows - 1)]``; (N, W) in the table's dtype."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def onehot_gather_plain(table: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """``onehot(idx) @ bf16(table)`` with f32 sums, cast to the table's
    dtype; an index outside [0, rows) gives a zero row. The bf16 operands
    multiply exactly in f32, so an f32 matmul of them is the bf16 product
    with f32 accumulation."""
    rows = table.shape[0]
    operand = table.to(torch.bfloat16).float()
    cols = torch.arange(rows, device=idx.device)
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    step = max(1, _PLAIN_ELEMS // rows)
    for s in range(0, idx.shape[0], step):
        onehot = (idx[s:s + step, None].long() == cols[None]).float()
        out[s:s + step] = (onehot @ operand).to(table.dtype)
    return out


LIBRARY = libraries.Library("gens_torch/csrc/gather_probe.cu", {
    "row_gather": (ctypes.c_int, [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "onehot_gather": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "onehot_scratch_bytes": (ctypes.c_longlong, [ctypes.c_int] * 2)})


def copy_plan(row_bytes: int, *ptrs: int):
    """(grain, group) of the row-gather kernel: the largest power of two
    <= 16 that divides the row's bytes and every base address, and the
    threads per row -- a power of two from 4 to 32 covering the row's
    grain-sized units."""
    grain = 16
    while row_bytes % grain or any(p % grain for p in ptrs):
        grain //= 2
    units = -(-row_bytes // grain)
    group = 4
    while group < min(units, 32):
        group *= 2
    return grain, group


def _row_gather(table: torch.Tensor, idx: torch.Tensor, name: str,
                counter: str) -> torch.Tensor:
    _check(table, idx, name)
    if not libraries.cuda_path(name, idx.device):
        return row_gather_plain(table, idx)
    rows, width = table.shape
    out = torch.empty((idx.shape[0], width), dtype=table.dtype,
                      device=idx.device)
    row_bytes = width * table.element_size()
    grain, group = copy_plan(row_bytes, table.data_ptr(), out.data_ptr())
    libraries.check_launch(name, libraries.load(LIBRARY).row_gather(
        idx.data_ptr(), table.data_ptr(), out.data_ptr(), idx.shape[0], rows,
        row_bytes, grain, group, libraries.stream(idx.device)))
    count(counter)
    return out


def row_gather_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1, ``jnp.take(table, idx, axis=0)``: (N, W) in the table's dtype.
    CUDA tensors launch the row-gather kernel; CPU tensors take
    :func:`row_gather_plain`."""
    return _row_gather(table, idx, "row_gather_take", "p1.launches")


def row_gather_take_along(table: torch.Tensor, idx: torch.Tensor
                          ) -> torch.Tensor:
    """P2, ``take_along_axis(table, broadcast(idx[:, None]), axis=0)``: the
    same function and kernel as :func:`row_gather_take`, counted apart."""
    return _row_gather(table, idx, "row_gather_take_along", "p2.launches")


def onehot_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P3, ``onehot(idx) @ bf16(table)`` with f32 sums, cast to the table's
    dtype. CUDA tensors launch the tensor-core kernel (a bf16 pre-pass of
    the table into scratch, then the product; one launch is counted); CPU
    tensors take :func:`onehot_gather_plain`."""
    _check(table, idx, "onehot_gather")
    if not libraries.cuda_path("onehot_gather", idx.device):
        return onehot_gather_plain(table, idx)
    rows, width = table.shape
    lib = libraries.load(LIBRARY)
    out = torch.empty((idx.shape[0], width), dtype=table.dtype,
                      device=idx.device)
    # the pre-pass's bf16 table, transposed and padded (part of the call)
    scratch = torch.empty((lib.onehot_scratch_bytes(rows, width),),
                          dtype=torch.uint8, device=idx.device)
    libraries.check_launch("onehot_gather", lib.onehot_gather(
        idx.data_ptr(), table.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        idx.shape[0], rows, width, int(table.dtype == torch.bfloat16),
        libraries.stream(idx.device)))
    count("p3.launches")
    return out
