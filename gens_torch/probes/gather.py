"""Gather and scatter rates on the card: the port of the TPU gather-cost
probes ``scripts/gather_probe.py`` (E1-E3) and ``scripts/gather_probe2.py``
(A-C), with their shapes and their lists of rows.

    python -m gens_torch.probes.gather [--out F] [--iters K]

* E1: ``torch.index_select`` rate against (rows, width, dtype) from a table
  of 2^18 rows (XLA ``jnp.take`` in the TPU script).
* E2: P1, :func:`gens_torch.ops.gather.row_gather_take`, at 2^20 rows from
  the small tables the TPU script held in VMEM (here L2-resident).
* E3: ``index_select`` at two of E2's shapes.
* A: P2, :func:`~gens_torch.ops.gather.row_gather_take_along`, and P3,
  :func:`~gens_torch.ops.gather.onehot_gather`, at 2^20 rows.
* B: scatter-add rates, ``index_add_`` into a fresh zero table of 2^18 rows
  (XLA ``.at[].add`` on ``jnp.zeros``; the zero fill is timed with it, as
  there).
* C: bf16 narrow gathers with ``index_select`` across row counts.

E1 and C rows also carry P1 on the same table and indices (``"p1"``), so
the kernel's cost of a row gather stands beside the library's for every
row width and table size of the lists.

The library rows (E1, E3, B, C) are PyTorch calls, not kernels of the port;
each row names its route. Every row runs: the TPU scripts caught and
recorded Mosaic lowering errors, this probe catches nothing.

Timing: for each row, ``iters`` index sets jittered as the TPU scripts'
``timed()`` jitters them (``(idx + i) % rows``) are made before the clock
starts; one untimed pass over them, then CUDA events around a second pass
of the op alone, after a synchronize, divided by ``iters``. Each row reports
ms, rows/µs, the useful GB/s (gathered or scattered bytes over the time) and
the bound: the larger of the bytes the op must move (each input read once,
each output written once, table rows counted as this run's indices touch
them) over 3.35 TB/s and, for P3, its bf16 tensor-core operations over
989 TFLOP/s (H100 SXM). Each kernel row is checked equal to
``index_select`` on its first index set. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Callable, Dict, List

import torch

from gens_torch.ops import gather as gk

PEAK_BYTES = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# (log2 rows gathered, width, dtype) -- scripts/gather_probe.py:66-71
E1 = [(22, 4, "f32"), (22, 36, "f32"), (22, 36, "bf16"), (22, 128, "f32"),
      (21, 256, "f32"), (20, 512, "f32"), (20, 1024, "f32"),
      (20, 1024, "bf16"), (19, 2048, "bf16"), (17, 1024, "f32"),
      (15, 1024, "f32")]
# (table rows, width, dtype) -- gather_probe.py:114-116 and :138
E2 = [(4096, 128, "f32"), (4096, 108, "f32"), (729, 108, "f32"),
      (8192, 128, "bf16"), (32768, 128, "bf16")]
E3 = [(4096, 128, "f32"), (32768, 128, "bf16")]
# (kind, table rows, width, dtype) -- gather_probe2.py:87-93
A = [("tala", 4096, 128, "f32"), ("tala", 32768, 128, "bf16"),
     ("tala", 35937, 108, "bf16"), ("onehot", 729, 108, "f32"),
     ("onehot", 4096, 128, "f32")]
# (log2 rows, width, dtype) -- gather_probe2.py:115-117
B = [(22, 4, "f32"), (22, 36, "f32"), (22, 36, "bf16"), (20, 128, "f32"),
     (22, 1, "f32")]
# (log2 rows, width), bf16 -- gather_probe2.py:137
C = [(20, 36), (18, 36), (22, 108), (20, 108), (17, 108)]
LARGE_TABLE = 1 << 18  # E1, B and C
SMALL_N = 1 << 20      # E2, E3 and A


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn: Callable, args_list: List) -> float:
    """Mean ms of ``fn(a)`` over ``args_list``: one untimed pass, then CUDA
    events around a second pass, behind a synchronize."""
    for a in args_list:
        fn(a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for a in args_list:
        fn(a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(args_list)


def jittered(idx: torch.Tensor, rows: int, iters: int) -> List[torch.Tensor]:
    """The TPU scripts' per-iteration indices ``(idx + i) % rows``."""
    return [((idx.long() + i) % rows).to(torch.int32) for i in range(iters)]


def _row(ms: float, n: int, width: int, elem: int, n_bytes: float,
         flops: float = 0.0) -> Dict:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return {"ms": ms, "rows_per_us": n / (ms * 1e3),
            "useful_gbps": n * width * elem / 1e9 / (ms / 1e3),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def gather_row(op: Callable, route: str, table: torch.Tensor,
               idx: torch.Tensor, iters: int, onehot: bool = False) -> Dict:
    """Time ``op(table, idx_i)`` over the jittered index sets; check a kernel
    route against ``index_select`` first."""
    rows, width = table.shape
    n, elem = idx.shape[0], table.element_size()
    sets = jittered(idx, rows, iters)
    if not route.startswith("library"):
        got = op(table, sets[0])
        ref = torch.index_select(
            table.to(torch.bfloat16).to(table.dtype) if onehot else table, 0,
            sets[0])
        if not torch.equal(got, ref):
            raise AssertionError(f"{route} on {tuple(table.shape)} "
                                 f"{table.dtype} differs from index_select")
        del got, ref
    ms = cuda_ms(lambda ix: op(table, ix), sets)
    touched = int(torch.unique(sets[0]).numel())
    n_bytes = 4 * n + n * width * elem + touched * width * elem
    flops = 2.0 * n * rows * width if onehot else 0.0
    return {"route": route, **_row(ms, n, width, elem, n_bytes, flops),
            "table_rows_touched": touched}


def _index_select(table, ix):
    return torch.index_select(table, 0, ix)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser("gens_torch.probes.gather")
    p.add_argument("--out", default=None)
    p.add_argument("--iters", type=int, default=8)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the gather probe times the card: no CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = {"device": torch.cuda.get_device_name(0), "card": card_line(),
               "iters": args.iters, "e1": [], "e2": [], "e3": [], "a": [],
               "b": [], "c": []}

    def table_and_idx(rows, width, dt, n):
        table = torch.randn((rows, width), generator=g, device=dev,
                            dtype=DTYPES[dt])
        idx = torch.randint(0, rows, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        return table, idx

    def emit(key, tag, row):
        results[key].append(row)
        print(tag, json.dumps(row), flush=True)

    lib, p1 = "library torch.index_select", "P1 row_gather_take (CUDA)"

    def library_and_p1(table, idx):
        return {**gather_row(_index_select, lib, table, idx, args.iters),
                "p1": gather_row(gk.row_gather_take, p1, table, idx,
                                 args.iters)}

    for n_log, width, dt in E1:
        table, idx = table_and_idx(LARGE_TABLE, width, dt, 1 << n_log)
        emit("e1", "E1", {"rows": 1 << n_log, "width": width, "dtype": dt,
                          **library_and_p1(table, idx)})
    for rows, width, dt in E2:
        table, idx = table_and_idx(rows, width, dt, SMALL_N)
        emit("e2", "E2", {"table_rows": rows, "width": width, "dtype": dt,
                          **gather_row(gk.row_gather_take, p1, table, idx,
                                       args.iters)})
    for rows, width, dt in E3:
        table, idx = table_and_idx(rows, width, dt, SMALL_N)
        emit("e3", "E3", {"table_rows": rows, "width": width, "dtype": dt,
                          **gather_row(_index_select, lib, table, idx,
                                       args.iters)})
    for kind, rows, width, dt in A:
        table, idx = table_and_idx(rows, width, dt, SMALL_N)
        if kind == "tala":
            row = gather_row(gk.row_gather_take_along,
                             "P2 row_gather_take_along (CUDA)", table, idx,
                             args.iters)
        else:
            row = gather_row(gk.onehot_gather, "P3 onehot_gather (CUDA)",
                             table, idx, args.iters, onehot=True)
        emit("a", "A", {"kind": kind, "table_rows": rows, "width": width,
                        "dtype": dt, **row})
    for n_log, width, dt in B:
        n = 1 << n_log
        upd = torch.randn((n, width), generator=g, device=dev,
                          dtype=DTYPES[dt])
        idx = torch.randint(0, LARGE_TABLE, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        sets = jittered(idx, LARGE_TABLE, args.iters)

        def scatter(ix, upd=upd):
            out = torch.zeros((LARGE_TABLE, upd.shape[1]), dtype=upd.dtype,
                              device=dev)
            return out.index_add_(0, ix, upd)

        ms = cuda_ms(scatter, sets)
        elem = upd.element_size()
        n_bytes = 4 * n + n * width * elem + LARGE_TABLE * width * elem
        emit("b", "B", {"rows": n, "width": width, "dtype": dt,
                        "route": "library zeros + index_add_",
                        **_row(ms, n, width, elem, n_bytes)})
        del upd, sets
    for n_log, width in C:
        table, idx = table_and_idx(LARGE_TABLE, width, "bf16", 1 << n_log)
        emit("c", "C", {"rows": 1 << n_log, "width": width, "dtype": "bf16",
                        **library_and_p1(table, idx)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", args.out, flush=True)
    return results


if __name__ == "__main__":
    main()
