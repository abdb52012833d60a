"""The program's own spans (``gens_torch.utils.profiling``) under each
``gens/mesh/grid`` root of a traced run: the grid of a profiled scene,
since a recording profiler turns the program's spans on. A program
without the span log, or a run with no profiled scene, gives none."""

from __future__ import annotations

import sys
from typing import Dict, List

CHILDREN = {"gens/sdf/lookup": "lookup", "gens/sdf/mlp": "mlp",
            "gens/mesh/copy": "copy"}


def grid_roots(ctx) -> List[Dict[str, float]]:
    """Per grid root, oldest first: device ms of its lookup, mlp and copy
    spans summed (``lookup_ms``, ``mlp_ms``, ``copy_ms``), host ms inside
    its lookup and mlp spans (``enqueue_ms``), and the root's own device
    ms (``grid_ms``)."""
    if ctx.get("trace") is None:
        return []
    try:
        from gens_torch.utils.profiling import records
    except ImportError:
        return []
    rows: Dict[int, Dict[str, float]] = {}
    for r in records():
        kind = CHILDREN.get(r.path)
        root = r.root
        if root.path != "gens/mesh/grid":
            continue
        row = rows.setdefault(id(root), {"lookup_ms": 0.0, "mlp_ms": 0.0,
                                         "copy_ms": 0.0, "enqueue_ms": 0.0,
                                         "grid_ms": 0.0})
        if r is root:
            row["grid_ms"] = r.device_ms
        elif kind is not None:
            row[kind + "_ms"] += r.device_ms
            if kind != "copy":
                row["enqueue_ms"] += r.host_ms
    return list(rows.values())


def mean(rows: List[Dict[str, float]], key: str):
    return sum(r[key] for r in rows) / len(rows) if rows else None


def print_roots(rows: List[Dict[str, float]]) -> None:
    """Each root's numbers and the share of its span that its children
    cover, on standard error."""
    for i, r in enumerate(rows):
        covered = r["lookup_ms"] + r["mlp_ms"] + r["copy_ms"]
        share = 100.0 * covered / r["grid_ms"] if r["grid_ms"] else 0.0
        print(f"grid spans, profiled scene {i + 1}: "
              + ", ".join(f"{k} {v!r}" for k, v in r.items())
              + f", children cover {share:.2f}%", file=sys.stderr)
