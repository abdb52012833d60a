"""The import check of the benchmark.

    python benchmark/check_imports.py

Fails (exit 1) when a module that a run on the card imports has the
top-level name ``jax``, ``jaxlib``, ``flax`` or ``gens_tpu`` (names compared
whole: ``gens_torch`` is not ``gens_tpu``), or when the plain reference
(``benchmark/reference``) imports anything but the standard library, numpy
and torch: in particular nothing of ``gens_torch``.

Two looks: the import statements of every file under ``benchmark/``, and
``sys.modules`` of a fresh interpreter that has imported everything a run
imports (the harness, every loop, every metric reader, the reference and
the program's modules the loops call).
"""

import ast
import glob
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "gens_tpu"}
REFERENCE_MAY = {"__future__", "contextlib", "math", "typing", "numpy",
                 "torch"}
PROGRAM_MODULES = ("gens_torch.config", "gens_torch.models.gens",
                   "gens_torch.train.step", "gens_torch.mesh.extract")


def imported_names(path: str):
    """Top-level names of a file's imports (relative imports excluded)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def static_faults():
    faults = []
    for path in sorted(glob.glob(os.path.join(BENCH, "**", "*.py"),
                                 recursive=True)):
        rel = os.path.relpath(path, ROOT)
        names = set(imported_names(path))
        for name in sorted(names & FORBIDDEN):
            faults.append(f"{rel} imports {name}")
        if rel.startswith(os.path.join("benchmark", "reference")):
            for name in sorted(names - REFERENCE_MAY):
                faults.append(f"{rel} (the reference) imports {name}")
    return faults


LOADER = """
import glob, os, sys
bench, root = sys.argv[1], sys.argv[2]
sys.path[:0] = [bench, root]
from harness import core
for sub in ("loops", "metrics"):
    for p in sorted(glob.glob(os.path.join(bench, sub, "*.py"))):
        core.load_module(p)
import harness.compare, harness.flops, harness.scenes, harness.trace
import harness.weights, reference.gens_plain, reference.isosurface
import importlib
for m in sys.argv[3:]:
    importlib.import_module(m)
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def runtime_faults():
    out = subprocess.run([sys.executable, "-c", LOADER, BENCH, ROOT,
                          *PROGRAM_MODULES], capture_output=True, text=True,
                         check=True).stdout.split()
    return [f"a run loads {name}" for name in sorted(set(out) & FORBIDDEN)]


def main() -> int:
    faults = static_faults() + runtime_faults()
    for f in faults:
        print(f, file=sys.stderr)
    if not faults:
        print("no run imports jax, jaxlib, flax or gens_tpu; the reference "
              "imports nothing of gens_torch")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
