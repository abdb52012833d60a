"""Build the port's CUDA kernels at first use.

Each kernel source in ``gens_torch/csrc/`` has a plain C interface; it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/gens_torch/`` (named by the
hash of the source and of every ``csrc/`` header it includes, so an edited
source or header rebuilds) and loaded with ctypes by the module that wraps
it. The libraries link no libcuda: the TMA kernels look
``cuTensorMapEncodeTiled`` up in it with ``dlopen`` (``-ldl``).
:func:`build_libraries` starts one ``nvcc`` per source at once. Nothing here
runs when the module is imported.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "gens_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-ldl"]
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels build from gens_torch/csrc "
                       "with the CUDA toolkit (CUDA_HOME or PATH)")


def source_files(source: str) -> List[str]:
    """``csrc/<source>`` and every ``csrc/`` header it includes with
    quotes, directly or through another header, in a fixed order."""
    seen, todo = set(), [source]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return sorted(seen)


def library_path(source: str) -> str:
    """Where the library of ``csrc/<source>``'s current text (and its
    headers') is built."""
    h = hashlib.sha1()
    for name in source_files(source):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    digest = h.hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build_libraries(sources: Sequence[str]
                    ) -> Dict[str, Tuple[str, Optional[float], str]]:
    """Compile every ``csrc/<source>`` not built yet, one ``nvcc`` process
    each, all started together. Returns {source: (path, build seconds or
    None when it existed, nvcc's ptxas report)}; raises if one fails."""
    out, running = {}, {}
    for source in sources:
        path = library_path(source)
        if os.path.exists(path):
            out[source] = (path, None, "")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        src = os.path.join(CSRC_DIR, source)
        proc = subprocess.Popen([nvcc()] + NVCC_FLAGS + ["-o", tmp, src]
                                + LINK_FLAGS,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running[source] = (proc, path, tmp, time.perf_counter())
    errors = []
    for source, (proc, path, tmp, t0) in running.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on csrc/{source}:\n{err}")
            continue
        os.replace(tmp, path)
        out[source] = (path, time.perf_counter() - t0, err)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_library(source: str) -> Tuple[str, Optional[float], str]:
    """Compile ``csrc/<source>`` unless its library exists (see
    :func:`build_libraries`)."""
    return build_libraries([source])[source]
