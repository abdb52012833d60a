"""The port's native libraries: where and when they build, how they are
bound, and which device takes which path.

A library is declared once, as a :class:`Library`: its source (a path from
the repository's root), the compiler's extra flags, a table of function
name -> (restype, argtypes) and an optional check of the loaded library.
:func:`load` builds it unless built, opens it with ctypes, applies the
table and keeps it for the process. The rules:

* A source builds into ``build/gens_torch/lib<stem>_<hash>.so``, the hash
  over the source and every header it includes with quotes (found beside
  it), so an edited source or header rebuilds and a built one never does.
  The compiler writes a temporary file that ``os.replace`` swaps in; a
  failed run raises with its stderr.
* ``.cu`` sources build with ``nvcc`` for ``sm_90a``; they link no libcuda
  (the TMA kernels look ``cuTensorMapEncodeTiled`` up with ``dlopen``,
  ``-ldl``). Host sources build with ``g++ -O3 <flags> -shared -fPIC``.
* The first load of any CUDA library builds every ``gens_torch/csrc/*.cu``
  not built yet, one ``nvcc`` each, all started together. A host library
  builds at its first load.

:func:`cuda_path` is every wrapper's device rule and :func:`check_launch`
its error rule. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = "gens_torch/csrc"
BUILD_DIR = os.path.join(ROOT, "build", "gens_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-ldl"]
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


@dataclass(frozen=True)
class Library:
    """A native library as data: ``source`` from the repository's root,
    ``functions`` name -> (restype, argtypes), the compiler's extra
    ``flags`` and a ``check`` run once on the loaded library."""

    source: str
    functions: Dict[str, Tuple[object, List[object]]] = field(
        default_factory=dict)
    flags: Tuple[str, ...] = ()
    check: Optional[Callable[[ctypes.CDLL], None]] = None


_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels build from "
                       "gens_torch/csrc with the CUDA toolkit (CUDA_HOME or "
                       "PATH)")


def source_files(source: str) -> List[str]:
    """``source`` and every header it includes with quotes, directly or
    through another header, as names in its directory, in a fixed order."""
    folder = os.path.dirname(os.path.join(ROOT, source))
    seen, todo = set(), [os.path.basename(source)]
    while todo:
        name = todo.pop()
        if name not in seen:
            seen.add(name)
            with open(os.path.join(folder, name), "rb") as f:
                todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return sorted(seen)


def library_path(source: str) -> str:
    """Where the library of ``source``'s current text (and its headers')
    is built."""
    folder = os.path.dirname(os.path.join(ROOT, source))
    h = hashlib.sha1()
    for name in source_files(source):
        with open(os.path.join(folder, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:12]}.so")


def cuda_libraries() -> List[Library]:
    return [Library(f"{CSRC}/{n}")
            for n in sorted(os.listdir(os.path.join(ROOT, CSRC)))
            if n.endswith(".cu")]


def build(libs: Sequence[Library]
          ) -> Dict[str, Tuple[str, Optional[float], str]]:
    """Compile every library of ``libs`` not built yet, one compiler each,
    all started together. Returns {source: (path, build seconds or None
    when it existed, the compiler's stderr)}; raises if one fails."""
    out, running = {}, {}
    for lib in {lib.source: lib for lib in libs}.values():
        path = library_path(lib.source)
        if os.path.exists(path):
            out[lib.source] = (path, None, "")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp, src = f"{path}.{os.getpid()}.tmp", os.path.join(ROOT, lib.source)
        cmd = ([nvcc(), *NVCC_FLAGS, *lib.flags, "-o", tmp, src, *LINK_FLAGS]
               if src.endswith(".cu") else
               ["g++", "-O3", *lib.flags, "-shared", "-fPIC", "-o", tmp, src])
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running[lib.source] = (proc, path, tmp, time.perf_counter())
    errors = []
    for source, (proc, path, tmp, t0) in running.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{os.path.basename(proc.args[0])} failed on "
                          f"{source}:\n{err}")
            continue
        os.replace(tmp, path)
        out[source] = (path, time.perf_counter() - t0, err)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(lib: Library) -> ctypes.CDLL:
    """``lib`` opened and bound from its table, built first unless built
    (a CUDA library with every other one of ``csrc/``)."""
    cdll = _loaded.get(lib.source)
    if cdll is None:
        others = cuda_libraries() if lib.source.endswith(".cu") else []
        cdll = ctypes.CDLL(build(others + [lib])[lib.source][0])
        for name, (restype, argtypes) in lib.functions.items():
            fn = getattr(cdll, name)
            fn.restype, fn.argtypes = restype, argtypes
        if lib.check is not None:
            lib.check(cdll)
        _loaded[lib.source] = cdll
    return cdll


def cuda_path(name: str, device: torch.device) -> bool:
    """Whether a tensor on ``device`` takes ``name``'s CUDA launch (True)
    or its plain version (False, the CPU); any other device raises."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} has no path for device {device}")
    return device.type == "cuda"


def stream(device: torch.device) -> int:
    """The handle of torch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, rc: int) -> None:
    """Raise on a launch's non-zero CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
