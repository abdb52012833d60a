"""Isosurface extraction through the repository's native C++ marching
tetrahedra (``native/isosurface.cpp``), bound with ctypes as
gens_tpu/mesh/isosurface.py binds it.

The library is compiled from source with ``g++`` at first use into
``build/gens_torch/`` (the prebuilt ``native/libisosurface.so`` was built for
another host's CPU); a failed build raises. :func:`build_native` builds the
repository's other native sources the same way: ``native/raycast.cpp`` and
the port's own ``gens_torch/native/zstd_decode.cpp``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "gens_torch")

_lib: Optional[ctypes.CDLL] = None


def build_native(source: str, flags: Sequence[str] = ()) -> str:
    """Compile ``source`` (a path from the repository's root, such as
    ``native/raycast.cpp``) with ``g++ -O3 <flags> -shared -fPIC`` into
    ``build/gens_torch/`` (named by the source's hash) unless built;
    returns the library's path. A failed build raises."""
    src = os.path.join(_REPO_ROOT, source)
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(_BUILD_DIR, f"lib{stem}_{digest}.so")
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        res = subprocess.run(["g++", "-O3", *flags, "-shared", "-fPIC", "-o",
                              tmp, src], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {src}:\n{res.stderr}")
        os.replace(tmp, path)
    return path


def build_library() -> str:
    """Compile native/isosurface.cpp unless built; returns the path."""
    return build_native("native/isosurface.cpp")


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.extract_isosurface.restype = ctypes.c_int
        lib.extract_isosurface.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.iso_free.restype = None
        lib.iso_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def marching_tetrahedra(grid: np.ndarray, iso: float = 0.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``grid == iso`` surface of an (nx, ny, nz) grid.

    Returns (vertices (V, 3) float32 in grid-index space, triangles (T, 3)
    int32), wound with normals toward the below-iso region."""
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    lib = _load()
    vp = ctypes.POINTER(ctypes.c_float)()
    tp = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    rc = lib.extract_isosurface(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        grid.shape[0], grid.shape[1], grid.shape[2], iso,
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(tp), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError(f"extract_isosurface failed with code {rc}")
    verts = (np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
             if nv.value else np.zeros((0, 3), np.float32))
    tris = (np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy()
            if nt.value else np.zeros((0, 3), np.int32))
    lib.iso_free(vp)
    lib.iso_free(tp)
    return verts, tris
