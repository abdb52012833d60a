"""Isosurface extraction through the repository's native C++ marching
tetrahedra (``native/isosurface.cpp``), bound with ctypes as
gens_tpu/mesh/isosurface.py binds it. The library builds from source with
``g++`` at first use (``utils/libraries.py``; the prebuilt
``native/libisosurface.so`` was built for another host's CPU).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from gens_torch.utils import libraries

LIBRARY = libraries.Library("native/isosurface.cpp", {
    "extract_isosurface": (ctypes.c_int, [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64)]),
    "iso_free": (None, [ctypes.c_void_p])})


def marching_tetrahedra(grid: np.ndarray, iso: float = 0.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``grid == iso`` surface of an (nx, ny, nz) grid.

    Returns (vertices (V, 3) float32 in grid-index space, triangles (T, 3)
    int32), wound with normals toward the below-iso region."""
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    lib = libraries.load(LIBRARY)
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
