"""Mesh cleaning: mask-visibility filtering and frustum ray-cast consensus
(own copy of gens_tpu/mesh/clean.py, the reference's online cleaning at val
time, utils/clean_mesh.py:9-130).

* :func:`clean_mesh_by_mask`: keep faces whose vertices project inside the
  dilated object mask of more than ``min_nb_visible`` views.
* :func:`clean_mesh_outside_frustum`: cast a ray through every (upscaled)
  pixel of every view, keep only first-hit faces, and drop connected
  components smaller than ``min_component`` faces.
* :func:`clean_mesh`: both, as the runner applies them.

Ray casting uses the repository's native BVH (``native/raycast.cpp``),
compiled from source with ``g++ -O3 -fopenmp`` at first use into
``build/gens_torch/``; a failed build raises. The dilation rebuilds
OpenCV's ``MORPH_ELLIPSE`` footprint exactly (it is not a Euclidean disk)
and dilates with ``scipy.ndimage``, so cv2 is not needed.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional

import numpy as np

from gens_torch.mesh.isosurface import build_native

_lib: Optional[ctypes.CDLL] = None


def build_library() -> str:
    """Compile native/raycast.cpp unless built; returns the path."""
    return build_native("native/raycast.cpp", ["-fopenmp"])


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.bvh_build.restype = ctypes.c_void_p
        lib.bvh_build.argtypes = [ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.c_int64]
        lib.bvh_free.restype = None
        lib.bvh_free.argtypes = [ctypes.c_void_p]
        lib.bvh_first_hit.restype = None
        lib.bvh_first_hit.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
        _lib = lib
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class Raycaster:
    """First-hit ray casting against a triangle mesh (native BVH)."""

    def __init__(self, verts: np.ndarray, tris: np.ndarray):
        self.lib = _load()
        verts = np.ascontiguousarray(verts, np.float32)
        tris = np.ascontiguousarray(tris, np.int32)
        # the BVH copies what it needs of the arrays
        self.handle = self.lib.bvh_build(
            _fptr(verts), len(verts),
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(tris))
        weakref.finalize(self, self.lib.bvh_free, self.handle)

    def first_hit(self, origins: np.ndarray, dirs: np.ndarray):
        """(hit triangle (N,) int32, -1 on a miss; hit distance (N,))."""
        origins = np.ascontiguousarray(origins, np.float32)
        dirs = np.ascontiguousarray(dirs, np.float32)
        n = len(origins)
        hit_tri = np.empty(n, np.int32)
        hit_t = np.empty(n, np.float32)
        self.lib.bvh_first_hit(
            self.handle, _fptr(origins), _fptr(dirs), n,
            hit_tri.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _fptr(hit_t))
        return hit_tri, hit_t


def ellipse_footprint(radius: int) -> np.ndarray:
    """OpenCV's ``getStructuringElement(MORPH_ELLIPSE, (2r+1, 2r+1))``:
    row i spans columns c - dx .. c + dx with dy = i - r and
    dx = round(c * sqrt((r² - dy²) / r²)), rounded half to even as
    ``saturate_cast<int>`` does, in OpenCV's float64 order of operations."""
    r = c = int(radius)
    size = 2 * r + 1
    inv_r2 = 1.0 / float(r * r) if r else 0.0
    out = np.zeros((size, size), np.uint8)
    for i in range(size):
        dy = i - r
        dx = int(np.rint(c * np.sqrt(float(r * r - dy * dy) * inv_r2)))
        out[i, max(c - dx, 0):min(c + dx + 1, size)] = 1
    return out


def _dilate_mask(mask: np.ndarray, radius: int = 11) -> np.ndarray:
    """``cv2.dilate(mask as uint8, ellipse footprint)`` as float32: the
    maximum over the footprint, pixels outside the image contributing
    nothing."""
    from scipy import ndimage

    return ndimage.grey_dilation(
        mask.astype(np.uint8), footprint=ellipse_footprint(radius).astype(bool),
        mode="constant", cval=0).astype(np.float32)


def clean_mesh_by_mask(verts: np.ndarray, tris: np.ndarray,
                       masks: np.ndarray, intrs: np.ndarray,
                       c2ws: np.ndarray, min_nb_visible: int = 1,
                       dilate_radius: int = 11):
    """Keep faces whose 3 vertices all project inside the dilated mask of
    more than ``min_nb_visible`` views (reference clean_mesh.py:9-34)."""
    V = masks.shape[0]
    H, W = masks.shape[1], masks.shape[2]
    vis = np.zeros(len(verts), np.int32)
    for v in range(V):
        dm = _dilate_mask(masks[v], dilate_radius)
        w2c = np.linalg.inv(c2ws[v])
        cam = verts @ w2c[:3, :3].T + w2c[:3, 3]
        uvw = cam @ intrs[v][:3, :3].T
        z = uvw[:, 2]
        x = uvw[:, 0] / np.where(np.abs(z) < 1e-8, 1e-8, z)
        y = uvw[:, 1] / np.where(np.abs(z) < 1e-8, 1e-8, z)
        inside = (z > 0) & (x >= 0) & (x < W) & (y >= 0) & (y < H)
        xi = np.clip(x.astype(np.int64), 0, W - 1)
        yi = np.clip(y.astype(np.int64), 0, H - 1)
        vis += (inside & (dm[yi, xi] > 0)).astype(np.int32)
    # strictly more than min_nb_visible views, all 3 vertices (reference
    # clean_mesh.py:29-31)
    face_ok = (vis[tris] > min_nb_visible).all(axis=1)
    return _compact(verts, tris[face_ok])


def face_components(tris: np.ndarray) -> np.ndarray:
    """Connected components over faces sharing an edge: connected
    components of the bipartite face-edge incidence graph (scipy's
    csgraph), restricted to the faces."""
    from scipy import sparse
    from scipy.sparse.csgraph import connected_components

    n = len(tris)
    if n == 0:
        return np.zeros(0, np.int64)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = np.sort(e, axis=1)
    _, edge_id = np.unique(e[:, 0].astype(np.int64) * (tris.max() + 1)
                           + e[:, 1], return_inverse=True)
    face_id = np.tile(np.arange(n, dtype=np.int64), 3)
    n_edges = int(edge_id.max()) + 1
    data = np.ones(len(face_id), np.int8)
    adj = sparse.coo_matrix(
        (data, (face_id, edge_id + n)), shape=(n + n_edges, n + n_edges))
    _, labels = connected_components(adj, directed=False)
    return labels[:n]


def clean_mesh_outside_frustum(verts: np.ndarray, tris: np.ndarray,
                               intrs: np.ndarray, c2ws: np.ndarray,
                               img_hw, upscale: Optional[int] = None,
                               min_component: int = 500):
    """Keep faces visible as first hits from the cameras, then drop small
    components (reference clean_mesh.py:37-106).

    ``upscale=None`` scales the ray grid to out-resolve the faces (1.5 rays
    per median face edge at the median depth, clamped to 2..8): where pixel
    footprints are larger than faces, the kept set fragments into speckles
    that ``min_component`` then removes."""
    if len(tris) == 0:
        return verts, tris
    caster = Raycaster(verts, tris)
    H, W = img_hw
    if upscale is None:
        med_edge = float(np.median(np.linalg.norm(
            verts[tris[:, 0]] - verts[tris[:, 1]], axis=-1)))
        cam = c2ws[0][:3, 3]
        depth = float(np.median(np.linalg.norm(
            verts[tris[:, 0]] - cam[None], axis=-1)))
        focal = float(intrs[0][0, 0])
        pix_world = depth / max(focal, 1e-6)
        upscale = int(np.clip(np.ceil(1.5 * pix_world / max(med_edge, 1e-9)),
                              2, 8))
    keep = np.zeros(len(tris), bool)
    for v in range(len(c2ws)):
        hh, ww = H * upscale, W * upscale
        ys, xs = np.meshgrid(
            np.linspace(0, H - 1, hh, dtype=np.float32),
            np.linspace(0, W - 1, ww, dtype=np.float32), indexing="ij")
        pix = np.stack([xs.ravel(), ys.ravel(),
                        np.ones(hh * ww, np.float32)], axis=-1)
        d = pix @ np.linalg.inv(intrs[v][:3, :3]).T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = d @ c2ws[v][:3, :3].T
        o = np.broadcast_to(c2ws[v][:3, 3], d.shape)
        hit, _ = caster.first_hit(o, d)
        keep[hit[hit >= 0]] = True

    tris_kept = tris[keep]
    if len(tris_kept) == 0:
        return _compact(verts, tris_kept)
    comp = face_components(tris_kept)
    _, inverse, counts = np.unique(comp, return_inverse=True,
                                   return_counts=True)
    tris_kept = tris_kept[counts[inverse] >= min_component]
    return _compact(verts, tris_kept)


def _compact(verts: np.ndarray, tris: np.ndarray):
    """Drop unreferenced vertices and reindex faces."""
    if len(tris) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    used = np.unique(tris)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[tris].astype(np.int32)


def clean_mesh(verts: np.ndarray, tris: np.ndarray, masks: np.ndarray,
               intrs: np.ndarray, c2ws: np.ndarray,
               min_nb_visible: int = 1):
    """The runner's cleaning (reference clean_mesh.py:109-130): dilated-mask
    visibility, then frustum first-hit consensus."""
    verts, tris = clean_mesh_by_mask(verts, tris, masks, intrs, c2ws,
                                     min_nb_visible)
    if len(tris):
        verts, tris = clean_mesh_outside_frustum(
            verts, tris, intrs, c2ws, (masks.shape[1], masks.shape[2]))
    return verts, tris
