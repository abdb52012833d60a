"""Camera and geometry helpers of the data pipeline, on the host in numpy
(own copy of gens_tpu/data/cameras.py): MVSNet camera files, PFM depth
maps, pair files, the frustum-union scale matrix, the re-decomposition of
projection matrices and ray generation.

The JAX module decomposes a projection matrix with
``cv2.decomposeProjectionMatrix``; :func:`decompose_projection_matrix`
rebuilds it in numpy (OpenCV's Givens-rotation RQ decomposition with its
sign rules, and the camera centre as the null vector of P), so the port
needs no cv2.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import numpy as np


def rq_decomp3x3(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``M = R @ Q`` with R upper triangular and Q a rotation, computed as
    OpenCV's ``RQDecomp3x3`` computes it: three Givens rotations (x, y, z),
    then R's first two diagonal entries made positive by a rotation of 180
    degrees (its last diagonal entry keeps the sign of det M). Float64."""
    M = np.asarray(M, np.float64)
    eps = np.finfo(np.float64).eps

    def givens(a, b):
        z = 1.0 / np.sqrt(a * a + b * b + eps)
        return a * z, b * z

    c, s = givens(M[2, 2], M[2, 1])
    Qx = np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    R = M @ Qx
    R[2, 1] = 0.0
    c, s = givens(R[2, 2], -R[2, 0])
    Qy = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    M2 = R @ Qy
    M2[2, 0] = 0.0
    c, s = givens(M2[1, 1], M2[1, 0])
    Qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    R = M2 @ Qz
    R[1, 0] = 0.0

    # OpenCV's resolution of the sign ambiguity, transposes included
    if R[0, 0] < 0:
        if R[1, 1] < 0:
            R[0, 0] *= -1
            R[0, 1] *= -1
            R[1, 1] *= -1
            Qz[:2, :2] *= -1
        else:
            R[0, 0] *= -1
            R[0, 2] *= -1
            R[1, 2] *= -1
            R[2, 2] *= -1
            Qz = Qz.T.copy()
            Qy[0, 0] *= -1
            Qy[0, 2] *= -1
            Qy[2, 0] *= -1
            Qy[2, 2] *= -1
    elif R[1, 1] < 0:
        R[0, 1] *= -1
        R[0, 2] *= -1
        R[1, 1] *= -1
        R[1, 2] *= -1
        R[2, 2] *= -1
        Qz = Qz.T.copy()
        Qy = Qy.T.copy()
        Qx[1:, 1:] *= -1
    Q = (Qz.T @ Qy.T) @ Qx.T
    return R, Q


def decompose_projection_matrix(P: np.ndarray
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """The first three outputs of ``cv2.decomposeProjectionMatrix(P)``:
    the camera matrix K (3, 3) and rotation (3, 3) of the RQ decomposition
    of ``P[:, :3]`` (:func:`rq_decomp3x3`), and the camera centre as the
    homogeneous null vector of P (4, 1), unit norm, sign arbitrary.
    Float64."""
    P = np.asarray(P, np.float64)
    square = np.zeros((4, 4))
    square[:3] = P[:3, :4]
    _, _, vt = np.linalg.svd(square)
    K, R = rq_decomp3x3(P[:3, :3])
    return K, R, vt[3][:, None].copy()


def load_K_Rt_from_P(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Decompose a 3x4 projection matrix into intrinsics (3, 3) and c2w
    (4, 4), float32."""
    K, R, t = decompose_projection_matrix(P)
    K = K / K[2, 2]
    intr = K.astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = (t[:3] / t[3])[:, 0]
    return intr, pose


def read_mvsnet_cam(path: str, interval_scale: float = 1.0,
                    num_interval: int = 192):
    """Parse an MVSNet camera txt. Returns (intr (3,3), w2c (4,4),
    (depth_min, depth_max))."""
    with open(path) as f:
        lines = [l.rstrip() for l in f.readlines()]
    # parsed as doubles and rounded to f32, as np.fromstring does
    w2c = np.array(" ".join(lines[1:5]).split(),
                   np.float64).astype(np.float32).reshape(4, 4)
    intr = np.array(" ".join(lines[7:10]).split(),
                    np.float64).astype(np.float32).reshape(3, 3)
    depth_min = float(lines[11].split()[0])
    depth_interval = float(lines[11].split()[1]) * interval_scale
    depth_max = depth_min + depth_interval * num_interval
    return intr, w2c, (depth_min, depth_max)


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM depth map (rows stored bottom-up)."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("not a PFM file")
        dims = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode("utf-8"))
        if not dims:
            raise ValueError("malformed PFM header")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy()


def frustum_union_scale_mat(img_hw, intrs: Sequence[np.ndarray],
                            w2cs: Sequence[np.ndarray],
                            near_fars: Sequence[Tuple[float, float]],
                            factor: float = 1.0):
    """Scale matrix mapping the union of all view frusta into the unit
    sphere. Returns (scale_mat (4,4), scale_factor = 1 / radius)."""
    bnds = np.full((3, 2), np.inf)
    bnds[:, 1] = -np.inf
    im_h, im_w = img_hw
    corner_x = np.array([0, 0, im_w, im_w, 0, 0, im_w, im_w], np.float64)
    corner_y = np.array([0, im_h, 0, im_h, 0, im_h, 0, im_h], np.float64)

    for intr, w2c, (dmin, dmax) in zip(intrs, w2cs, near_fars):
        depth = np.array([dmin] * 4 + [dmax] * 4, np.float64)
        pts = np.stack([
            (corner_x - intr[0, 2]) * depth / intr[0, 0],
            (corner_y - intr[1, 2]) * depth / intr[1, 1],
            depth,
        ]).astype(np.float32)
        homo = np.concatenate([pts, np.ones_like(pts[:1])], axis=0)
        world = (np.linalg.inv(w2c) @ homo)[:3]
        bnds[:, 0] = np.minimum(bnds[:, 0], world.min(axis=1))
        bnds[:, 1] = np.maximum(bnds[:, 1], world.max(axis=1))

    center = ((bnds[:, 1] + bnds[:, 0]) / 2).astype(np.float32)
    radius = float((bnds[:, 1] - bnds[:, 0]).max() / 2) * factor
    scale_mat = np.diag([radius, radius, radius, 1.0]).astype(np.float32)
    scale_mat[:3, 3] = center
    return scale_mat, 1.0 / radius


def normalize_cameras(intrs, w2cs, scale_mat):
    """Re-decompose P = K W2C S per view into normalized (intr, c2w) pairs
    and camera-distance near/far."""
    new_intrs, c2ws, near_fars = [], [], []
    for intr, w2c in zip(intrs, w2cs):
        K4 = np.eye(4, dtype=np.float32)
        K4[:3, :3] = intr
        P = (K4 @ w2c @ scale_mat)[:3, :4]
        new_intr, c2w = load_K_Rt_from_P(P)
        new_intrs.append(new_intr[:3, :3])
        c2ws.append(c2w)
        dist = float(np.linalg.norm(c2w[:3, 3]))
        near_fars.append((0.95 * (dist - 1.0), 1.05 * (dist + 1.0)))
    return (np.stack(new_intrs), np.stack(c2ws),
            np.asarray(near_fars, np.float32))


def pixels_to_rays(pixels_x: np.ndarray, pixels_y: np.ndarray,
                   intr: np.ndarray, c2w: np.ndarray):
    """Unit-norm world rays through the given pixels."""
    p = np.stack([pixels_x, pixels_y, np.ones_like(pixels_x)],
                 axis=-1).astype(np.float32)
    p = p @ np.linalg.inv(intr).T
    d = p / np.linalg.norm(p, axis=-1, keepdims=True)
    rays_d = d @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def pose_distance_pairs(w2cs: np.ndarray, num_select: int = 10) -> np.ndarray:
    """Nearest source views per reference view by camera-centre distance."""
    c2ws = np.linalg.inv(w2cs)
    centers = c2ws[:, :3, 3]
    dists = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    np.fill_diagonal(dists, 1e3)
    return np.argsort(dists, axis=1)[:, :num_select]


def read_pair_file(path: str, num_select: int = 10) -> np.ndarray:
    """MVSNet pair.txt: the source views of each reference view."""
    with open(path) as f:
        n = int(f.readline())
        pairs = [None] * n
        for _ in range(n):
            ref = int(f.readline().rstrip())
            src = [int(x) for x in f.readline().rstrip().split()[1::2]]
            pairs[ref] = np.array(src[:num_select])
    return np.array(pairs)
