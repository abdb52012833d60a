"""The traffic's scenes: analytic unions of spheres seen from a camera ring,
ray traced in numpy, with ray batches drawn per step. One general
generator; a mix's data file (``traffic/<mix>.json``) gives its
parameters and a configuration's dataset section the view count, the
image size and the rays.

Every draw comes from a numpy ``Generator`` keyed by (seed, stream,
index), so a seed gives the same scenes and batches in every run, any
seed up to 2**63 works, and every seed gets the same sizes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

SCENE, BATCH, GRID, PICK = 1, 2, 3, 4


def rng_for(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream, index])))


def look_at(eye: np.ndarray) -> np.ndarray:
    """c2w (OpenCV axes: x right, y down, z forward) looking at 0, z up."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def trace(origins, dirs, centers, radii) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """Nearest positive hit on a union of spheres: (t, hit, normal)."""
    t_best = np.full(dirs.shape[:-1], np.inf, np.float32)
    k_best = np.full(dirs.shape[:-1], -1, np.int32)
    for k, (c, r) in enumerate(zip(centers, radii)):
        oc = origins - c
        b = np.sum(dirs * oc, axis=-1)
        disc = b ** 2 - (np.sum(oc ** 2, axis=-1) - r ** 2)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        better = (disc > 0) & (t > 0) & (t < t_best)
        t_best = np.where(better, t, t_best)
        k_best = np.where(better, k, k_best)
    hit = k_best >= 0
    t = np.where(hit, t_best, 0.0).astype(np.float32)
    pts = origins + dirs * t[..., None]
    normal = np.zeros(dirs.shape, np.float32)
    for k, (c, r) in enumerate(zip(centers, radii)):
        normal = np.where((k_best == k)[..., None], (pts - c) / r, normal)
    return t, hit, normal


def make_scene(p: Dict, n_views: int, hw, seed: int, index: int) -> Dict:
    """One scene: a union of spheres from the mix's fixed list
    ``p["shapes"]`` (scene ``index`` takes the list's entry ``index`` plus
    an offset drawn from the seed, so every seed renders the same set of
    shapes, in another order), a textured Lambertian albedo and a light
    drawn from the seed, and ``n_views`` cameras on a ring at
    ``p["cam_dist"]`` over ``p["spread"]`` of the circle from an angle
    drawn from the seed, the first the reference view. Returns float32
    arrays: imgs (V, H, W, 3), intrs, c2ws, near, far, and the shape
    (centers, radii)."""
    shapes = p["shapes"]
    offset = int(rng_for(seed, SCENE, 2 ** 32).integers(len(shapes)))
    shape = shapes[(index + offset) % len(shapes)]
    centers = np.asarray(shape["centers"], np.float32).reshape(-1, 3)
    radii = np.asarray(shape["radii"], np.float32).reshape(-1)
    g = rng_for(seed, SCENE, index)
    H, W = hw
    light = g.normal(size=3)
    light[2] = -abs(light[2]) - 0.5
    light /= np.linalg.norm(light)
    freq = g.uniform(*p["albedo_freq"])
    phase = g.uniform(0, 2 * np.pi, size=2)
    tint = g.uniform(0.5, 1.0, size=3)
    ang0 = g.uniform(0, 2 * np.pi)
    focal = p["focal_scale"] * max(H, W)
    intr = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                    np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float32)
    d_cam = pix @ np.linalg.inv(intr).T
    d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
    imgs, c2ws = [], []
    for v in range(n_views):
        ang = ang0 + 2 * np.pi * v / n_views * p["spread"]
        eye = p["cam_dist"] * np.array([np.cos(ang), np.sin(ang),
                                        p["elevation"]], np.float32)
        c2w = look_at(eye)
        dirs = (d_cam @ c2w[:3, :3].T).astype(np.float32)
        t, hit, normal = trace(c2w[:3, 3], dirs, centers, radii)
        pts = c2w[:3, 3] + dirs * t[..., None]
        shade = np.clip(-(normal @ light), 0.1, 1.0)
        albedo = 0.5 + 0.25 * (np.sin(freq * pts[..., 0] + phase[0])
                               * np.cos(freq * pts[..., 1] + phase[1]))
        img = np.where(hit[..., None], (shade * albedo)[..., None] * tint,
                       0.05)
        imgs.append(img.astype(np.float32))
        c2ws.append(c2w)
    c2ws = np.stack(c2ws)
    dist = float(np.linalg.norm(c2ws[0, :3, 3]))
    return {"imgs": np.stack(imgs),
            "intrs": np.repeat(intr[None], n_views, 0),
            "c2ws": c2ws,
            "near": np.full((1, 1), 0.95 * (dist - 1.0), np.float32),
            "far": np.full((1, 1), 1.05 * (dist + 1.0), np.float32),
            "centers": centers, "radii": radii}


def train_batch(scene: Dict, n_rays: int, n_pseudo: int, n_sparse: int,
                seed: int, step: int) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch on ``scene``: ``n_rays`` reference-view rays
    with their colours and analytic pseudo depths, ``n_pseudo`` surface
    points, the per-ray perturbation in [-0.5, 0.5) and ``n_sparse``
    random points in [-1, 1)³."""
    g = rng_for(seed, BATCH, step)
    imgs, intr, c2w = scene["imgs"], scene["intrs"][0], scene["c2ws"][0]
    H, W = imgs.shape[1:3]
    px = g.integers(0, W, size=n_rays)
    py = g.integers(0, H, size=n_rays)
    pix = np.stack([px, py, np.ones_like(px)], -1).astype(np.float32)
    d = pix @ np.linalg.inv(intr).T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_d = (d @ c2w[:3, :3].T).astype(np.float32)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).astype(np.float32)
    t, hit, _ = trace(rays_o, rays_d, scene["centers"], scene["radii"])
    cam_z = (rays_d @ np.linalg.inv(c2w[:3, :3]).T)[:, 2]
    centers, radii = scene["centers"], scene["radii"]
    k = g.integers(0, len(radii), size=n_pseudo)
    dirs = g.normal(size=(n_pseudo, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {
        "rays_o": rays_o.copy(), "rays_d": rays_d,
        "color": imgs[0][py, px].astype(np.float32),
        "pseudo_depth": np.where(hit, t * cam_z, 0.0).astype(np.float32),
        "pseudo_pts": (centers[k] + dirs * radii[k, None]).astype(np.float32),
        "perturb_noise": (g.random((n_rays, 1)) - 0.5).astype(np.float32),
        "sparse_pts": (g.random((n_sparse, 3)) * 2 - 1).astype(np.float32),
    }
