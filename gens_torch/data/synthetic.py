"""Synthetic analytic-SDF scene: Lambertian unit-ish sphere rendered from a
camera ring (own copy of gens_tpu/data/synthetic.py, with its train, val
and finetune protocols and the quality metrics' exact shape distances and
surface samples).

The reference has no test suite; SURVEY.md §4 recommends a tiny synthetic
scene (analytic SDF + ray-traced views) as the end-to-end fixture. This
module produces inputs in exactly the shapes the data pipeline emits
(imgs (V,H,W,3), intrs (V,3,3), c2ws (V,4,4), rays, near/far), entirely in
numpy, so tests and the overfit smoke benchmark need no dataset on disk.
"""

from __future__ import annotations

import numpy as np


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """c2w matrix with camera +z looking at ``target`` (OpenCV convention:
    x right, y down, z forward)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


def sphere_sdf(pts: np.ndarray, radius: float = 0.5) -> np.ndarray:
    return np.linalg.norm(pts, axis=-1) - radius


def shape_spheres(shape=None, radius: float = 0.5):
    """Normalize a shape spec to ``(centers (K, 3), radii (K,))``.

    ``shape=None`` is the original single origin-centered sphere; a dict
    ``{"centers": [...], "radii": [...]}`` describes a UNION of spheres —
    a non-convex analytic fixture (two lobes + seam) with closed-form ray
    tracing and exact surface-distance metrics, the "harder geometry" the
    quality protocol scores in addition to the sphere."""
    if shape is None:
        return (np.zeros((1, 3), np.float32),
                np.asarray([radius], np.float32))
    return (np.asarray(shape["centers"], np.float32).reshape(-1, 3),
            np.asarray(shape["radii"], np.float32).reshape(-1))


def trace_spheres(origins: np.ndarray, dirs: np.ndarray, centers: np.ndarray,
                  radii: np.ndarray):
    """Nearest positive ray/union-of-spheres hit.

    origins (..., 3) (broadcastable), dirs (..., 3) unit. Returns
    ``(t (...), hit (...) bool, normals (..., 3))`` — normal of the hit
    sphere (zero where missed)."""
    t_best = np.full(dirs.shape[:-1], np.inf, np.float32)
    idx_best = np.full(dirs.shape[:-1], -1, np.int32)
    for k, (c, r) in enumerate(zip(centers, radii)):
        oc = origins - c
        b = np.sum(dirs * oc, axis=-1)
        cq = np.sum(oc ** 2, axis=-1) - r ** 2
        disc = b ** 2 - cq
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        h = (disc > 0) & (t > 0)
        better = h & (t < t_best)
        t_best = np.where(better, t, t_best)
        idx_best = np.where(better, k, idx_best)
    hit = idx_best >= 0
    t = np.where(hit, t_best, 0.0).astype(np.float32)
    pts = origins + dirs * t[..., None]
    normals = np.zeros_like(dirs)
    for k, (c, r) in enumerate(zip(centers, radii)):
        normals = np.where((idx_best == k)[..., None], (pts - c) / r, normals)
    return t, hit, normals.astype(np.float32)


def shape_distance(pts: np.ndarray, centers: np.ndarray,
                   radii: np.ndarray) -> np.ndarray:
    """|signed distance to the union surface| at ``pts`` (exact outside the
    union and inside a single lobe; the seam interior is never scored — mesh
    vertices live on the surface)."""
    d = np.min(np.stack([
        np.linalg.norm(pts - c, axis=-1) - r
        for c, r in zip(centers, radii)], axis=-1), axis=-1)
    return np.abs(d)


def shape_surface_samples(centers: np.ndarray, radii: np.ndarray, n: int,
                          rng=None) -> np.ndarray:
    """~n uniform samples on the union's surface: per-sphere uniform points,
    rejecting those strictly inside another sphere."""
    rng = rng or np.random.RandomState(0)
    per = max(n // len(radii), 1)
    out = []
    for k, (c, r) in enumerate(zip(centers, radii)):
        dirs = rng.randn(per, 3)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        pts = c + dirs * r
        keep = np.ones(per, bool)
        for j, (c2, r2) in enumerate(zip(centers, radii)):
            if j != k:
                keep &= np.linalg.norm(pts - c2, axis=-1) >= r2 - 1e-6
        out.append(pts[keep])
    return np.concatenate(out, axis=0).astype(np.float32)


def render_sphere_view(c2w: np.ndarray, intr: np.ndarray, hw, radius=0.5,
                       light_dir=(0.4, 0.3, -0.85), albedo_freq=6.0,
                       albedo_phase=(0.0, 0.0), tints=(1.0, 0.8, 0.6),
                       return_mask: bool = False, shape=None):
    """Analytic ray-traced shaded image (H, W, 3) in [0, 1] of a sphere or
    a union of spheres (``shape``, see :func:`shape_spheres`).

    ``albedo_freq/phase`` and ``tints`` parameterize the surface texture so
    multi-scene training sees varied appearance (the generalization fixture);
    defaults reproduce the original single look."""
    H, W = hw
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float32)
    dirs = pix @ np.linalg.inv(intr).T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs @ c2w[:3, :3].T
    origin = c2w[:3, 3]

    centers, radii = shape_spheres(shape, radius)
    t, hit, normals = trace_spheres(origin, dirs, centers, radii)
    pts = origin + dirs * t[..., None]

    light = np.asarray(light_dir, np.float32)
    light = light / np.linalg.norm(light)
    shade = np.clip(-np.sum(normals * light, axis=-1), 0.1, 1.0)

    # mildly textured albedo so NCC/blending have signal
    albedo = 0.5 + 0.25 * (np.sin(albedo_freq * pts[..., 0] + albedo_phase[0])
                           * np.cos(albedo_freq * pts[..., 1]
                                    + albedo_phase[1]))
    img = np.zeros((H, W, 3), np.float32)
    for ch, tint in enumerate(tints):
        img[..., ch] = np.where(hit, shade * albedo * tint, 0.05)
    if return_mask:
        return img, hit.astype(np.float32)
    return img


def make_scene(n_views: int = 3, hw=(64, 64), radius: float = 0.5,
               cam_dist: float = 2.0, n_rays: int = 64, seed: int = 0,
               ang0: float = 0.0, light_dir=(0.4, 0.3, -0.85),
               albedo_freq: float = 6.0, albedo_phase=(0.0, 0.0),
               tints=(1.0, 0.8, 0.6), spread: float = 0.25, shape=None):
    """Build a full training-style input dict for a synthetic scene (sphere
    by default; ``shape`` selects a union-of-spheres, see shape_spheres).

    The optional appearance/geometry knobs (radius, camera ring offset
    ``ang0``, light direction, albedo texture, tints) let a multi-scene
    generalization fixture draw varied scenes; defaults reproduce the
    original fixture exactly."""
    H, W = hw
    rng = np.random.RandomState(seed)

    focal = 1.2 * max(H, W)
    intr = np.array([[focal, 0, W / 2.0],
                     [0, focal, H / 2.0],
                     [0, 0, 1]], np.float32)

    c2ws, imgs, masks = [], [], []
    for i in range(n_views):
        # camera ring: ``spread`` fraction of the full circle across views
        # (0.25 clusters them like the original fixture)
        ang = ang0 + 2 * np.pi * i / max(n_views, 1) * spread
        eye = cam_dist * np.array(
            [np.cos(ang), np.sin(ang), 0.35], np.float32)
        c2w = look_at(eye, np.zeros(3, np.float32))
        c2ws.append(c2w)
        img, mask = render_sphere_view(
            c2w, intr, hw, radius, light_dir=light_dir,
            albedo_freq=albedo_freq, albedo_phase=albedo_phase, tints=tints,
            return_mask=True, shape=shape)
        imgs.append(img)
        masks.append(mask)
    c2ws = np.stack(c2ws)
    imgs = np.stack(imgs)
    masks = np.stack(masks)
    intrs = np.repeat(intr[None], n_views, axis=0)

    # ray batch from the reference view
    px = rng.randint(0, W, size=n_rays).astype(np.float32)
    py = rng.randint(0, H, size=n_rays).astype(np.float32)
    pix = np.stack([px, py, np.ones_like(px)], axis=-1)
    d = pix @ np.linalg.inv(intr).T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays_d = d @ c2ws[0, :3, :3].T
    rays_o = np.broadcast_to(c2ws[0, :3, 3], rays_d.shape).copy()

    color = imgs[0][py.astype(int), px.astype(int)]

    dist = np.linalg.norm(c2ws[0, :3, 3])
    near = np.full((1, 1), 0.95 * (dist - 1.0), np.float32)
    far = np.full((1, 1), 1.05 * (dist + 1.0), np.float32)

    # NB: the shape spec is deliberately NOT in the dict — consumers filter
    # keys into jitted input trees; callers that need the analytic geometry
    # re-derive it via shape_spheres(shape, radius)
    return {
        "imgs": imgs.astype(np.float32),
        "intrs": intrs.astype(np.float32),
        "c2ws": c2ws.astype(np.float32),
        "rays_o": rays_o.astype(np.float32),
        "rays_d": rays_d.astype(np.float32),
        "near": near,
        "far": far,
        "color": color.astype(np.float32),
        "radius": radius,
        "view_masks": masks,
    }


class SyntheticDataset:
    """Dataset over the analytic sphere scene for the train and val item
    protocols and the finetune protocol (``get_all_images``,
    ``get_random_rays``, ``get_rays_at``), so the Runner runs with no data
    on disk.

    Items draw ``n_rays`` pixels and ``n_pseudo_pts`` surface points from
    one ``numpy.random.RandomState(seed)``, in the JAX dataset's order, so
    both packages give the same batches for a seed.

    The finetune protocol follows the DTU one (``data/dtu_finetune.py`` of
    the JAX package): a batch on view ``vid`` holds the images and cameras
    in the order [vid, the others], and its rays and colours come from view
    ``vid``. The JAX fixture rotates only ``view_ids`` and keeps images,
    cameras and rays on view 0, so the two agree at ``vid = 0`` and the
    port's batch at ``vid != 0`` is the JAX one reordered."""

    def __init__(self, n_scenes: int = 1, n_views: int = 3, hw=(64, 64),
                 n_rays: int = 64, val_res_level: int = 4,
                 n_pseudo_pts: int = 64, mode: str = "val", seed: int = 0):
        self.n_scenes = n_scenes
        self.n_views = n_views
        self.num_views = n_views
        self.hw = hw
        self.n_rays = n_rays
        self.val_res_level = val_res_level
        self.n_pseudo_pts = n_pseudo_pts
        self.mode = mode
        self.rng = np.random.RandomState(seed)
        self._seed = seed
        self._cache = {}

    def __len__(self):
        return self.n_scenes

    def view_order(self, vid: int):
        return [vid] + [i for i in range(self.n_views) if i != vid]

    def _scene(self, idx, n_rays, vid: int = 0):
        """Per-index scene with the images and cameras raytraced once and
        cached, as a dataset on disk would hold them, in the view order of
        ``vid``; only the ray batch, on view ``vid``, is drawn anew per
        call."""
        if idx not in self._cache:
            self._cache[idx] = make_scene(n_views=self.n_views, hw=self.hw,
                                          n_rays=1,
                                          seed=self._seed + 7919 * idx)
        base = self._cache[idx]
        out = dict(base)
        order = self.view_order(vid)
        for k in ("imgs", "intrs", "c2ws", "view_masks"):
            out[k] = base[k][order]
        # make_scene's near/far, from the distance of view vid's camera
        dist = np.linalg.norm(out["c2ws"][0, :3, 3])
        out["near"] = np.full((1, 1), 0.95 * (dist - 1.0), np.float32)
        out["far"] = np.full((1, 1), 1.05 * (dist + 1.0), np.float32)
        H, W = self.hw
        intr, c2w = out["intrs"][0], out["c2ws"][0]
        px = self.rng.randint(0, W, size=n_rays).astype(np.float32)
        py = self.rng.randint(0, H, size=n_rays).astype(np.float32)
        pix = np.stack([px, py, np.ones_like(px)], axis=-1)
        d = pix @ np.linalg.inv(intr).T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        out["rays_d"] = (d @ c2w[:3, :3].T).astype(np.float32)
        out["rays_o"] = np.broadcast_to(
            c2w[:3, 3], out["rays_d"].shape).astype(np.float32).copy()
        out["color"] = out["imgs"][0][py.astype(int), px.astype(int)]
        return out

    def __getitem__(self, idx):
        if self.mode == "train":
            out = self._scene(idx, self.n_rays)
            radius = out.pop("radius")
            # pseudo supervision from the analytic sphere: exact depth along
            # the sampled rays and exact surface points
            b = np.sum(out["rays_d"] * out["rays_o"], axis=-1)
            c = np.sum(out["rays_o"] ** 2, axis=-1) - radius ** 2
            disc = b ** 2 - c
            t = -b - np.sqrt(np.maximum(disc, 0.0))
            hit = (disc > 0) & (t > 0)
            cam_z = (out["rays_d"] @ np.linalg.inv(
                out["c2ws"][0][:3, :3]).T)[:, 2]
            out["pseudo_depth"] = np.where(hit, t * cam_z, 0.0).astype(
                np.float32)
            dirs = self.rng.randn(self.n_pseudo_pts, 3).astype(np.float32)
            dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
            out["pseudo_pts"] = (dirs * radius).astype(np.float32)
            return out
        return self._val_item(idx, 0)

    def _val_item(self, idx, vid: int):
        """The full val ray grid on view ``vid`` with its analytic depth."""
        H, W = self.hw
        stride = self.val_res_level
        out = self._scene(idx, 1, vid)
        radius = out.pop("radius")
        tx = np.linspace(0, W - 1, W // stride, dtype=np.float32)
        ty = np.linspace(0, H - 1, H // stride, dtype=np.float32)
        py, px = np.meshgrid(ty, tx, indexing="ij")
        px, py = px.ravel(), py.ravel()
        ix, iy = px.astype(np.int64), py.astype(np.int64)
        intr, c2w = out["intrs"][0], out["c2ws"][0]
        p = np.stack([px, py, np.ones_like(px)], -1) @ np.linalg.inv(intr).T
        d = p / np.linalg.norm(p, axis=-1, keepdims=True)
        rays_d = (d @ c2w[:3, :3].T).astype(np.float32)
        rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).astype(np.float32)
        color = out["imgs"][0][iy, ix]

        # analytic GT depth: full reference-view map + per-ray values
        fy, fx = np.meshgrid(np.arange(H, dtype=np.float32),
                             np.arange(W, dtype=np.float32), indexing="ij")
        fp = np.stack([fx.ravel(), fy.ravel(), np.ones(H * W, np.float32)],
                      -1) @ np.linalg.inv(intr).T
        fd = fp / np.linalg.norm(fp, axis=-1, keepdims=True)
        fd = fd @ c2w[:3, :3].T
        fo = np.broadcast_to(c2w[:3, 3], fd.shape)
        b = np.sum(fd * fo, axis=-1)
        c = np.sum(fo ** 2, axis=-1) - radius ** 2
        disc = b ** 2 - c
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit = (disc > 0) & (t > 0)
        cam_z = (fd @ np.linalg.inv(c2w[:3, :3]).T)[:, 2]
        depth_ref = np.where(hit, t * cam_z, 0.0).astype(
            np.float32).reshape(H, W)
        depth = depth_ref[iy, ix]

        out.update({
            "rays_o": rays_o, "rays_d": rays_d, "color": color,
            "depth": depth,
            "depth_ref": depth_ref,
            "masks": out["view_masks"],
            "mask_ref": out["view_masks"][0],
            "bound_min": np.array([-1, -1, -1], np.float32),
            "bound_max": np.array([1, 1, 1], np.float32),
            "hw": np.array([H // stride, W // stride], np.int64),
            "scale_mat": np.eye(4, dtype=np.float32),
            "scene": f"sphere{idx}",
            "file_name": f"sphere{idx}",
            "view_ids": np.asarray(self.view_order(vid), np.int64),
        })
        return out

    # -- finetune protocol ------------------------------------------------

    def get_all_images(self):
        """Every view of scene 0, for the one-shot volume build."""
        out = self._scene(0, 1)
        return {"imgs": out["imgs"], "intrs": out["intrs"],
                "c2ws": out["c2ws"]}

    def get_random_rays(self, vid: int):
        """A random ray batch on view ``vid``."""
        out = self._scene(0, self.n_rays, vid)
        out.pop("radius")
        out["view_ids"] = np.asarray(self.view_order(vid), np.int64)
        return out

    def get_rays_at(self, vid: int):
        """The full val ray grid on view ``vid``."""
        return self._val_item(0, vid)
