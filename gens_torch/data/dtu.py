"""DTU dataset (own copy of gens_tpu/data/dtu.py), host-side numpy.

* metas = scan x ref view x light; training picks ``num_src_view`` random
  sources out of the 6 nearest pair entries, validation the top ones.
* the world frame re-centred at the reference camera (``w2c @
  w2c_ref_inv``), a frustum-union scale matrix into the unit sphere, and
  each P re-decomposed into normalised cameras.
* training rays: 3/4 from mask-valid pixels and 1/4 uniform; validation:
  the full stride-``val_res_level`` grid.
* pseudo-depth supervision and ``n_pseudo_pts`` back-projected pseudo
  points (fixed pseudo scale of the released labels).

Every random draw comes from the ``RandomState`` passed in. Outputs are
channels-last numpy arrays: imgs (V, H, W, 3), intrs (V, 3, 3), c2ws
(V, 4, 4).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from gens_torch.config import DatasetConfig
from gens_torch.data.cameras import (frustum_union_scale_mat,
                                     normalize_cameras, pixels_to_rays,
                                     pose_distance_pairs, read_mvsnet_cam,
                                     read_pair_file, read_pfm)
from gens_torch.data.image_io import read_image, resize_nearest

# fixed pseudo-depth scale of the released pseudo labels
PSEUDO_SCALE = 0.0037506045743823813

SPLIT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "dtu_split")


def load_split(name: str) -> List[str]:
    with open(os.path.join(SPLIT_DIR, name + ".txt")) as f:
        return [l.strip() for l in f if l.strip()]


def val_grid(hw, stride: int):
    """Pixel coordinates (px, py) of the stride-``stride`` val ray grid,
    floor(linspace(0, dim - 1, dim // stride)) on each axis, row-major."""
    H, W = hw
    tx = np.linspace(0, W - 1, W // stride, dtype=np.float32)
    ty = np.linspace(0, H - 1, H // stride, dtype=np.float32)
    py, px = np.meshgrid(ty, tx, indexing="ij")
    return px.ravel(), py.ravel()


def sample_train_pixels(rng: np.random.RandomState, mask: np.ndarray,
                        n: int):
    """``n`` ray pixels: 3/4 drawn from the mask-valid pixels (all pixels
    when none is valid), 1/4 uniform over the image."""
    H, W = mask.shape
    n_uniform = n // 4
    ys, xs = np.nonzero(mask > 0.5)
    if len(xs) == 0:
        xs = np.arange(W).repeat(H)
        ys = np.tile(np.arange(H), W)
    sel = rng.randint(0, len(xs), size=n - n_uniform)
    px = np.concatenate([
        xs[sel].astype(np.float32),
        rng.randint(0, W, size=n_uniform).astype(np.float32)])
    py = np.concatenate([
        ys[sel].astype(np.float32),
        rng.randint(0, H, size=n_uniform).astype(np.float32)])
    return px, py


class DTUDataset:
    """Map-style dataset; ``__getitem__`` returns a numpy input dict."""

    total_views = 49

    def __init__(self, cfg: DatasetConfig, mode: str,
                 rng: Optional[np.random.RandomState] = None):
        self.cfg = cfg
        self.mode = mode
        self.rng = rng or np.random.RandomState(0)
        self.data_dir = cfg.data_dir
        self.img_hw = tuple(cfg.img_hw)

        self.intrs, self.w2cs, self.near_fars = self._read_cams()
        self.pairs = self._get_pairs()
        self.metas = self._build_list()

    def _read_cams(self):
        intrs, w2cs, near_fars = [], [], []
        for vid in range(self.total_views):
            path = os.path.join(self.data_dir,
                                "Cameras/{:0>8}_cam.txt".format(vid))
            intr, w2c, nf = read_mvsnet_cam(
                path, self.cfg.interval_scale, self.cfg.num_interval)
            # DTU cameras are calibrated at 1600x1200
            intr = intr.copy()
            intr[0] *= self.img_hw[1] / 1600.0
            intr[1] *= self.img_hw[0] / 1200.0
            intrs.append(intr)
            w2cs.append(w2c)
            near_fars.append(nf)
        return intrs, w2cs, near_fars

    def _get_pairs(self):
        pair_file = os.path.join(self.data_dir, "Cameras/pair.txt")
        if os.path.exists(pair_file):
            return read_pair_file(pair_file)
        return pose_distance_pairs(np.stack(self.w2cs))

    def _build_list(self):
        if self.cfg.scene is not None:
            scans = list(self.cfg.scene)
        elif self.cfg.split is not None:
            scans = load_split(self.cfg.split)
        else:
            raise ValueError("no scenes configured")
        light_idxs = (list(self.cfg.light_idx) if self.cfg.light_idx
                      else list(range(7)))
        ref_views = (list(self.cfg.ref_view) if self.cfg.ref_view
                     else list(range(self.total_views)))
        return [(scan, light, ref_view) for scan in scans
                for ref_view in ref_views for light in light_idxs]

    def __len__(self):
        return len(self.metas)

    # -- file readers ------------------------------------------------------

    def _img_path(self, scan, vid, light):
        suffix = "r7000" if vid > 48 else "r5000"
        return os.path.join(
            self.data_dir,
            f"Rectified_raw/{scan}/rect_{vid + 1:0>3}_{light}_{suffix}.png")

    def _read_img(self, path):
        return resize_nearest(read_image(path), self.img_hw) / 256.0

    def _read_mask(self, scan, vid):
        path = os.path.join(
            self.data_dir, f"Depths_raw/{scan}/depth_visual_{vid:0>4}.png")
        m = (resize_nearest(read_image(path), self.img_hw) > 10).astype(
            np.float32)
        if m.ndim > 2:
            m = (m.mean(axis=-1) > 0).astype(np.float32)
        return m

    def _read_depth(self, scan, vid):
        path = os.path.join(
            self.data_dir, f"Depths_raw/{scan}/depth_map_{vid:0>4}.pfm")
        return resize_nearest(read_pfm(path).astype(np.float32), self.img_hw)

    def _read_pseudo_depth(self, scan, vid):
        path = os.path.join(
            self.data_dir, f"pseudo_depths/{scan}/{vid}_epoch0.npy")
        if not os.path.exists(path):
            return None
        d = np.load(path).astype(np.float32) / PSEUDO_SCALE
        return resize_nearest(d, self.img_hw)

    # -- item --------------------------------------------------------------

    def select_views(self, ref_view: int) -> List[int]:
        pairs = list(self.pairs[ref_view])
        n = min(self.cfg.num_src_view, len(pairs))
        if self.mode == "train":
            src = list(self.rng.choice(pairs[:6], size=n, replace=False))
        else:
            src = pairs[:n]
        return [ref_view] + [int(v) for v in src]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        scan, light, ref_view = self.metas[idx]
        view_ids = self.select_views(ref_view)
        H, W = self.img_hw

        w2c_ref_inv = np.linalg.inv(self.w2cs[ref_view])

        imgs, intrs, w2cs, near_fars, masks, depths = [], [], [], [], [], []
        pseudo_depth_ref = None
        for i, vid in enumerate(view_ids):
            imgs.append(self._read_img(self._img_path(scan, vid, light)))
            intrs.append(self.intrs[vid])
            w2cs.append(self.w2cs[vid] @ w2c_ref_inv)  # ref-centred world
            near_fars.append(self.near_fars[vid])
            masks.append(self._read_mask(scan, vid))
            depths.append(self._read_depth(scan, vid))
            if i == 0 and self.mode == "train":
                pseudo_depth_ref = self._read_pseudo_depth(scan, vid)

        scale_mat, scale_factor = frustum_union_scale_mat(
            self.img_hw, intrs, w2cs, near_fars, factor=self.cfg.factor)
        new_intrs, c2ws, new_near_fars = normalize_cameras(
            intrs, w2cs, scale_mat)
        depths = [d * scale_factor for d in depths]
        if pseudo_depth_ref is not None:
            pseudo_depth_ref = pseudo_depth_ref * scale_factor

        imgs = np.stack(imgs).astype(np.float32)
        masks = np.stack(masks).astype(np.float32)
        depths = np.stack(depths).astype(np.float32)

        outputs = {
            "imgs": imgs,
            "intrs": new_intrs.astype(np.float32),
            "c2ws": c2ws.astype(np.float32),
            "masks": masks,
            "scale_mat": (w2c_ref_inv @ scale_mat).astype(np.float32),
            "view_ids": np.asarray(view_ids, np.int64),
            "scene": scan,
            "file_name": f"{scan}_view{ref_view}_light{light}",
        }

        if self.mode == "train":
            px, py = sample_train_pixels(self.rng, masks[0], self.cfg.n_rays)
        else:
            stride = self.cfg.val_res_level
            px, py = val_grid(self.img_hw, stride)
            outputs.update({
                "bound_min": np.array([-1, -1, -1], np.float32),
                "bound_max": np.array([1, 1, 1], np.float32),
                "hw": np.array([H // stride, W // stride], np.int64),
            })

        ix, iy = px.astype(np.int64), py.astype(np.int64)
        outputs["color"] = imgs[0][iy, ix]
        outputs["depth"] = depths[0][iy, ix]
        outputs["mask"] = masks[0][iy, ix]
        rays_o, rays_d = pixels_to_rays(px, py, new_intrs[0], c2ws[0])
        outputs["rays_o"] = rays_o
        outputs["rays_d"] = rays_d
        outputs["near"] = new_near_fars[0, :1].reshape(1, 1)
        outputs["far"] = new_near_fars[0, 1:].reshape(1, 1)
        outputs["depth_ref"] = depths[0]
        outputs["mask_ref"] = masks[0]

        if pseudo_depth_ref is not None:
            outputs["pseudo_depth"] = pseudo_depth_ref[iy, ix]
            outputs["pseudo_depth_ref"] = pseudo_depth_ref
            pts = self._pseudo_points(pseudo_depth_ref, masks[0],
                                      new_intrs[0], c2ws[0])
            if pts is not None:
                outputs["pseudo_pts"] = pts

        return outputs

    def _pseudo_points(self, pseudo_depth, mask, intr, c2w):
        """Back-project ``n_pseudo_pts`` random pseudo-depth pixels to world
        points; None when at most 100 pixels are valid."""
        valid = (pseudo_depth > 0) & (mask > 0)
        if valid.sum() <= 100:
            return None
        ys, xs = np.nonzero(valid)
        sel = self.rng.randint(0, len(xs), size=self.cfg.n_pseudo_pts)
        x = xs[sel].astype(np.float32)
        y = ys[sel].astype(np.float32)
        d = pseudo_depth[ys[sel], xs[sel]]
        cam = np.stack([x, y, np.ones_like(x)], axis=0) * d[None]
        cam = np.linalg.inv(intr) @ cam
        homo = np.concatenate([cam, np.ones_like(cam[:1])], axis=0)
        world = (c2w @ homo)[:3]
        return world.T.astype(np.float32)
