"""DTU per-scene finetune dataset (own copy of
gens_tpu/data/dtu_finetune.py).

One scene: the fixed reference view and its top pair sources, every image,
mask and pseudo depth loaded up front; random-ray batches on a rotating
view, and the full val grid on a view. The pseudo point cloud merges the
back-projections of every view. :class:`FinetuneRays` holds the batch
protocol the BMVS finetune dataset shares.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from gens_torch.config import DatasetConfig
from gens_torch.data.cameras import (frustum_union_scale_mat,
                                     normalize_cameras, pixels_to_rays)
from gens_torch.data.dtu import DTUDataset, val_grid


class FinetuneRays:
    """The finetune batch protocol over preloaded views: ``imgs``,
    ``masks``, ``norm_intrs``, ``c2ws``, ``new_near_fars``, ``scale_mat``,
    ``scene``, ``num_views``, ``pseudo_depths`` (or None: no pseudo depth
    in the batches) and ``pseudo_cloud`` (or None), drawing from
    ``rng``."""

    pseudo_depths: Optional[np.ndarray] = None
    pseudo_cloud: Optional[np.ndarray] = None

    def get_all_images(self) -> Dict[str, np.ndarray]:
        """Inputs of the one-shot volume build."""
        return {"imgs": self.imgs, "intrs": self.norm_intrs,
                "c2ws": self.c2ws}

    def _on_view(self, vid: int, px, py) -> Dict[str, np.ndarray]:
        """The views in the order [vid, the others] and the rays through
        (px, py) of view ``vid``."""
        ix, iy = px.astype(np.int64), py.astype(np.int64)
        order = [vid] + [i for i in range(self.num_views) if i != vid]
        rays_o, rays_d = pixels_to_rays(px, py, self.norm_intrs[vid],
                                        self.c2ws[vid])
        return {
            "imgs": self.imgs[order],
            "intrs": self.norm_intrs[order],
            "c2ws": self.c2ws[order],
            "view_ids": np.asarray(order, np.int64),
            "rays_o": rays_o,
            "rays_d": rays_d,
            "near": self.new_near_fars[vid, :1].reshape(1, 1),
            "far": self.new_near_fars[vid, 1:].reshape(1, 1),
            "color": self.imgs[vid][iy, ix],
            "mask": self.masks[vid][iy, ix],
        }

    def get_random_rays(self, vid: int) -> Dict[str, np.ndarray]:
        """A uniform random ray batch on view ``vid``."""
        H, W = self.img_hw
        n = self.cfg.n_rays
        px = self.rng.randint(0, W, size=n).astype(np.float32)
        py = self.rng.randint(0, H, size=n).astype(np.float32)
        out = self._on_view(vid, px, py)
        if self.pseudo_depths is not None:
            out["pseudo_depth"] = self.pseudo_depths[vid][
                py.astype(np.int64), px.astype(np.int64)]
        if self.pseudo_cloud is not None:
            sel = self.rng.randint(0, len(self.pseudo_cloud),
                                   size=self.cfg.n_pseudo_pts)
            out["pseudo_pts"] = self.pseudo_cloud[sel]
        return out

    def get_rays_at(self, vid: int) -> Dict[str, np.ndarray]:
        """The full val ray grid on view ``vid``."""
        H, W = self.img_hw
        stride = self.cfg.val_res_level
        out = self._on_view(vid, *val_grid(self.img_hw, stride))
        out.update({
            "masks": self.masks,
            "bound_min": np.array([-1, -1, -1], np.float32),
            "bound_max": np.array([1, 1, 1], np.float32),
            "hw": np.array([H // stride, W // stride], np.int64),
            "scale_mat": self.scale_mat,
            "scene": self.scene,
        })
        return out


class DTUFinetuneDataset(DTUDataset, FinetuneRays):
    def __init__(self, cfg: DatasetConfig,
                 rng: Optional[np.random.RandomState] = None):
        super().__init__(cfg, mode="finetune", rng=rng)
        if not (cfg.scene and cfg.ref_view):
            raise ValueError("finetune needs scene and ref_view")
        self.scene = cfg.scene[0]
        self.ref_view = int(cfg.ref_view[0])
        self.light = int(cfg.light_idx[0] if cfg.light_idx else 3)

        pairs = list(self.pairs[self.ref_view])
        self.view_ids = [self.ref_view] + [
            int(v) for v in pairs[: cfg.num_views - 1]]
        self.num_views = len(self.view_ids)

        self._load_all()

    def _load_all(self):
        H, W = self.img_hw
        w2c_ref_inv = np.linalg.inv(self.w2cs[self.ref_view])
        imgs, intrs, w2cs, near_fars, masks, pdepths = [], [], [], [], [], []
        for vid in self.view_ids:
            imgs.append(self._read_img(self._img_path(self.scene, vid,
                                                      self.light)))
            intrs.append(self.intrs[vid])
            w2cs.append(self.w2cs[vid] @ w2c_ref_inv)
            near_fars.append(self.near_fars[vid])
            try:
                masks.append(self._read_mask(self.scene, vid))
            except FileNotFoundError:
                masks.append(np.ones((H, W), np.float32))
            pd = self._read_pseudo_depth(self.scene, vid)
            pdepths.append(pd if pd is not None
                           else np.zeros((H, W), np.float32))

        scale_mat, scale_factor = frustum_union_scale_mat(
            self.img_hw, intrs, w2cs, near_fars, factor=self.cfg.factor)
        self.scale_factor = scale_factor
        new_intrs, c2ws, new_near_fars = normalize_cameras(
            intrs, w2cs, scale_mat)

        self.imgs = np.stack(imgs).astype(np.float32)
        self.masks = np.stack(masks).astype(np.float32)
        self.pseudo_depths = (np.stack(pdepths).astype(np.float32)
                              * scale_factor)
        self.norm_intrs = new_intrs.astype(np.float32)
        self.c2ws = np.stack(c2ws).astype(np.float32)
        self.new_near_fars = new_near_fars
        self.scale_mat = (w2c_ref_inv @ scale_mat).astype(np.float32)

        # the pseudo point cloud of every view
        pts_all = []
        for i in range(self.num_views):
            pd = self.pseudo_depths[i]
            valid = (pd > 0) & (self.masks[i] > 0)
            if valid.sum() < 10:
                continue
            ys, xs = np.nonzero(valid)
            cam = np.stack([xs, ys, np.ones_like(xs)], 0).astype(np.float32) \
                * pd[ys, xs][None]
            cam = np.linalg.inv(self.norm_intrs[i]) @ cam
            homo = np.concatenate([cam, np.ones_like(cam[:1])], 0)
            pts_all.append(((self.c2ws[i] @ homo)[:3]).T)
        self.pseudo_cloud = (np.concatenate(pts_all, 0).astype(np.float32)
                             if pts_all else None)
