"""BlendedMVS datasets (own copy of gens_tpu/data/bmvs.py) for the
cross-dataset evaluation and per-scene finetune.

Against DTU: a per-scene ``cams/pair.txt`` and
``blended_images/%08d_masked.jpg`` images, intrinsics calibrated at
768x576, masks from the rendered depth (``depth >= depth_min``), no light
index and no pseudo supervision. JPEGs decode through PIL.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from gens_torch.config import DatasetConfig
from gens_torch.data.cameras import (frustum_union_scale_mat,
                                     normalize_cameras, pixels_to_rays,
                                     read_mvsnet_cam, read_pfm)
from gens_torch.data.dtu import sample_train_pixels, val_grid
from gens_torch.data.dtu_finetune import FinetuneRays
from gens_torch.data.image_io import read_image, resize_nearest


class BMVSDataset:
    def __init__(self, cfg: DatasetConfig, mode: str,
                 rng: Optional[np.random.RandomState] = None):
        self.cfg = cfg
        self.mode = mode
        self.rng = rng or np.random.RandomState(0)
        self.data_dir = cfg.data_dir
        self.img_hw = tuple(cfg.img_hw)

        if cfg.scene is not None:
            self.scenes = list(cfg.scene)
        elif cfg.split is not None:
            with open(cfg.split) as f:
                self.scenes = [l.strip() for l in f if l.strip()]
        else:
            raise ValueError("no scenes configured")
        self.metas = self._build_list()

    def _build_list(self):
        metas = []
        for scene in self.scenes:
            with open(os.path.join(self.data_dir, scene, "cams",
                                   "pair.txt")) as f:
                lines = [l.rstrip() for l in f.readlines()]
            refs = (list(self.cfg.ref_view) if self.cfg.ref_view
                    else list(range(int(lines[0]))))
            for ref in refs:
                src = [int(x) for x in lines[2 * ref + 2].split()[1::2]]
                metas.append((scene, ref, src))
        return metas

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, scene, vid):
        path = os.path.join(self.data_dir, scene,
                            "cams/{:0>8}_cam.txt".format(vid))
        intr, w2c, nf = read_mvsnet_cam(path, self.cfg.interval_scale,
                                        self.cfg.num_interval)
        # BlendedMVS cameras are calibrated at 768x576
        intr = intr.copy()
        intr[0] *= self.img_hw[1] / 768.0
        intr[1] *= self.img_hw[0] / 576.0
        return intr, w2c, nf

    def _read_img(self, scene, vid):
        path = os.path.join(self.data_dir, scene, "blended_images",
                            "%08d_masked.jpg" % vid)
        return resize_nearest(read_image(path), self.img_hw) / 256.0

    def _read_depth_mask(self, scene, vid, depth_min):
        path = os.path.join(self.data_dir, scene, "rendered_depth_maps",
                            "%08d.pfm" % vid)
        depth = read_pfm(path).astype(np.float32)
        mask = (depth >= depth_min).astype(np.float32)
        return (resize_nearest(depth, self.img_hw),
                resize_nearest(mask, self.img_hw))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.cfg.num_src_view]
        H, W = self.img_hw

        imgs, intrs, w2cs, near_fars, depths, masks = [], [], [], [], [], []
        for vid in view_ids:
            intr, w2c, nf = self._read_cam(scan, vid)
            imgs.append(self._read_img(scan, vid))
            intrs.append(intr)
            w2cs.append(w2c)
            near_fars.append(nf)
            d, m = self._read_depth_mask(scan, vid, nf[0])
            depths.append(d)
            masks.append(m)

        w2c_ref_inv = np.linalg.inv(w2cs[0])
        w2cs = [w2c @ w2c_ref_inv for w2c in w2cs]

        scale_mat, scale_factor = frustum_union_scale_mat(
            self.img_hw, intrs, w2cs, near_fars, factor=self.cfg.factor)
        new_intrs, c2ws, new_near_fars = normalize_cameras(
            intrs, w2cs, scale_mat)
        depths = [d * scale_factor for d in depths]

        imgs = np.stack(imgs).astype(np.float32)
        masks = np.stack(masks).astype(np.float32)
        depths = np.stack(depths).astype(np.float32)

        outputs = {
            "imgs": imgs,
            "intrs": new_intrs.astype(np.float32),
            "c2ws": np.asarray(c2ws, np.float32),
            "masks": masks,
            "scale_mat": (w2c_ref_inv @ scale_mat).astype(np.float32),
            "view_ids": np.asarray(view_ids, np.int64),
            "scene": scan,
            "file_name": f"{scan}_view{ref_view}",
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
        return outputs


class BMVSFinetuneDataset(FinetuneRays):
    """Per-scene BMVS finetune: the fixed reference view and its pair
    sources, everything preloaded; the unmasked image where there is one,
    the mask from the masked JPEG; no pseudo supervision."""

    def __init__(self, cfg: DatasetConfig,
                 rng: Optional[np.random.RandomState] = None):
        self.cfg = cfg
        self.rng = rng or np.random.RandomState(0)
        self.data_dir = cfg.data_dir
        self.img_hw = tuple(cfg.img_hw)
        if not (cfg.scene and cfg.ref_view):
            raise ValueError("finetune needs scene and ref_view")
        self.scene = cfg.scene[0]
        self.ref_view = int(cfg.ref_view[0])

        base_cfg = dataclasses.replace(cfg, scene=(self.scene,),
                                       ref_view=(self.ref_view,))
        base = BMVSDataset(base_cfg, "finetune", rng=self.rng)
        scan, ref, srcs = base.metas[0]
        self.view_ids = [ref] + srcs[: cfg.num_views - 1]
        self.num_views = len(self.view_ids)

        images = os.path.join(self.data_dir, scan, "blended_images")
        imgs, intrs, w2cs, near_fars, masks = [], [], [], [], []
        for vid in self.view_ids:
            intr, w2c, nf = base._read_cam(scan, vid)
            masked = os.path.join(images, "{:0>8}_masked.jpg".format(vid))
            path = os.path.join(images, "{:0>8}.jpg".format(vid))
            if not os.path.exists(path):
                path = masked
            imgs.append(resize_nearest(read_image(path), self.img_hw)
                        / 256.0)
            m = resize_nearest(read_image(masked), self.img_hw)
            masks.append((m.mean(axis=-1) > 0).astype(np.float32))
            intrs.append(intr)
            w2cs.append(w2c)
            near_fars.append(nf)

        w2c_ref_inv = np.linalg.inv(w2cs[0])
        w2cs = [w2c @ w2c_ref_inv for w2c in w2cs]
        scale_mat, _ = frustum_union_scale_mat(
            self.img_hw, intrs, w2cs, near_fars, factor=cfg.factor)
        new_intrs, c2ws, new_near_fars = normalize_cameras(
            intrs, w2cs, scale_mat)

        self.imgs = np.stack(imgs).astype(np.float32)
        self.masks = np.stack(masks).astype(np.float32)
        self.norm_intrs = new_intrs.astype(np.float32)
        self.c2ws = c2ws.astype(np.float32)
        self.new_near_fars = new_near_fars
        self.scale_mat = (w2c_ref_inv @ scale_mat).astype(np.float32)
