"""Offline DTU_TEST mesh cleaning (own copy of
gens_tpu/eval/clean_meshes.py).

For each test scan: load the exported val mesh, keep faces whose vertices
project into the dilated object masks of the test views (disk-11
dilation, "strictly more than minimal_vis" views), then keep only faces
seen as first hits from the views' upscaled pixel grids (the native BVH of
``mesh/clean.py``) and drop components under 500 faces. The view lists for
reference views 23 and 43 are the reference's. Cameras come from
``scan{X}/cameras.npz`` (``world_mat_i``, ``scale_mat_i``), decomposed by
the numpy rebuild of ``cv2.decomposeProjectionMatrix``; masks decode
through PIL.

Usage:
    python -m gens_torch.eval.clean_meshes --root_dir DTU_TEST \
        --out_dir outputs/mesh --n_view 3 --set 0
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np

from gens_torch.data.cameras import load_K_Rt_from_P
from gens_torch.data.image_io import read_image

DTU_TEST_SCANS = (24, 37, 40, 55, 63, 65, 69, 83, 97, 105, 106, 110, 114,
                  118, 122)
VIEW_LIST_SET0 = (23, 24, 33, 22, 15, 34, 14, 32, 16, 35, 25)
VIEW_LIST_SET1 = (43, 33, 44, 42, 34, 32, 45, 23, 41, 24, 31)


def load_scan_cameras(root_dir: str, scan: int, view_ids):
    """(intrs (V, 3, 3), c2ws (V, 4, 4)) of ``scan{X}/cameras.npz``."""
    cams = np.load(os.path.join(root_dir, f"scan{scan}", "cameras.npz"))
    intrs, c2ws = [], []
    for vid in view_ids:
        P = (cams[f"world_mat_{vid}"] @ cams.get(
            f"scale_mat_{vid}", np.eye(4)))[:3, :4]
        intr, pose = load_K_Rt_from_P(P)
        intrs.append(intr)
        c2ws.append(pose)
    return np.stack(intrs), np.stack(c2ws)


def load_masks(root_dir: str, scan: int, view_ids):
    """(V, H, W) binary masks from ``scan{X}/mask/{vid:03d}.png`` (or
    ``.jpg``), thresholded at 127.5 of the channel mean."""
    masks = []
    for vid in view_ids:
        for pattern in (f"scan{scan}/mask/{vid:03d}.png",
                        f"scan{scan}/mask/{vid:03d}.jpg"):
            path = os.path.join(root_dir, pattern)
            if os.path.exists(path):
                m = read_image(path)
                if m.ndim == 3:
                    m = m.mean(axis=-1)
                masks.append((m > 127.5).astype(np.float32))
                break
        else:
            raise FileNotFoundError(f"mask for scan{scan} view {vid}")
    return np.stack(masks)


def main(argv=None):
    from gens_torch.mesh.clean import (clean_mesh_by_mask,
                                       clean_mesh_outside_frustum)
    from gens_torch.mesh.ply import read_ply, write_ply

    p = argparse.ArgumentParser()
    p.add_argument("--root_dir", type=str, default="./DTU_TEST")
    p.add_argument("--out_dir", type=str, default="./outputs/mesh")
    p.add_argument("--n_view", type=int, default=3)
    p.add_argument("--set", type=int, default=0, choices=[0, 1])
    args = p.parse_args(argv)

    view_list = VIEW_LIST_SET0 if args.set == 0 else VIEW_LIST_SET1
    view_ids = list(view_list[: args.n_view])

    final_dir = os.path.join(args.out_dir, "final")
    os.makedirs(final_dir, exist_ok=True)

    for scan in DTU_TEST_SCANS:
        matches = glob(os.path.join(args.out_dir, f"*scan{scan}_epoch0.ply"))
        if not matches:
            print(f"scan{scan}: no mesh found, skipping")
            continue
        print(f"processing scan{scan}")
        verts, tris = read_ply(matches[0])
        intrs, c2ws = load_scan_cameras(args.root_dir, scan, view_ids)
        masks = load_masks(args.root_dir, scan, view_ids)

        verts, tris = clean_mesh_by_mask(
            verts, tris, masks, intrs, c2ws, min_nb_visible=1,
            dilate_radius=11)
        if len(tris):
            verts, tris = clean_mesh_outside_frustum(
                verts, tris, intrs, c2ws, masks.shape[1:3], upscale=2,
                min_component=500)
        write_ply(os.path.join(final_dir, f"scan{scan}.ply"), verts, tris)
        print(f"  -> {len(verts)} verts, {len(tris)} faces")


if __name__ == "__main__":
    main()
