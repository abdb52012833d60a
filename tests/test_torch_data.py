"""The port's DTU and BlendedMVS readers (gens_torch/data/) against the
JAX package's on the on-disk trees that tests/test_data_loaders.py writes
(``dtu_tree``, ``bmvs_tree``), item by item on the same ``RandomState``
seed; the numpy rebuilds of ``cv2.decomposeProjectionMatrix`` and
``cv2.resize(INTER_NEAREST)`` against cv2; the dataset dispatch; and the
offline DTU mesh cleaning against gens_tpu/eval/clean_meshes.py.

Limits: decoded images, masks, depths, pseudo depths, the drawn pixels and
source views exactly; cameras, scale matrices, near/far, rays and pseudo
points within 1e-5 of the array's largest magnitude (the decomposition
differs from cv2's by ~1e-13 in float64, then both round to float32)."""

import os
import shutil

import cv2
import numpy as np
import pytest

import _torch_common  # noqa: F401  (torch at one thread)
from test_data_loaders import (IMG_HW, bmvs_tree, dtu_tree,  # noqa: F401
                               write_png)

from gens_tpu.config import DatasetConfig as JDatasetConfig
from gens_tpu.data.bmvs import BMVSDataset as JBMVS
from gens_tpu.data.bmvs import BMVSFinetuneDataset as JBMVSFinetune
from gens_tpu.data.dtu import DTUDataset as JDTU
from gens_tpu.data.dtu_finetune import DTUFinetuneDataset as JDTUFinetune
from gens_torch.config import DatasetConfig as TDatasetConfig
from gens_torch.data.bmvs import BMVSDataset, BMVSFinetuneDataset
from gens_torch.data.cameras import (decompose_projection_matrix,
                                     load_K_Rt_from_P)
from gens_torch.data.dtu import DTUDataset, load_split
from gens_torch.data.dtu_finetune import DTUFinetuneDataset
from gens_torch.data.image_io import resize_nearest

CLOSE = ("intrs", "c2ws", "scale_mat", "near", "far", "rays_o", "rays_d",
         "pseudo_pts")
TOL = 1e-5


def assert_same(got: dict, want: dict):
    """Every key of a port item against the JAX item's."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in CLOSE:
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= TOL * scale, k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def cfgs(**kw):
    """The same dataset config in both packages."""
    return TDatasetConfig(**kw), JDatasetConfig(**kw)


def dtu_kw(root, scan, **kw):
    base = dict(dataset_name="dtu", data_dir=root, split=None, scene=(scan,),
                light_idx=(2, 3), ref_view=(0, 1), num_src_view=2,
                img_hw=IMG_HW, n_rays=64, n_pseudo_pts=128, val_res_level=4)
    base.update(kw)
    return base


# -- cv2 rebuilds -------------------------------------------------------------


@pytest.mark.parametrize("signs", ["positive", "neg_fx", "neg_fy",
                                   "neg_both", "neg_scale"])
def test_decompose_projection_matrix_matches_cv2(signs):
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(len(signs))
    for _ in range(200):
        R = Rotation.random(random_state=rng).as_matrix()
        f = rng.uniform(200, 2000, 2)
        f[0] *= -1 if signs in ("neg_fx", "neg_both") else 1
        f[1] *= -1 if signs in ("neg_fy", "neg_both") else 1
        K = np.array([[f[0], rng.uniform(-5, 5), rng.uniform(0, 1600)],
                      [0, f[1], rng.uniform(0, 1200)], [0, 0, 1]])
        P = K @ np.hstack([R, rng.randn(3, 1) * 500])
        P *= rng.uniform(0.01, 100) * (-1 if signs == "neg_scale" else 1)
        want = cv2.decomposeProjectionMatrix(P)
        got = decompose_projection_matrix(P)
        for a, b in zip(got[:2], want[:2]):
            assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()
        c_got, c_want = got[2][:3] / got[2][3], want[2][:3] / want[2][3]
        assert np.abs(c_got - c_want).max() <= 1e-9 * np.abs(c_want).max()
        intr, pose = load_K_Rt_from_P(P)
        assert intr.dtype == pose.dtype == np.float32
        np.testing.assert_allclose(intr, want[0] / want[0][2, 2], rtol=1e-6)
        np.testing.assert_allclose(pose[:3, :3], want[1].T, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((1200, 1600), (480, 640)),
                                     ((1200, 1600), (1152, 1600)),
                                     ((1536, 2048), (576, 768)),
                                     ((24, 32), (48, 64))])
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_nearest_matches_cv2_bit_for_bit(src, dst, channels):
    shape = src + ((channels,) if channels else ())
    img = np.random.RandomState(0).rand(*shape).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    got = resize_nearest(img, dst)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)


# -- DTU ----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["train", "val"])
def test_dtu_items_match_jax(dtu_tree, mode):  # noqa: F811
    root, scan = dtu_tree
    tcfg, jcfg = cfgs(**dtu_kw(root, scan))
    port = DTUDataset(tcfg, mode, rng=np.random.RandomState(3))
    ref = JDTU(jcfg, mode, rng=np.random.RandomState(3))
    assert port.metas == ref.metas and len(port) == 4
    # every item in a shuffled order, sharing each dataset's stream
    for idx in (2, 0, 3, 1, 2):
        got, want = port[idx], ref[idx]
        if mode == "train":
            assert got["pseudo_pts"].shape == (128, 3)
        assert_same(got, want)
    assert np.array_equal(port.rng.get_state()[1], ref.rng.get_state()[1])


def test_dtu_item_without_pseudo_points(dtu_tree, tmp_path):  # noqa: F811
    """A reference view whose pseudo depth has at most 100 valid pixels
    yields no ``pseudo_pts`` in either package."""
    root, scan = dtu_tree
    copy = str(tmp_path / "dtu")
    shutil.copytree(root, copy)
    np.save(os.path.join(copy, f"pseudo_depths/{scan}/0_epoch0.npy"),
            np.zeros((24, 32), np.float32))
    tcfg, jcfg = cfgs(**dtu_kw(copy, scan, light_idx=(3,), ref_view=(0,)))
    got = DTUDataset(tcfg, "train", rng=np.random.RandomState(1))[0]
    want = JDTU(jcfg, "train", rng=np.random.RandomState(1))[0]
    assert "pseudo_pts" not in got and "pseudo_depth" in got
    assert_same(got, want)


def test_dtu_split_lists_match_jax():
    from gens_tpu.data.dtu import load_split as jload_split

    for name in ("train", "test", "all", "train_all"):
        assert load_split(name) == jload_split(name)
    assert len(load_split("train")) == 75


@pytest.mark.parametrize("mask_missing", [False, True])
def test_dtu_finetune_matches_jax(dtu_tree, tmp_path,  # noqa: F811
                                  mask_missing):
    root, scan = dtu_tree
    if mask_missing:
        # a view without a mask file is all ones in both packages
        root_copy = str(tmp_path / "dtu")
        shutil.copytree(root, root_copy)
        os.remove(os.path.join(root_copy,
                               f"Depths_raw/{scan}/depth_visual_0001.png"))
        root = root_copy
    kw = dtu_kw(root, scan, light_idx=(3,), ref_view=(0,), num_views=3,
                val_res_level=8)
    tcfg, jcfg = cfgs(**kw)
    port = DTUFinetuneDataset(tcfg, rng=np.random.RandomState(5))
    ref = JDTUFinetune(jcfg, rng=np.random.RandomState(5))
    assert port.view_ids == ref.view_ids and port.num_views == 3
    if mask_missing:
        assert (port.masks[1] == 1).all()
    assert_same(port.get_all_images(), ref.get_all_images())
    scale = np.abs(ref.pseudo_cloud).max()
    assert np.abs(port.pseudo_cloud - ref.pseudo_cloud).max() <= TOL * scale
    for vid in (1, 0, 2, 2):
        assert_same(port.get_random_rays(vid), ref.get_random_rays(vid))
    assert_same(port.get_rays_at(0), ref.get_rays_at(0))


# -- BlendedMVS ---------------------------------------------------------------


def bmvs_kw(root, scene, **kw):
    base = dict(dataset_name="bmvs", data_dir=root, split=None,
                scene=(scene,), ref_view=None, num_src_view=2, img_hw=IMG_HW,
                n_rays=64, val_res_level=4, num_views=3)
    base.update(kw)
    return base


@pytest.mark.parametrize("mode", ["train", "val"])
def test_bmvs_items_match_jax(bmvs_tree, mode):  # noqa: F811
    root, scene = bmvs_tree
    tcfg, jcfg = cfgs(**bmvs_kw(root, scene))
    port = BMVSDataset(tcfg, mode, rng=np.random.RandomState(2))
    ref = JBMVS(jcfg, mode, rng=np.random.RandomState(2))
    assert port.metas == ref.metas and len(port) == 8
    for idx in (0, 5, 7):
        assert_same(port[idx], ref[idx])


def test_bmvs_finetune_matches_jax(bmvs_tree):  # noqa: F811
    root, scene = bmvs_tree
    tcfg, jcfg = cfgs(**bmvs_kw(root, scene, ref_view=(0,), val_res_level=8))
    port = BMVSFinetuneDataset(tcfg, rng=np.random.RandomState(4))
    ref = JBMVSFinetune(jcfg, rng=np.random.RandomState(4))
    assert port.view_ids == ref.view_ids
    assert_same(port.get_all_images(), ref.get_all_images())
    for vid in (2, 0, 1):
        assert_same(port.get_random_rays(vid), ref.get_random_rays(vid))
    assert_same(port.get_rays_at(0), ref.get_rays_at(0))


# -- dispatch -----------------------------------------------------------------


def test_get_dataset_dispatches_as_jax(dtu_tree, bmvs_tree):  # noqa: F811
    from gens_torch.data.synthetic import SyntheticDataset
    from gens_torch.runner import get_dataset
    from gens_tpu.runner import get_dataset as jget_dataset

    root, scan = dtu_tree
    broot, scene = bmvs_tree
    cases = [(dtu_kw(root, scan), "train", DTUDataset),
             (dtu_kw(root, scan), "val", DTUDataset),
             (dtu_kw(root, scan, dataset_name="DTUDataset", ref_view=(0,)),
              "finetune", DTUFinetuneDataset),
             (bmvs_kw(broot, scene), "val", BMVSDataset),
             (bmvs_kw(broot, scene, ref_view=(0,)), "finetune",
              BMVSFinetuneDataset),
             (dict(dataset_name="synthetic", scene=("a", "b"),
                   num_src_view=2, img_hw=(32, 32)), "train",
              SyntheticDataset)]
    for kw, mode, cls in cases:
        tcfg, jcfg = cfgs(**kw)
        rng = np.random.RandomState(0)
        got = get_dataset(tcfg, mode, rng)
        want = jget_dataset(jcfg, mode, np.random.RandomState(0))
        assert type(got) is cls and type(want).__name__ == cls.__name__
        if cls is not SyntheticDataset:
            assert got.rng is rng  # the runner's stream


# -- offline DTU cleaning -----------------------------------------------------


def test_clean_meshes_matches_jax(dtu_tree, tmp_path):  # noqa: F811
    """``scan{X}/cameras.npz`` (world and scale matrices) and masks written
    from ``dtu_tree``'s cameras, one sphere mesh for scan 24: the port's
    CLI writes the mesh the JAX one writes."""
    from gens_torch.data.cameras import read_mvsnet_cam
    from gens_torch.eval import clean_meshes as tclean
    from gens_torch.mesh.ply import read_ply, write_ply
    from gens_tpu.eval import clean_meshes as jclean
    from test_eval_clean import _sphere_mesh

    root, _ = dtu_tree
    test_root = tmp_path / "DTU_TEST"
    scan_dir = test_root / "scan24"
    os.makedirs(scan_dir / "mask")
    hw = (48, 64)
    scale = np.diag([300.0, 300.0, 300.0, 1.0])
    cams = {}
    for vid in tclean.VIEW_LIST_SET0[:3]:
        intr, w2c, _ = read_mvsnet_cam(
            os.path.join(root, f"Cameras/{vid:08d}_cam.txt"))
        intr = intr.astype(np.float64)
        intr[:2] *= hw[1] / 1600.0
        K4 = np.eye(4)
        K4[:3, :3] = intr
        cams[f"world_mat_{vid}"] = K4 @ w2c.astype(np.float64)
        cams[f"scale_mat_{vid}"] = scale
        mask = np.zeros(hw, np.uint8)
        mask[8:-8, 10:-10] = 255
        write_png(str(scan_dir / "mask" / f"{vid:03d}.png"), mask)
    np.savez(scan_dir / "cameras.npz", **cams)

    views = list(tclean.VIEW_LIST_SET0[:3])
    got = tclean.load_scan_cameras(str(test_root), 24, views)
    want = jclean.load_scan_cameras(str(test_root), 24, views)
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= TOL * np.abs(b).max()
    np.testing.assert_array_equal(
        tclean.load_masks(str(test_root), 24, views),
        jclean.load_masks(str(test_root), 24, views))

    verts, tris = _sphere_mesh(res=41, radius=0.5)
    outs = {}
    for name, mod in (("port", tclean), ("jax", jclean)):
        out_dir = tmp_path / name
        os.makedirs(out_dir)
        write_ply(str(out_dir / "x_scan24_epoch0.ply"), verts, tris)
        mod.main(["--root_dir", str(test_root), "--out_dir", str(out_dir),
                  "--n_view", "3"])
        outs[name] = read_ply(str(out_dir / "final" / "scan24.ply"))
    assert len(outs["port"][1]) > 0
    np.testing.assert_array_equal(outs["port"][1], outs["jax"][1])
    np.testing.assert_allclose(outs["port"][0], outs["jax"][0], atol=1e-6)
