"""The quality-evaluation slice of gens_torch on the CPU, against the JAX
package: mesh cleaning (gens_torch/mesh/clean.py against
gens_tpu.mesh.clean, on a small marching-tetrahedra sphere under the
synthetic rig), the cv2-free dilation against cv2, the Chamfer evaluation
(gens_torch/eval/chamfer.py against gens_tpu.eval.chamfer, on a scan made
up in tmp_path), the synthetic shape helpers, the quality metrics and
protocol (gens_torch/eval/quality.py against scripts/quality_synthetic.py,
loaded with importlib), the quality entry point on a small seeded model,
and Runner.validate's ``clean_mesh`` against gens_tpu's cleaning."""

import importlib.util
import json
import os
import pickle

import cv2
import numpy as np
import pytest
import scipy.io
import torch

from gens_tpu.data import synthetic as jsyn
from gens_tpu.eval import chamfer as jchamfer
from gens_tpu.mesh import clean as jclean
from gens_torch.convert import params_to_jax
from gens_torch.data import synthetic as tsyn
from gens_torch.eval import chamfer as tchamfer
from gens_torch.eval import quality as tquality
from gens_torch.mesh import clean as tclean
from gens_torch.mesh.isosurface import marching_tetrahedra
from gens_torch.mesh.ply import read_ply, write_ply
from gens_torch.utils.profiling import counter

import _torch_common  # noqa: E402,F401  (one torch thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    """scripts/quality_synthetic.py as a module (it stays unedited)."""
    spec = importlib.util.spec_from_file_location(
        "quality_synthetic", os.path.join(REPO, "scripts",
                                          "quality_synthetic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sphere_mesh(res=41, radius=0.5, center=(0.0, 0.0, 0.0)):
    lin = np.linspace(-1, 1, res, dtype=np.float32)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    c = np.asarray(center, np.float32)
    grid = radius - np.sqrt((gx - c[0]) ** 2 + (gy - c[1]) ** 2
                            + (gz - c[2]) ** 2)
    v, t = marching_tetrahedra(grid, 0.0)
    return v / (res - 1) * 2.0 - 1.0, t


@pytest.fixture(scope="module")
def rig():
    """A sphere mesh larger than the rendered sphere (so the masks cut it)
    and the synthetic rig's 3 views at 48x64 with their hit masks."""
    verts, tris = _sphere_mesh(radius=0.6)
    s = tsyn.make_scene(n_views=3, hw=(48, 64), n_rays=4, seed=123,
                        spread=0.5, ang0=0.9, radius=0.35)
    return verts, tris, s["view_masks"], s["intrs"], s["c2ws"]


def _same_mesh(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("radius", [2, 11])
def test_dilate_mask_equals_cv2(radius):
    rng = np.random.RandomState(radius)
    mask = (rng.rand(60, 80) > 0.97).astype(np.float32)
    mask[:3, :5] = 1.0  # reaches the border
    k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                  (2 * radius + 1, 2 * radius + 1))
    np.testing.assert_array_equal(tclean.ellipse_footprint(radius), k)
    ref = cv2.dilate(mask.astype(np.uint8), k).astype(np.float32)
    got = tclean._dilate_mask(mask, radius)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_raycaster_matches_jax_package(rig):
    verts, tris = rig[:2]
    rng = np.random.RandomState(0)
    o = rng.uniform(-2, 2, (4000, 3)).astype(np.float32)
    d = rng.randn(4000, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:2000] = -o[:2000] / np.linalg.norm(o[:2000], axis=-1, keepdims=True)
    hit, t = tclean.Raycaster(verts, tris).first_hit(o, d)
    jhit, jt = jclean.Raycaster(verts, tris).first_hit(o, d)
    assert (hit >= 0).sum() > 1500
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_allclose(t, jt, rtol=1e-6, atol=1e-6)


def test_clean_mesh_by_mask_matches_jax_package(rig):
    verts, tris, masks, intrs, c2ws = rig
    kept = []
    for r, k in ((2, 1), (11, 1), (2, 0)):
        got = tclean.clean_mesh_by_mask(verts, tris, masks, intrs, c2ws,
                                        min_nb_visible=k, dilate_radius=r)
        ref = jclean.clean_mesh_by_mask(verts, tris, masks, intrs, c2ws,
                                        min_nb_visible=k, dilate_radius=r)
        _same_mesh(got, ref)
        kept.append(len(got[1]))
    # a wider dilation or fewer views needed keep more faces
    assert 0 < kept[0] < kept[2] < len(tris) and kept[0] < kept[1]


def test_face_components_match_jax_package(rig):
    verts, tris = rig[:2]
    v2, t2 = _sphere_mesh(res=17, radius=0.3, center=(0.5, 0.5, 0.5))
    both = np.concatenate([tris, t2 + len(verts)])
    got = tclean.face_components(both)
    np.testing.assert_array_equal(got, jclean.face_components(both))
    assert len(np.unique(got)) == 2
    assert len(tclean.face_components(both[:0])) == 0


def test_clean_mesh_outside_frustum_matches_jax_package(rig):
    verts, tris, masks, intrs, c2ws = rig
    for upscale, min_comp in ((None, 100), (2, 500), (3, 10 ** 6)):
        got = tclean.clean_mesh_outside_frustum(
            verts, tris, intrs, c2ws, masks.shape[1:3], upscale=upscale,
            min_component=min_comp)
        ref = jclean.clean_mesh_outside_frustum(
            verts, tris, intrs, c2ws, masks.shape[1:3], upscale=upscale,
            min_component=min_comp)
        _same_mesh(got, ref)
    assert len(got[1]) == 0  # no component has a million faces


def test_clean_mesh_matches_jax_package(rig):
    verts, tris, masks, intrs, c2ws = rig
    got = tclean.clean_mesh(verts, tris, masks, intrs, c2ws)
    ref = jclean.clean_mesh(verts, tris, masks, intrs, c2ws)
    assert 0 < len(got[1]) < len(tris)
    _same_mesh(got, ref)


def test_synthetic_shape_helpers_match_jax_package():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsyn.sphere_sdf(pts, 0.4),
                                  jsyn.sphere_sdf(pts, 0.4))
    kw = tquality.scene_params(-2)
    c, r = tsyn.shape_spheres(kw["shape"], kw["radius"])
    np.testing.assert_array_equal(tsyn.shape_distance(pts, c, r),
                                  jsyn.shape_distance(pts, c, r))
    np.testing.assert_array_equal(
        tsyn.shape_surface_samples(c, r, 3000, np.random.RandomState(5)),
        jsyn.shape_surface_samples(c, r, 3000, np.random.RandomState(5)))


def test_sample_and_downsample_match_jax_package(rig):
    verts, tris = rig[:2]
    v = verts.astype(np.float64) * 50.0
    for density in (0.2, 1.0, 3.0):
        got = tchamfer.sample_mesh_points(v, tris, density)
        np.testing.assert_array_equal(
            got, jchamfer.sample_mesh_points(v, tris, density))
    np.testing.assert_array_equal(tchamfer.radius_downsample(got, 3.0),
                                  jchamfer.radius_downsample(got, 3.0))


def test_evaluate_scan_matches_jax_package(rig, tmp_path):
    verts, tris = rig[:2]
    # a made-up scan 24 in mm: the mesh, a GT sphere of points, an ObsMask
    # that observes the upper half of the box, and a tilted ground plane
    scan = 24
    mesh = verts * 40.0 + 100.0
    gt, _ = _sphere_mesh(res=29, radius=0.62)
    gt = gt * 40.0 + 100.0
    os.makedirs(tmp_path / "ObsMask")
    os.makedirs(tmp_path / "Points" / "stl")
    obs = np.zeros((20, 20, 20), np.uint8)
    obs[:, :, 8:] = 1
    scipy.io.savemat(tmp_path / "ObsMask" / f"ObsMask{scan}_10.mat",
                     {"ObsMask": obs,
                      "BB": np.array([[60.0, 60.0, 60.0],
                                      [140.0, 140.0, 140.0]]),
                      "Res": np.array([[4.0]])})
    scipy.io.savemat(tmp_path / "ObsMask" / f"Plane{scan}.mat",
                     {"P": np.array([[0.1], [0.0], [1.0], [-90.0]])})
    write_ply(str(tmp_path / "Points" / "stl" / f"stl{scan:03}_total.ply"),
              gt, np.zeros((0, 3), np.int32))
    write_ply(str(tmp_path / "scan24.ply"), mesh, tris)
    got = tchamfer.evaluate_scan(str(tmp_path / "scan24.ply"), str(tmp_path),
                                 scan, density=1.0)
    ref = jchamfer.evaluate_scan(str(tmp_path / "scan24.ply"), str(tmp_path),
                                 scan, density=1.0)
    assert got == ref
    assert 0 < got["d2s"] < 20 and 0 < got["s2d"] < 20
    for a, b in zip(tchamfer.load_obs_mask(
            str(tmp_path / "ObsMask" / f"ObsMask{scan}_10.mat")),
            jchamfer.load_obs_mask(
                str(tmp_path / "ObsMask" / f"ObsMask{scan}_10.mat"))):
        np.testing.assert_array_equal(a, b)
    assert read_ply(str(tmp_path / "scan24.ply"))[1].shape == tris.shape


def test_protocol_matches_script():
    script = _script()
    for i in (-2, -1, 0, 1, 4, 5):
        assert tquality.scene_params(i) == script.scene_params(i), i
    j = script.build_config(10, dims=128, samples=64, bf16=True,
                            agg="pallas").model
    t = tquality.build_config(128, 64).model
    assert tuple(t.volume.volume_dims) == tuple(j.volume.volume_dims)
    for sub, key in (("render", "n_samples"), ("render", "n_importance"),
                     ("sdf_network", "packed_trilerp"),
                     ("color_network", "packed_bilerp"),
                     ("volume", "packed_bilerp"), ("volume", "dtype"),
                     ("reg_network", "dtype"), ("sdf_network", "volume_dtype"),
                     ("color_network", "packed_dtype")):
        assert getattr(getattr(t, sub), key) == getattr(getattr(j, sub), key)


@pytest.mark.parametrize("scene", [-1, -2])
def test_mesh_metrics_match_script(scene):
    script = _script()
    kw = tquality.scene_params(scene)
    c, r = tsyn.shape_spheres(kw.get("shape"), kw["radius"])
    # the analytic shape, 4% too large, meshed at 49³: a mesh near the
    # surface with the right topology
    lin = np.linspace(-1, 1, 49, dtype=np.float32)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    grid = -np.min(np.stack([np.linalg.norm(g - cc, axis=-1) - 1.04 * rr
                             for cc, rr in zip(c, r)], -1), -1)
    verts, tris = marching_tetrahedra(grid.reshape(49, 49, 49), 0.0)
    verts = verts / 48 * 2.0 - 1.0
    s = tsyn.make_scene(n_views=3, hw=(48, 64), n_rays=4, seed=123,
                        spread=0.5, **kw)
    raw = {"masks": s["view_masks"], "intrs": s["intrs"], "c2ws": s["c2ws"]}
    got = tquality.mesh_metrics(verts, tris, kw, raw, "x")
    ref = script.mesh_metrics(verts, tris, kw, raw, "x")
    assert got == ref
    assert got["x_verts_scored"] > 0 and 0 < got["x_acc_mean"] < 0.05
    empty = tquality.mesh_metrics(verts[:0], tris[:0], kw, raw, "x")
    assert np.isnan(empty["x_acc_mean"])


def _write_ckpt(path, cfg):
    from gens_torch.models.gens import GenSModel

    torch.manual_seed(0)
    model = GenSModel(cfg.model)
    with open(path, "wb") as f:
        pickle.dump({"epoch": 0, "step": 7, "format_version": 2,
                     "params": params_to_jax(model.state_dict())}, f)


def test_quality_entry_point_on_cpu(tmp_path):
    ckpt = tmp_path / "seeded.pkl"
    _write_ckpt(ckpt, tquality.build_config(32, 8))
    out = tmp_path / "q.json"
    before = counter("k3.launches")
    res = tquality.main(["--ckpt", str(ckpt), "--scenes", "heldout",
                         "--hw", "32", "32", "--dims", "32", "--samples", "8",
                         "--mesh-res", "32", "--device", "cpu",
                         "--out", str(out)])
    assert counter("k3.launches") == before  # CPU: the plain MLP
    assert res["config"]["volume_dims"] == [32, 16, 8, 4, 2]
    assert res["ckpt_step"] == 7 and res["params_stored_dtype"] == ["float32"]
    assert res["heldout_rays"] == 16 * 16
    assert np.isfinite(res["heldout_psnr"])
    # a seeded model's mesh, cleaned by the held-out views
    assert res["heldout_verts_raw"] > res["heldout_verts_clean"] > 0
    assert json.loads(out.read_text())["heldout_psnr"] == res["heldout_psnr"]
    with pytest.raises(ValueError, match="unknown scenes"):
        tquality.main(["--ckpt", str(ckpt), "--scenes", "nope",
                       "--device", "cpu"])


def test_validate_cleans_the_mesh_as_jax_does(tmp_path):
    from gens_torch.config import load_config
    from gens_torch.mesh.extract import grid_to_mesh
    from gens_torch.runner import Runner

    cfg = tquality.build_config(32, 8, bf16=False, agg="table")
    ckpt = tmp_path / "seeded.pkl"
    _write_ckpt(ckpt, cfg)
    meshes = {}
    for clean in (False, True):
        exp = tmp_path / f"exp{int(clean)}"
        c = load_config(None, [
            "model.volume.volume_dims=[32,16,8,4,2]",
            "model.render.n_samples=8", "model.render.n_importance=8",
            "val_dataset.dataset_name=synthetic", 'val_dataset.scene=["s0"]',
            "val_dataset.img_hw=[64,64]", "val_dataset.num_src_view=2",
            "val_dataset.val_res_level=4", "mesh_resolution=32",
            f"clean_mesh={json.dumps(clean)}", f"base_exp_dir={exp}"])
        c.mode = "val"
        runner = Runner(c, "cpu")
        runner.validate_all(str(ckpt))
        meshes[clean] = read_ply(str(exp / "meshes" / "sphere0_epoch0.ply"))
        st = runner.stats[0]
    raw_verts, raw_tris = grid_to_mesh(runner.last_sdf_grid, [-1] * 3,
                                       [1] * 3)
    _same_mesh(meshes[False], (raw_verts, raw_tris))
    from gens_tpu.data.synthetic import SyntheticDataset

    item = SyntheticDataset(1, 3, (64, 64), val_res_level=4, mode="val")[0]
    ref = jclean.clean_mesh(raw_verts, raw_tris, item["masks"],
                            np.asarray(item["intrs"]),
                            np.asarray(item["c2ws"]))
    assert 0 < len(ref[1]) < len(raw_tris)
    _same_mesh(meshes[True], ref)
    assert st["n_tris_clean"] == len(ref[1]) and st["n_tris"] == len(raw_tris)
