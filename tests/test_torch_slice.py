"""The gens_torch serving slice against the JAX package on the CPU at
tiny_config sizes: build_scene, render_core(train=False) on the same
samples, build_scene + render end to end, and the val entry point
(``python -m gens_torch.main --mode val``) with its device rule and its
isolation from jax and gens_tpu."""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gens_torch.models.renderer import Scene
from gens_torch.utils.profiling import counter

from _torch_common import scene_numpy, t, tiny_models, to_np_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS = 24


@pytest.fixture(scope="module")
def setup():
    jcfg, jm, params, tcfg, tm = tiny_models()
    s = scene_numpy(n_rays=N_RAYS)
    # the JAX side runs jitted: one compile is several times faster on the
    # CPU than op-by-op dispatch
    jscene = jax.jit(jm.build_scene)(params, jnp.asarray(s["imgs"]),
                                     jnp.asarray(s["intrs"]),
                                     jnp.asarray(s["c2ws"]))
    with torch.no_grad():
        tscene = tm.build_scene(t(s["imgs"]), t(s["intrs"]), t(s["c2ws"]))
    return jm, params, tm, s, jscene, tscene


def close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(b.detach() if torch.is_tensor(b)
                                          else b),
                               np.asarray(a), rtol=rtol, atol=atol)


def test_build_scene(setup):
    jm, params, tm, s, js, ts = setup
    for a, b in zip(js.volumes, ts.volumes):
        assert a.shape == tuple(b.shape)
        # feature net -> aggregation -> U-Net, f32 sums in another order
        close(a, b, 1e-3, 1e-3)
    for a, b in zip(js.mask_volumes, ts.mask_volumes):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(js.match_features, ts.match_features):
        close(a, b, 1e-4, 2e-4)


def _port_scene_from(js) -> Scene:
    """The JAX scene's tensors in a port Scene, to isolate the render math."""
    return Scene(volumes=[t(v) for v in js.volumes],
                 mask_volumes=[t(m) for m in js.mask_volumes],
                 features=[t(f) for f in js.features],
                 match_features=[t(f) for f in js.match_features],
                 imgs=t(js.imgs), intrs=t(js.intrs), c2ws=t(js.c2ws))


RENDER_KEYS = ("color_fine", "render_depth", "sdf_depth", "normal",
               "gradients", "weights", "inside_sphere")


def test_render_core_same_samples(setup):
    jm, params, tm, s, js, ts = setup
    rng = np.random.RandomState(0)
    near, far = float(s["near"][0, 0]), float(s["far"][0, 0])
    z = np.sort(rng.uniform(near, far, (N_RAYS, 32)), -1).astype(np.float32)
    core = jax.jit(lambda p, ro, rd, zz, sc: jm.renderer.render_core(
        p, ro, rd, zz, 2.0 / 16, sc, 1.0, False, None, train=False))
    jout = core(params, jnp.asarray(s["rays_o"]), jnp.asarray(s["rays_d"]),
                jnp.asarray(z), js)
    with torch.no_grad():
        tout = tm.renderer.render_core(t(s["rays_o"]), t(s["rays_d"]), t(z),
                                       2.0 / 16, _port_scene_from(js), 1.0)
    for k in RENDER_KEYS:
        assert jout[k].shape == tuple(tout[k].shape), k
        close(jout[k], tout[k], 1e-3, 1e-4)


def test_build_scene_and_render_end_to_end(setup):
    jm, params, tm, s, js, ts = setup
    args = [s[k] for k in ("rays_o", "rays_d", "near", "far")]
    render = jax.jit(lambda p, ro, rd, n, f, sc: jm.renderer.render(
        p, ro, rd, n, f, sc, cos_anneal_ratio=1.0, key=None, train=False))
    jout = render(params, *[jnp.asarray(a) for a in args], js)
    with torch.no_grad():
        tout = tm.renderer.render(*[t(a) for a in args], ts)
    # the hierarchical sampler's discrete choices may flip on the small
    # scene differences; compare the rays whose weights agree in shape
    same = np.abs(np.asarray(jout["weights"])
                  - tout["weights"].numpy()).max(axis=1) < 1e-3
    print(f"render end to end: {1 - same.mean():.4f} of rays differ")
    assert same.mean() >= 0.9
    for k in ("color_fine", "render_depth", "normal"):
        close(np.asarray(jout[k])[same], tout[k].numpy()[same], 1e-3, 1e-3)


def test_extraction_sdf_matches_sdf_network(setup):
    jm, params, tm, s, js, ts = setup
    rng = np.random.RandomState(1)
    pts = t(rng.uniform(-1, 1, (300, 3)).astype(np.float32))
    with torch.no_grad():
        got = tm.renderer.sdf_fn_for_extraction(ts.volumes)(pts)
        ref = tm.sdf.sdf(pts, ts.volumes)
    close(ref, got, 1e-4, 1e-5)


def test_synthetic_val_item_matches_jax():
    from gens_tpu.data.synthetic import SyntheticDataset as JData
    from gens_torch.data.synthetic import SyntheticDataset as TData

    a = TData(1, 3, (64, 80), val_res_level=4)[0]
    b = JData(1, 3, (64, 80), val_res_level=4, mode="val")[0]
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(v))


def _write_jax_ckpt(path, params):
    with open(path, "wb") as f:
        pickle.dump({"epoch": 3, "step": 0, "format_version": 2,
                     "params": to_np_tree(params)}, f)


TINY_SET = [
    "model.feature_network.d_enc=[8,8,8,8,8]",
    "model.volume.volume_dims=[32,16,8,4,2]",
    "model.sdf_network.d_hidden=48", "model.sdf_network.n_layers=4",
    "model.sdf_network.skip_in=[2]", "model.sdf_network.d_out=17",
    "model.render.n_samples=16", "model.render.n_importance=16",
    "model.render.up_sample_steps=2",
    "val_dataset.dataset_name=synthetic", 'val_dataset.scene=["s0"]',
    "val_dataset.img_hw=[64,64]", "val_dataset.num_src_view=2",
    "val_dataset.val_res_level=4", "mesh_resolution=32",
]


def test_main_val_on_cpu(setup, tmp_path):
    from gens_torch.main import main

    ckpt = tmp_path / "tiny.ckpt"
    _write_jax_ckpt(ckpt, setup[1])
    before = counter("k3.launches")
    runner = main(["--mode", "val", "--device", "cpu", "--resume", str(ckpt),
                   "--set", f"base_exp_dir={tmp_path / 'exp'}"] + TINY_SET)
    st = runner.stats[0]
    assert st["rays"] == 16 * 16 and st["render_finite"] and st["grid_finite"]
    assert np.isfinite(runner.metrics["psnr"])
    assert runner.last_sdf_grid.shape == (32, 32, 32)
    assert counter("k3.launches") == before  # CPU: plain version
    for sub in ("meshes", "val_img", "val_normal", "val_render_depth"):
        assert os.listdir(tmp_path / "exp" / sub)


def test_main_without_cuda_raises(monkeypatch):
    from gens_torch import main as main_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_mod.main(["--mode", "val", "--resume", "unused"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_mod.main(["--mode", "train"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_mod.main(["--mode", "finetune", "--resume", "unused"])


def test_port_imports_neither_jax_nor_gens_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gens_torch\n"
        "for m in pkgutil.walk_packages(gens_torch.__path__, 'gens_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'gens_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('gens_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15
