"""The gens_torch finetune slice against the JAX package on the CPU at
tiny_config sizes: ``init_volumes`` (the "table" gather and the K2 forward
of ``splat_impl`` "kernel2f"), one whole finetune step (losses, gradients,
updated parameters) against ``forward_finetune`` + ``compute_losses`` +
``make_finetune_optimizer``, the learning-rate schedule against optax,
``filter_volume``, the synthetic finetune protocol, the finetune
checkpoint in both directions, and ``python -m gens_torch.main --mode
finetune`` on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gens_tpu.losses as jl
from gens_tpu.data.synthetic import SyntheticDataset as JData
from gens_tpu.train import checkpoint as jckpt
from gens_tpu.train.step import make_finetune_optimizer as j_ft_optimizer
from gens_torch.convert import finetune_params_from_jax, params_from_jax
from gens_torch.data.synthetic import SyntheticDataset as TData
from gens_torch.models.gens import GenSModel as TGenSModel
from gens_torch.train.checkpoint import (load_finetune_checkpoint,
                                         save_finetune_checkpoint)
from gens_torch.train.step import FinetuneStep, make_finetune_optimizer
from gens_torch.utils.profiling import counter

from _torch_common import jax_init_params, t, tiny_configs, to_np_tree

HW, N_RAYS = (64, 64), 32


def close(a, b, rtol, atol):
    np.testing.assert_allclose(
        np.asarray(b.detach() if torch.is_tensor(b) else b, np.float32),
        np.asarray(a, np.float32), rtol=rtol, atol=atol)


def _models(impl):
    """JAX model + params and the port model on the same params, with
    ``packed_bilerp`` "table" (impl None) or "pallas" + ``impl`` in f32
    operands (K2's forward is then the exact bilerp), perturbation off."""
    from gens_tpu.models.gens import GenSModel as JGenSModel

    jcfg, tcfg = tiny_configs()
    for c in (jcfg, tcfg):
        c.model.render.perturb = 0.0
        if impl is not None:
            c.model.volume.packed_bilerp = "pallas"
            c.model.volume.splat_window = (4096, 4096)
            c.model.volume.splat_impl = impl
            c.model.volume.splat_mm_dtype = "float32"
    jm = JGenSModel(jcfg.model)
    params = jax_init_params(0)
    tm = TGenSModel(tcfg.model)
    tm.load_state_dict(params_from_jax(to_np_tree(params)), strict=True)
    return jcfg, jm, params, tcfg, tm


def _jax_init_volumes(jm, params, imgs):
    import functools

    import gens_tpu.ops.pallas_splat as ps
    from unittest import mock

    with mock.patch.object(ps, "bilerp_window_fwd", functools.partial(
            ps.bilerp_window_fwd, interpret=True)):
        out = jax.jit(jm.init_volumes)(params, *[jnp.asarray(imgs[k]) for k in
                                                 ("imgs", "intrs", "c2ws")])
    return [[np.asarray(a, np.float32) for a in part] for part in out]


@pytest.fixture(scope="module")
def ft():
    """Both packages' init_volumes under "table" and under "kernel2f", and
    one finetune step from the JAX "table" state on the port's batch of
    view 1 (the DTU view order), with the sparse points of the JAX key."""
    images = TData(1, 3, HW, mode="finetune").get_all_images()
    out = {}
    for impl in (None, "kernel2f"):
        jcfg, jm, params, tcfg, tm = _models(impl)
        before = counter("k2.launches")
        with torch.no_grad():
            port = tm.init_volumes(*[t(images[k]) for k in
                                     ("imgs", "intrs", "c2ws")])
        assert counter("k2.launches") == before  # CPU: plain K2
        out[impl] = (_jax_init_volumes(jm, params, images),
                     [[p.numpy() for p in part] for part in port])

    jcfg, jm, params, tcfg, tm = _models(None)
    (vols, masks, feats), _ = out[None]
    raw = TData(1, 3, HW, n_rays=N_RAYS, mode="finetune").get_random_rays(1)
    batch = {k: v for k, v in raw.items()
             if isinstance(v, np.ndarray) and v.dtype == np.float32}
    jin = {k: jnp.asarray(v) for k, v in batch.items()}
    jin["view_ids"] = jnp.asarray(raw["view_ids"], jnp.int32)
    key, anneal = jax.random.PRNGKey(4), 0.5
    sparse = jax.random.uniform(jax.random.split(key)[1],
                                (jcfg.model.render.n_sparse_pts, 3),
                                minval=-1.0, maxval=1.0)
    static = {"mask_volumes": [jnp.asarray(m) for m in masks],
              "features": [jnp.asarray(f) for f in feats]}
    ft_params = {"volumes": [jnp.asarray(v) for v in vols],
                 **{k: params[k] for k in ("sdf", "blending", "variance")}}

    def loss_fn(p):
        o = jm.forward_finetune(p, static, jin, anneal, key)
        losses = jl.compute_losses(o, jin, jcfg.train.loss)
        return losses["loss"], losses

    grads, jlosses = jax.jit(jax.grad(loss_fn, has_aux=True))(ft_params)
    opt = j_ft_optimizer(jcfg.train)

    @jax.jit
    def update(g, p):
        return optax.apply_updates(p, opt.update(g, opt.init(p), p)[0])

    new = update(grads, ft_params)

    step = FinetuneStep(tm, tcfg, [t(v) for v in vols],
                        [t(m) for m in masks], [t(f) for f in feats])
    tin = {k: t(v) for k, v in batch.items()}
    tin["view_ids"] = t(raw["view_ids"])
    metrics = step(tin, anneal, sparse_pts=t(np.asarray(sparse)))

    def split(tree):
        tree = {**to_np_tree(tree), "mask_volumes": [], "features": []}
        return finetune_params_from_jax(tree)

    out["step"] = {"jlosses": jlosses, "metrics": metrics, "step": step,
                   "tm": tm, "jgrads": split(grads), "jnew": split(new)}
    return out


@pytest.mark.parametrize("impl", [None, "kernel2f"])
def test_init_volumes_matches_jax(ft, impl):
    """f32 both sides; the feature net's and the U-Net's convolutions sum
    in another order, so each tensor is held to 1e-4 of its own scale (the
    errors are 1e-5 to 8e-5 of max |value|)."""
    ref, got = ft[impl]
    for name, a, b in zip(("volumes", "masks", "features"), ref, got):
        assert len(a) == len(b) == 5, name
        for x, y in zip(a, b):
            assert x.shape == y.shape, name
            if name == "masks":
                np.testing.assert_array_equal(y, x)
            else:
                close(x, y, 1e-4, 1e-4 * float(np.abs(x).max()))


def test_finetune_step_losses_match_jax(ft):
    jlosses, metrics = ft["step"]["jlosses"], ft["step"]["metrics"]
    assert set(jlosses) <= set(metrics)
    for k, v in jlosses.items():
        close(v, metrics[k], 1e-4, 1e-7)
    assert float(metrics["loss"]) > 0 and np.isfinite(float(metrics["psnr"]))


# ||g_port - g_jax|| / ||g_jax|| per module, as in test_torch_train.py
GRAD_TOL = {"sdf": 1e-3, "blending": 1e-3, "variance": 1e-3, "volumes": 1e-3}


def test_finetune_step_grads_match_jax(ft):
    s = ft["step"]
    jstate, jarrays = s["jgrads"]
    step, tm = s["step"], s["tm"]
    errs = {}
    for top in ("sdf", "blending", "variance"):
        names = [n for n in jstate if n.split(".")[0] == top]
        a = torch.cat([jstate[n].reshape(-1) for n in names])
        b = torch.cat([dict(tm.named_parameters())[n].grad.reshape(-1)
                       for n in names])
        errs[top] = float((a - b).norm() / a.norm())
    a = torch.cat([g.reshape(-1) for g in jarrays["volumes"]])
    b = torch.cat([v.grad.reshape(-1) for v in step.volumes])
    errs["volumes"] = float((a - b).norm() / a.norm())
    for k, e in errs.items():
        assert e <= GRAD_TOL[k], (k, e)
    # the frozen modules take no gradient
    for name, p in tm.named_parameters():
        if name.split(".")[0] in ("feature", "match_feature", "reg"):
            assert p.grad is None, name


def test_finetune_step_updated_params_match_jax(ft):
    """As in test_torch_train.py: elements whose gradient is below 5% of
    their tensor's max |g| may flip the sign of Adam's first update."""
    s = ft["step"]
    (jg_state, jg_arrays), (jn_state, jn_arrays) = s["jgrads"], s["jnew"]
    params = dict(s["tm"].named_parameters())
    pairs = [(jg_state[n], jn_state[n], params[n]) for n in jg_state]
    pairs += list(zip(jg_arrays["volumes"], jn_arrays["volumes"],
                      s["step"].volumes))
    checked = 0
    for g, ref, p in pairs:
        keep = g.abs() >= 0.05 * g.abs().max()
        checked += int(keep.sum())
        close(ref[keep], p.detach()[keep], 1e-5, 2e-6)
    assert checked > 1000


def test_finetune_schedule_matches_optax():
    """Each group's learning rate at steps 0, 1, the middle and the last
    against the JAX schedule at optax's int32 count, which optax evaluates
    in f32 (the port in f64): within 1e-7 relative, or 2^-22 of the base
    rate where the cosine's f32 rounding is larger than that. And the k-th
    Adam update of optax under a constant unit gradient (bias-corrected
    moments of 1, up to 1e-4 of Adam's own f32 rounding) has that size."""
    from gens_tpu.train.schedule import warmup_cosine_factor as j_factor

    jcfg, tcfg = tiny_configs()
    for c in (jcfg, tcfg):
        c.train.epochs, c.train.warmup, c.train.alpha = 20, 2.0, 0.02
    n = len(tcfg.train.lr_vol)
    tree = {"volumes": [jnp.zeros(()) for _ in range(n)],
            "sdf": jnp.zeros(()), "blending": jnp.zeros(()),
            "variance": jnp.zeros(())}
    opt = j_ft_optimizer(jcfg.train)
    state = opt.init(tree)
    ones = jax.tree.map(jnp.ones_like, tree)
    update = jax.jit(opt.update)
    model = TGenSModel(tcfg.model)
    vols = [torch.zeros((), requires_grad=True) for _ in range(n)]
    topt, sched = make_finetune_optimizer(model, vols, tcfg.train)
    names = [g["name"] for g in topt.param_groups]
    assert names == ["mlp"] + [f"vol{i}" for i in range(n)]
    assert len(topt.param_groups[0]["params"]) == sum(
        1 for top in ("sdf", "blending", "variance")
        for _ in getattr(model, top).parameters())
    checked = 0
    for step in range(20):
        upd, state = update(ones, state, tree)
        if step in (0, 1, 10, 19):
            tc = jcfg.train
            f = float(j_factor(jnp.int32(step), tc.epochs, tc.warmup,
                               tc.alpha))
            base = {"mlp": tc.lr_mlp,
                    **{f"vol{i}": lr for i, lr in enumerate(tc.lr_vol)}}
            adam = {"mlp": -float(upd["sdf"]),
                    **{f"vol{i}": -float(u)
                       for i, u in enumerate(upd["volumes"])}}
            assert -float(upd["variance"]) == adam["mlp"]  # no multiplier
            for g in topt.param_groups:
                b = base[g["name"]]
                assert g["lr"] == pytest.approx(b * f, rel=1e-7,
                                                abs=b * 2.0 ** -22)
                assert g["lr"] == pytest.approx(adam[g["name"]], rel=1e-4)
                checked += 1
        topt.step()
        sched.step()
    assert checked == 4 * (n + 1)


def test_filter_volume_matches_jax(ft):
    jcfg, jm, params, tcfg, tm = _models(None)
    (vols, masks, _), _ = ft[None]
    with torch.no_grad():
        sdf = tm.sdf.sdf(torch.rand((4096, 3)) * 2 - 1,
                         [t(v) for v in vols]).abs()
    thresh = float(sdf.median())  # a band that cuts the grid
    ref = jax.jit(lambda p, v, m: jm.filter_volume(p, v, m, thresh))(
        params, [jnp.asarray(v) for v in vols],
        [jnp.asarray(m) for m in masks])
    got = tm.filter_volume([t(v) for v in vols], [t(m) for m in masks],
                           thresh)
    # voxels whose |sdf| lies within 1e-5 of the threshold may fall on
    # either side; the one-voxel dilation spreads them to their neighbours
    from gens_torch.models.volume import voxel_grid
    import torch.nn.functional as F

    dim = masks[0].shape[0]
    with torch.no_grad():
        s = tm.sdf.sdf(voxel_grid(dim), [t(v) for v in vols]).abs()
    near = ((s - thresh).abs() < 1e-5).float().reshape(1, 1, dim, dim, dim)
    near = F.max_pool3d(near, 3, 1, 1)[0, 0]
    for a, b in zip(ref, got):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        ok = near.numpy() == 0
        np.testing.assert_array_equal(b.numpy()[ok], a[ok])
        near = near[::2, ::2, ::2]
    assert 0 < float(np.asarray(ref[0]).sum()) < float(masks[0].sum())


def test_synthetic_finetune_protocol():
    """vid = 0 equals the JAX batch array for array; vid != 0 equals it in
    the view order [vid, the others] with the rays and colours of view vid
    (the JAX fixture keeps those on view 0)."""
    kw = dict(n_scenes=1, n_views=3, hw=(32, 40), n_rays=16)
    a, b = TData(mode="finetune", **kw), JData(mode="finetune", **kw)
    assert a.num_views == b.num_views == 3
    x, y = a.get_all_images(), b.get_all_images()
    for k in y:
        np.testing.assert_array_equal(x[k], y[k])
    for vid in (0, 2, 1):
        state = b.rng.get_state()
        x, y = a.get_random_rays(vid), b.get_random_rays(vid)
        assert sorted(x) == sorted(y)
        np.testing.assert_array_equal(x["view_ids"], y["view_ids"])
        order = list(y["view_ids"])
        if vid == 0:
            for k in y:
                np.testing.assert_array_equal(x[k], y[k])
            continue
        for k in ("imgs", "intrs", "c2ws", "view_masks"):
            np.testing.assert_array_equal(x[k], y[k][order])
        rng = np.random.RandomState(0)
        rng.set_state(state)
        H, W = kw["hw"]
        px = rng.randint(0, W, size=16).astype(np.float32)
        py = rng.randint(0, H, size=16).astype(np.float32)
        intr, c2w = y["intrs"][vid], y["c2ws"][vid]
        d = np.stack([px, py, np.ones_like(px)], -1) @ np.linalg.inv(intr).T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        np.testing.assert_array_equal(x["rays_d"], (d @ c2w[:3, :3].T)
                                      .astype(np.float32))
        np.testing.assert_array_equal(x["rays_o"][0], c2w[:3, 3])
        np.testing.assert_array_equal(
            x["color"], y["imgs"][vid][py.astype(int), px.astype(int)])
    x, y = a.get_rays_at(0), b.get_rays_at(0)
    assert sorted(x) == sorted(y)
    for k in y:
        np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))
    x = a.get_rays_at(2)
    np.testing.assert_array_equal(x["imgs"], y["imgs"][[2, 0, 1]])
    assert list(x["view_ids"]) == [2, 0, 1]


def test_finetune_checkpoint_both_ways(ft, tmp_path):
    s = ft["step"]
    step, tm = s["step"], s["tm"]
    path = str(tmp_path / "port" / "model_000.ckpt")
    save_finetune_checkpoint(path, 7, tm, step.volumes, step.mask_volumes,
                             step.features)
    # the JAX loader reads the port's checkpoint, in the JAX runner's layout
    jp = jckpt.load_checkpoint(path)
    assert jp["epoch"] == 7
    p = jp["params"]
    assert set(p) == {"volumes", "mask_volumes", "features", "sdf",
                      "blending", "variance"}
    for k, src in (("volumes", step.volumes),
                   ("mask_volumes", step.mask_volumes),
                   ("features", step.features)):
        for a, b in zip(p[k], src):
            np.testing.assert_array_equal(a, b.detach().numpy())
    fresh = TGenSModel(tiny_configs()[1].model)
    _, arrays = load_finetune_checkpoint(fresh, path)
    for k in ("sdf", "blending", "variance"):
        for a, b in zip(getattr(fresh, k).parameters(),
                        getattr(tm, k).parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(arrays["volumes"], step.volumes):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
    # and a checkpoint the JAX package wrote loads into the port
    jpath = str(tmp_path / "jax" / "model_001.ckpt")
    jckpt.save_checkpoint(jpath, {"epoch": 1, "params": p}, use_orbax=False)
    _, arrays = load_finetune_checkpoint(fresh, jpath)
    for k in ("volumes", "mask_volumes", "features"):
        for a, b in zip(arrays[k], p[k]):
            np.testing.assert_array_equal(a.numpy(), b)


TINY_FT = [
    "model.feature_network.d_enc=[8,8,8,8,8]",
    "model.volume.volume_dims=[32,16,8,4,2]",
    "model.volume.packed_bilerp=pallas", "model.volume.splat_impl=kernel2f",
    "model.sdf_network.d_hidden=48", "model.sdf_network.n_layers=4",
    "model.sdf_network.skip_in=[2]", "model.sdf_network.d_out=17",
    "model.render.n_samples=16", "model.render.n_importance=16",
    "model.render.up_sample_steps=2", "model.render.patch_size=5",
    "model.render.n_sparse_pts=64",
    "finetune_dataset.dataset_name=synthetic",
    "finetune_dataset.num_src_view=2", "finetune_dataset.img_hw=[64,64]",
    "finetune_dataset.n_rays=32", "finetune_dataset.val_res_level=4",
    "mesh_resolution=32", "train.save_freq=100", "train.val_freq=100",
]


def test_main_finetune_on_cpu_then_resume(ft, tmp_path):
    import pickle

    from gens_torch.main import main

    _, _, params, _, _ = _models(None)
    ckpt = tmp_path / "gen.ckpt"
    with open(ckpt, "wb") as f:
        pickle.dump({"epoch": 3, "step": 0, "format_version": 2,
                     "params": to_np_tree(params)}, f)
    exp = f"base_exp_dir={tmp_path / 'exp'}"
    before = (counter("k2.launches"), counter("k3.launches"))
    runner = main(["--mode", "finetune", "--device", "cpu", "--resume",
                   str(ckpt), "--scene", "s0", "--ref_view", "4", "--set",
                   exp, "train.epochs=3"] + TINY_FT)
    assert (counter("k2.launches"),
            counter("k3.launches")) == before  # CPU: plain versions
    steps = [st for st in runner.finetune_stats if "loss" in st]
    assert [st["step"] for st in steps] == [0, 1, 2]
    assert sorted(st["vid"] for st in steps) == [0, 1, 2]
    assert all(np.isfinite(st["loss"]) for st in steps)
    (val,) = [st for st in runner.finetune_stats if "val_step" in st]
    assert val["rays"] == 16 * 16 and val["render_finite"]
    assert runner.init_volumes_s is not None
    d = tmp_path / "exp" / "s0" / "view4"
    ft_ckpt = d / "checkpoints" / "model_002.ckpt"
    assert ft_ckpt.exists()
    for sub in ("meshes", "val_img", "val_normal"):
        assert os.listdir(d / sub)
    saved = [v.detach().clone() for v in runner.ft_step.volumes]
    # resume from the finetune checkpoint with every rate at 0: the step
    # leaves the restored volumes as they were saved
    runner = main(["--mode", "finetune", "--device", "cpu", "--resume",
                   str(ft_ckpt), "--scene", "s0", "--ref_view", "4", "--set",
                   exp, "train.epochs=1", "train.lr_mlp=0",
                   "train.lr_vol=[0,0,0,0,0]"] + TINY_FT)
    assert runner.init_volumes_s is None
    for a, b in zip(runner.ft_step.volumes, saved):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
