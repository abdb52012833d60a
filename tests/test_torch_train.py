"""The gens_torch training slice against the JAX package on the CPU at
tiny_config sizes: the training pieces one by one (third-order trilerp, the
perturbed sampler, the patch warp, LNCC, the warp feature stack, TV, the SDF
value / gradient / Hessian·1 pass, the schedule, the synthetic train
batches), one whole training step (every loss term, the gradients, the
updated parameters), the initializers, checkpoints, and
``python -m gens_torch.main --mode train`` on the CPU."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gens_tpu.losses as jl
import gens_tpu.ops.interp as ji
import gens_tpu.ops.projection as jp
import gens_tpu.ops.sampling as js
import gens_tpu.train.schedule as jsched
from gens_tpu.data.synthetic import SyntheticDataset as JData
from gens_tpu.models.renderer import make_warp_feature_stack as j_warp_stack
from gens_tpu.models.renderer import tv_regularization as j_tv
from gens_tpu.models.sdf_net import SDFNetwork as JSDF
from gens_tpu.train.step import make_train_step
from gens_torch import losses as tl
from gens_torch.convert import (load_checkpoint, load_params, params_from_jax,
                                params_to_jax, sdf_state)
from gens_torch.data.synthetic import SyntheticDataset as TData
from gens_torch.models.gens import GenSModel as TGenSModel
from gens_torch.models.renderer import make_warp_feature_stack, tv_regularization
from gens_torch.models.sdf_net import SDFNetwork as TSDF
from gens_torch.ops import interp as ti
from gens_torch.ops import projection as tp
from gens_torch.ops import sampling as ts
from gens_torch.train import schedule as tsched
from gens_torch.train.checkpoint import (load_optimizer_state,
                                         save_checkpoint)
from gens_torch.train.step import TrainStep, make_optimizer

from _torch_common import (jax_init_params, scene_numpy, t, tiny_configs,
                           tiny_models, to_np_tree)


def close(a, b, rtol, atol):
    np.testing.assert_allclose(
        np.asarray(b.detach() if torch.is_tensor(b) else b, np.float32),
        np.asarray(a, np.float32), rtol=rtol, atol=atol)


# -- the pieces ----------------------------------------------------------------


def test_trilerp_third_order_matches_jax():
    """d/d(points, volume) of a loss on Hessian·1 of a nonlinear trilerp
    wrapper: third order w.r.t. the points, as the training loss's smooth
    term differentiates it (in the style of tests/test_interp.py)."""
    rng = np.random.RandomState(0)
    vol = rng.randn(5, 5, 5, 2).astype(np.float32)
    pts = rng.uniform(-0.8, 0.8, (16, 3)).astype(np.float32)

    def j_loss(v, p):
        def g(q):
            return jax.grad(lambda r: jnp.sum(jnp.tanh(ji.trilerp(v, r))))(q)
        hess1 = jax.jvp(g, (p,), (jnp.ones_like(p),))[1]
        return jnp.sum(hess1 ** 2)

    jgv, jgp = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        jnp.asarray(vol), jnp.asarray(pts))
    v = t(vol).requires_grad_(True)
    p = t(pts).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.tanh(ti.trilerp(v, p)).sum(), p,
                               create_graph=True)
    (hess1,) = torch.autograd.grad(g, p, torch.ones_like(g),
                                   create_graph=True)
    torch.sum(hess1 ** 2).backward()
    assert float(p.grad.abs().max()) > 0
    close(jgp, p.grad, 1e-4, 1e-4)
    close(jgv, v.grad, 1e-4, 1e-4)


def test_hierarchical_sample_with_injected_perturbation():
    s = scene_numpy()
    ro, rd = s["rays_o"][:24], s["rays_d"][:24]
    noise = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (24, 1))
                       - 0.5)
    mask = np.ones((8, 8, 8), np.float32)
    # the JAX sampler draws its noise from the key; the port takes the draw
    jz = np.asarray(js.hierarchical_sample(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(s["near"]),
        jnp.asarray(s["far"]), lambda p: jnp.linalg.norm(p, axis=-1) - 0.5,
        jnp.asarray(mask), 16, 0, 2, perturb_key=jax.random.PRNGKey(5)))
    tz = ts.hierarchical_sample(
        t(ro), t(rd), t(s["near"]), t(s["far"]),
        lambda p: torch.linalg.norm(p, dim=-1) - 0.5, t(mask), 16, 0, 2,
        perturb_noise=t(noise)).numpy()
    close(jz, tz, 1e-6, 1e-6)
    # and the full sampler runs on top of the shifted samples
    tz = ts.hierarchical_sample(
        t(ro), t(rd), t(s["near"]), t(s["far"]),
        lambda p: torch.linalg.norm(p, dim=-1) - 0.5, t(mask), 16, 16, 2,
        perturb_noise=t(noise))
    assert tz.shape == (24, 32) and bool((tz[:, 1:] >= tz[:, :-1]).all())


def test_surface_patch_warp_matches_jax():
    s = scene_numpy()
    rng = np.random.RandomState(2)
    dirs = rng.randn(20, 3)
    pts = (0.5 * dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
           ).astype(np.float32)
    nrm = rng.randn(20, 3)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    imgs = rng.rand(3, 64, 64, 5).astype(np.float32)
    w = rng.randn(2, 20, 25, 5).astype(np.float32)

    def j_fn(p):
        ref, src = jp.surface_patch_warp(p, jnp.asarray(nrm),
                                         jnp.asarray(imgs),
                                         jnp.asarray(s["intrs"]),
                                         jnp.asarray(s["c2ws"]), patch_size=5)
        return jnp.sum(src * w), (ref, src)

    (jg, (jref, jsrc)) = jax.jit(jax.grad(j_fn, has_aux=True))(
        jnp.asarray(pts))
    p = t(pts).requires_grad_(True)
    ref, src = tp.surface_patch_warp(p, t(nrm), t(imgs), t(s["intrs"]),
                                     t(s["c2ws"]), patch_size=5)
    torch.sum(src * t(w)).backward()
    assert ref.shape == (20, 25, 5) and src.shape == (2, 20, 25, 5)
    close(jref, ref, 1e-5, 1e-5)
    close(jsrc, src, 1e-4, 1e-4)
    close(jg, p.grad, 1e-3, 1e-3)


def test_compute_lncc_matches_jax():
    rng = np.random.RandomState(3)
    ref = rng.rand(30, 25, 6).astype(np.float32)
    src = (ref[None] * rng.uniform(0.5, 1.5, (4, 1, 1, 1))
           + 0.3 * rng.rand(4, 30, 25, 6)).astype(np.float32)
    close(jax.jit(jl.compute_lncc)(jnp.asarray(ref), jnp.asarray(src)),
          tl.compute_lncc(t(ref), t(src)), 1e-5, 1e-6)


def test_make_warp_feature_stack_matches_jax_resize():
    # jax.image.resize bilinear against F.interpolate(align_corners=False),
    # the image edges included, at the x2 and x4 upsampling of the stack
    rng = np.random.RandomState(4)
    feats = [rng.randn(3, 24 >> i, 40 >> i, 4).astype(np.float32)
             for i in range(4)]
    ref = j_warp_stack([jnp.asarray(f) for f in feats], 3)
    got = make_warp_feature_stack([t(f) for f in feats], 3)
    assert got.shape == (3, 24, 40, 12)
    close(ref, got, 1e-6, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tv_regularization_matches_jax(dtype):
    rng = np.random.RandomState(5)
    dims = (8, 4, 2)
    vols = [rng.randn(d, d, d, 4).astype(np.float32) for d in dims]
    masks = [(rng.rand(d, d, d) > 0.3).astype(np.float32) for d in dims]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jgrad = jax.jit(jax.value_and_grad(lambda vs: j_tv(vs, [
        jnp.asarray(m) for m in masks])))
    jv, jg = jgrad([jnp.asarray(v).astype(jdt) for v in vols])
    tv = [t(v).to(tdt).requires_grad_(True) for v in vols]
    got = tv_regularization(tv, [t(m) for m in masks])
    got.backward()
    assert got.dtype == torch.float32
    rtol = 1e-5 if dtype == "float32" else 1e-2
    close(jv, got, rtol, 0)
    for a, b in zip(jg, tv):
        close(np.asarray(a, np.float32), b.grad.float(), rtol,
              rtol * float(np.abs(np.asarray(a, np.float32)).max()))


def test_sdf_value_grad_smooth_matches_jax():
    """The value, ∇SDF and Hessian·1 of the SDF net, and the gradient of a
    loss on all three w.r.t. the SDF parameters and the volumes."""
    jcfg, jm, params, tcfg, tm = tiny_models()
    rng = np.random.RandomState(6)
    dims = jcfg.model.volume.volume_dims
    vols = [(0.3 * rng.randn(d, d, d, 4)).astype(np.float32) for d in dims]
    pts = rng.uniform(-0.9, 0.9, (50, 3)).astype(np.float32)
    a = rng.randn(50, jcfg.model.sdf_network.d_out).astype(np.float32)
    b, c = rng.randn(2, 50, 3).astype(np.float32)

    def j_loss(sdf_params, vs):
        out, g, sm = jm.renderer.sdf_value_grad_smooth(
            {"sdf": sdf_params}, vs, jnp.asarray(pts))
        return (jnp.sum(out * a) + jnp.sum(g * b) + jnp.sum(sm * c),
                (out, g, sm))

    (jgp, jgv), (jout, jg, jsm) = jax.jit(jax.grad(
        j_loss, argnums=(0, 1), has_aux=True))(
        params["sdf"], [jnp.asarray(v) for v in vols])
    tv = [t(v).requires_grad_(True) for v in vols]
    out, g, sm = tm.renderer.sdf_value_grad_smooth(tv, t(pts))
    (torch.sum(out * t(a)) + torch.sum(g * t(b))
     + torch.sum(sm * t(c))).backward()
    close(jout, out, 1e-4, 1e-5)
    close(jg, g, 1e-4, 1e-4)
    close(jsm, sm, 1e-3, 1e-3)
    ref = sdf_state(to_np_tree(jgp))
    for name, p in tm.sdf.named_parameters():
        r = ref["sdf." + name]
        close(r, p.grad, 1e-3, 1e-4 * float(r.abs().max()))
    for r, v in zip(jgv, tv):
        close(r, v.grad, 1e-3, 1e-4 * float(np.abs(np.asarray(r)).max()))


def test_schedule_matches_jax_and_counts_from_zero():
    for prog in (0.0, 0.25, 0.999, 1.0, 3.7, 10.0):
        close(jsched.warmup_cosine_factor(prog, 10, 1.0, 0.02),
              tsched.warmup_cosine_factor(prog, 10, 1.0, 0.02), 1e-6, 0)
        assert (jsched.cos_anneal_ratio(prog, 2.0)
                == tsched.cos_anneal_ratio(prog, 2.0))
    # optax's count: the first update uses the factor at step 0
    _, tcfg = tiny_configs()
    model = TGenSModel(tcfg.model)
    opt, sched = make_optimizer(model, tcfg.train, steps_per_epoch=4)
    lrs = {g["name"]: g["lr"] for g in opt.param_groups}
    assert lrs["mlp"] == pytest.approx(0.1 * tcfg.train.lr_mlp)
    assert lrs["feat"] == pytest.approx(0.1 * tcfg.train.lr_feat)
    opt.step()
    sched.step()
    f1 = tsched.warmup_cosine_factor(0.25, tcfg.train.epochs,
                                     tcfg.train.warmup, tcfg.train.alpha)
    assert opt.param_groups[0]["lr"] == pytest.approx(
        f1 * tcfg.train.lr_mlp)
    assert not any(p is q for g in opt.param_groups for p in g["params"]
                   for q in model.match_feature.parameters())


def test_synthetic_train_batches_match_jax():
    a = TData(2, 3, (32, 40), n_rays=16, n_pseudo_pts=8, mode="train")
    b = JData(2, 3, (32, 40), n_rays=16, n_pseudo_pts=8, mode="train")
    for idx in (0, 1, 0):
        x, y = a[idx], b[idx]
        assert sorted(x) == sorted(y)
        for k, v in y.items():
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(v))


# -- one whole training step ---------------------------------------------------


@pytest.fixture(scope="module")
def one_step():
    """The port's step and the JAX step on the same params, batch and
    draws: packed_bilerp "pallas" with splat_mm_dtype float32 (on the CPU
    the JAX backward is the exact adjoint), no perturbation, the sparse
    points drawn from the JAX key and passed in. The JAX update is
    make_train_step's optimizer applied to jax.grad of its loss
    (forward_train + compute_losses): one compile instead of two."""
    jcfg, tcfg = tiny_configs()
    for c in (jcfg, tcfg):
        c.model.volume.packed_bilerp = "pallas"
        c.model.volume.splat_window = 48
        c.model.volume.splat_mm_dtype = "float32"
        c.model.render.perturb = 0.0
    from gens_tpu.models.gens import GenSModel as JGenSModel

    jm = JGenSModel(jcfg.model)
    params = jax_init_params(0)
    tm = TGenSModel(tcfg.model)
    tm.load_state_dict(params_from_jax(to_np_tree(params)), strict=True)
    item = JData(1, 3, (64, 64), n_rays=32, n_pseudo_pts=64,
                 mode="train")[0]
    item = {k: v for k, v in item.items()
            if isinstance(v, np.ndarray) and v.dtype == np.float32}
    ji_ = {k: jnp.asarray(v) for k, v in item.items()}
    key, anneal = jax.random.PRNGKey(3), 0.25
    sparse = jax.random.uniform(jax.random.split(key)[1],
                                (jcfg.model.render.n_sparse_pts, 3),
                                minval=-1.0, maxval=1.0)

    def loss_fn(p):
        out = jm.forward_train(p, ji_, anneal, False, key)
        losses = jl.compute_losses(out, ji_, jcfg.train.loss)
        return losses["loss"], losses

    grads, jlosses = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    optimizer, _ = make_train_step(jm, jcfg, steps_per_epoch=1)

    @jax.jit
    def update(g, p):
        return optax.apply_updates(
            p, optimizer.update(g, optimizer.init(p), p)[0])

    new_params = update(grads, params)

    # the model facade's forward_train, before the step updates tm (with
    # autograd on: the render differentiates the SDF w.r.t. its points)
    fwd = tl.compute_losses(
        tm.forward_train({k: t(v) for k, v in item.items()}, anneal, False,
                         sparse_pts=t(np.asarray(sparse))),
        {k: t(v) for k, v in item.items()}, tcfg.train.loss)
    fwd = {k: v.detach() for k, v in fwd.items()}
    step = TrainStep(tm, tcfg, steps_per_epoch=1)
    metrics = step({k: t(v) for k, v in item.items()}, anneal, False,
                   sparse_pts=t(np.asarray(sparse)))
    return {"jlosses": jlosses, "metrics": metrics, "fwd_losses": fwd,
            "jgrads": params_from_jax(to_np_tree(grads)),
            "jparams": params_from_jax(to_np_tree(new_params)), "tm": tm}


def test_train_step_losses_match_jax(one_step):
    jlosses, metrics = one_step["jlosses"], one_step["metrics"]
    assert set(jlosses) <= set(metrics)
    for k, v in jlosses.items():
        # f32 both sides; the terms agree to ~1e-6 relative
        close(v, metrics[k], 1e-4, 1e-7)
        close(v, one_step["fwd_losses"][k], 1e-4, 1e-7)
    assert float(metrics["mfc_loss"]) >= 0 and float(metrics["loss"]) > 0


# per module: ||g_port - g_jax|| / ||g_jax||. The U-Net's InstanceNorm over
# the 1-4 voxel coarse volumes of tiny_config is ill-conditioned (var ~ 0
# under rsqrt(var + 1e-5)), so the reg net's gradients carry ~1% f32 noise
GRAD_TOL = {"sdf": 1e-3, "blending": 1e-3, "variance": 1e-3,
            "feature": 2e-2, "reg": 5e-2}


def test_train_step_grads_match_jax(one_step):
    tm, jg = one_step["tm"], one_step["jgrads"]
    groups = {}
    for name, p in tm.named_parameters():
        top = name.split(".")[0]
        if top == "match_feature":
            assert p.grad is None
            continue
        assert p.grad is not None, name
        a, b = groups.setdefault(top, ([], []))
        a.append(jg[name].reshape(-1))
        b.append(p.grad.reshape(-1))
    assert set(groups) == set(GRAD_TOL)
    for top, (a, b) in groups.items():
        a, b = torch.cat(a), torch.cat(b)
        err = float((a - b).norm() / a.norm())
        assert err <= GRAD_TOL[top], (top, err)


def test_train_step_updated_params_match_jax(one_step):
    """Adam's first update is lr·g/(|g| + eps), about lr·sign(g): an element
    whose gradient is near zero may flip sign between two f32 evaluations
    and move by 2·lr. Elements with |g| below 5% of their tensor's max |g|
    are left out; the rest must land on the JAX update."""
    tm, jg, jp = one_step["tm"], one_step["jgrads"], one_step["jparams"]
    checked = 0
    for name, p in tm.named_parameters():
        if name.startswith("match_feature"):
            torch.testing.assert_close(p.detach(), jp[name])
            continue
        g = jg[name]
        keep = g.abs() >= 0.05 * g.abs().max()
        checked += int(keep.sum())
        close(jp[name][keep], p.detach()[keep], 1e-5, 2e-6)
    assert checked > 1000


# -- initialization, checkpoints, the entry point --------------------------------


def _fit_sphere(sdf, pts):
    r = np.linalg.norm(pts, axis=-1)
    slope, icpt = np.linalg.lstsq(np.stack([r, np.ones_like(r)], -1), sdf,
                                  rcond=None)[0]
    return slope, icpt, np.corrcoef(sdf, r)[0, 1]


def test_sdf_geometric_init_is_a_sphere():
    """At init the SDF is radial, ≈ a·‖x‖ − bias, and blind to the volumes
    (their feature columns are zero), for the port's init as for JAX's.
    At the default width: tiny_config's 17 outputs are fewer than the
    feature width, and the init's feature-tail zeroing then clears the
    sphere bias too (in both packages)."""
    jcfg, tcfg = tiny_configs()
    jc, tc = jcfg.model.sdf_network, tcfg.model.sdf_network
    for c in (jc, tc):
        c.d_hidden, c.n_layers, c.skip_in, c.d_out = 128, 6, (3,), 129
    rng = np.random.RandomState(7)
    pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    vols = [[rng.randn(8, 8, 8, 4).astype(np.float32) for _ in range(5)]
            for _ in range(2)]
    torch.manual_seed(0)
    net = TSDF(tc)
    with torch.no_grad():
        sdfs = [net.sdf(t(pts), [t(v) for v in vs]).numpy() for vs in vols]
    np.testing.assert_array_equal(sdfs[0], sdfs[1])
    jnet = JSDF(jc)
    jvols = [jnp.asarray(v) for v in vols[0]]
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.asarray(pts[:2]), jvols)
    jsdf = np.asarray(jax.jit(lambda p: jnet.apply(
        p, jnp.asarray(pts), jvols, method=JSDF.sdf))(jparams))
    for sdf in (sdfs[0], jsdf):
        slope, icpt, corr = _fit_sphere(sdf, pts)
        assert abs(icpt + tc.bias) < 0.1 and slope > 0.3 and corr > 0.7


def test_init_matches_jax_families():
    """The port's fresh weights come from the JAX initializers' families:
    per tensor, the spread of the draws matches JAX's."""
    jcfg, jm, params, tcfg, _ = tiny_models()
    torch.manual_seed(1)
    ref = params_from_jax(to_np_tree(params))
    compared = 0
    for name, p in TGenSModel(tcfg.model).state_dict().items():
        r = ref[name]
        assert p.shape == r.shape, name
        if r.numel() < 500 or float(r.std()) == 0:
            continue
        compared += 1
        assert abs(float(p.std()) / float(r.std()) - 1) < 0.25, name
    assert compared > 20


def test_checkpoint_round_trip(tmp_path):
    jcfg, jm, params, tcfg, tm = tiny_models()
    item = TData(1, 3, (64, 64), n_rays=16, n_pseudo_pts=16,
                 mode="train")[0]
    step = TrainStep(tm, tcfg, steps_per_epoch=1)
    step({k: t(v) for k, v in item.items()
          if isinstance(v, np.ndarray) and v.dtype == np.float32}, 1.0)
    path = str(tmp_path / "ckpt" / "model_000.ckpt")
    save_checkpoint(path, 0, 1, tm, step.optimizer)
    payload = load_checkpoint(path)
    assert payload["epoch"] == 0 and payload["step"] == 1
    assert payload["format_version"] == 2
    fresh = TGenSModel(tcfg.model)
    load_params(fresh, path)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    # the optimizer state is numpy: the file unpickles without torch
    leaves = [v for st in payload["opt_state"]["state"].values()
              for v in st.values()]
    assert leaves and all(isinstance(v, np.ndarray) for v in leaves)
    opt = TrainStep(fresh, tcfg, 1).optimizer
    assert load_optimizer_state(opt, fresh, payload["opt_state"]) == "numpy"
    a, b = opt.state_dict()["state"], step.optimizer.state_dict()["state"]
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k]["exp_avg"], b[k]["exp_avg"])
    # the params are the JAX layout: the JAX SDF net reads them as they are
    jt = to_np_tree(params)
    assert (jax.tree_util.tree_structure(payload["params"])
            == jax.tree_util.tree_structure(jt))
    rng = np.random.RandomState(8)
    pts = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    vols = [rng.randn(d, d, d, 4).astype(np.float32)
            for d in jcfg.model.volume.volume_dims]
    jsdf = jm.sdf_net.apply(payload["params"]["sdf"], jnp.asarray(pts),
                            [jnp.asarray(v) for v in vols], method=JSDF.sdf)
    with torch.no_grad():
        tsdf = tm.sdf.sdf(t(pts), [t(v) for v in vols])
    close(jsdf, tsdf, 1e-4, 1e-5)
    # and a JAX tree survives the reverse trip unchanged
    back = params_to_jax(params_from_jax(jt))
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_flatten_with_path(jt)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert ka == kb
        np.testing.assert_array_equal(a, b)


TINY_TRAIN = [
    "model.feature_network.d_enc=[8,8,8,8,8]",
    "model.volume.volume_dims=[32,16,8,4,2]",
    "model.volume.packed_bilerp=pallas",
    "model.sdf_network.d_hidden=48", "model.sdf_network.n_layers=4",
    "model.sdf_network.skip_in=[2]", "model.sdf_network.d_out=17",
    "model.render.n_samples=16", "model.render.n_importance=16",
    "model.render.up_sample_steps=2", "model.render.patch_size=5",
    "model.render.n_sparse_pts=64",
    "train_dataset.dataset_name=synthetic", 'train_dataset.scene=["s0"]',
    "train_dataset.img_hw=[64,64]", "train_dataset.num_src_view=2",
    "train_dataset.n_rays=32", "train.val_freq=100",
]


def test_main_train_on_cpu_then_resume_and_val(tmp_path):
    from gens_torch.main import main
    from gens_torch.ops import splat as k1

    exp = f"base_exp_dir={tmp_path / 'exp'}"
    before = k1.splat_bilinear.launches
    runner = main(["--mode", "train", "--device", "cpu", "--set", exp,
                   "train.epochs=1"] + TINY_TRAIN)
    assert k1.splat_bilinear.launches == before  # CPU: the plain version
    (st,) = runner.train_stats
    assert st["step"] == 1 and np.isfinite(st["loss"])
    ckpt = tmp_path / "exp" / "checkpoints" / "model_000.ckpt"
    assert ckpt.exists()
    # resume: epoch 1 continues the step count and the schedule
    runner = main(["--mode", "train", "--device", "cpu", "--resume",
                   str(ckpt), "--set", exp, "train.epochs=2"] + TINY_TRAIN)
    (st,) = runner.train_stats
    assert st["epoch"] == 1 and st["step"] == 2
    tc = runner.cfg.train
    f2 = tsched.warmup_cosine_factor(2.0, tc.epochs, tc.warmup, tc.alpha)
    lrs = {g["name"]: g["lr"] for g in runner.step_fn.optimizer.param_groups}
    assert lrs["mlp"] == pytest.approx(f2 * tc.lr_mlp)
    with open(tmp_path / "exp" / "checkpoints" / "model_001.ckpt", "rb") as f:
        assert pickle.load(f)["step"] == 2
    # the val path reads the port's checkpoint
    runner = main(["--mode", "val", "--device", "cpu", "--resume",
                   str(tmp_path / "exp" / "checkpoints" / "model_001.ckpt"),
                   "--set", exp, "mesh_resolution=32",
                   "val_dataset.dataset_name=synthetic",
                   'val_dataset.scene=["s0"]', "val_dataset.img_hw=[64,64]",
                   "val_dataset.num_src_view=2"] + TINY_TRAIN)
    assert np.isfinite(runner.metrics["psnr"])
    assert os.listdir(tmp_path / "exp" / "meshes")
