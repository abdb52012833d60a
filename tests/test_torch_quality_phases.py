"""Phase ft of the quality protocol in the port
(gens_torch/eval/quality_finetune.py) against the JAX package on the CPU
at tiny sizes (32 px, a 32³…2³ cascade, 8+8 samples, 64 rays, a 32³
mesh), f32, from a tiny phase b run of the port:

* phase ft's first step against the script's ``ft_step``
  (scripts/quality_synthetic.py:737-748) built here from
  ``forward_finetune``, ``compute_losses`` and ``make_finetune_optimizer``
  under ``sdf_network.packed_trilerp: false`` (the plain trilerp's
  gradient, which the port computes; under true the JAX lookup passes the
  volumes little of theirs, ROADMAP §C) on the port's ``init_volumes``,
  with the JAX key's perturb noise and
  sparse points: the losses within 1e-4 relative (as
  tests/test_torch_finetune.py holds the finetune step: the smooth term's
  finite differences of the trained SDF differ by 5e-5) and the updated
  params; in a ``slow`` test, the same step's gradient in both packages
  under both values of the key: the port's against the script's under
  false, and the port's with the reference's detaches
  (tests/_reference_packed_grad.py) against the script's under true;
* ``ft_init``'s grid (K3's plain version on the CPU) against the JAX
  ``sdf_fn_for_extraction`` grid of the same volumes, and the port's
  ``quality_ft.ckpt`` and ``quality_gen.ckpt`` read by
  ``gens_tpu.train.checkpoint.load_checkpoint`` and used there.

Phase b's first step against JAX is in tests/test_torch_quality_train.py,
so the two JAX compiles run in two test files."""

import contextlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gens_tpu.losses as jl
from gens_torch.convert import finetune_params_from_jax
from gens_torch.eval import quality_finetune as qf
from gens_torch.eval import quality_train as qt
from gens_torch.eval.quality import scene_params
from gens_torch.models.gens import GenSModel as TGenSModel
from gens_torch.train.step import FinetuneStep
from gens_tpu.models.gens import GenSModel as JGenSModel
from gens_tpu.train import checkpoint as jckpt
from gens_tpu.train.step import make_finetune_optimizer as j_ft_optimizer

import _torch_common  # noqa: F401  (torch at one thread)
from _reference_packed_grad import reference_packed_grad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--hw", "32", "--dims", "32", "--samples", "8",
        "--rays", "64", "--mesh-res", "32"]
FT_LOSS_RTOL = 1e-4


def script():
    spec = importlib.util.spec_from_file_location(
        "quality_synthetic", os.path.join(REPO, "scripts",
                                          "quality_synthetic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def draws(step: int, n_rays: int, n_sparse: int):
    """The JAX key of step ``step`` and the perturb noise and sparse points
    the renderer draws from it (gens_tpu/models/renderer.py:501)."""
    key = jax.random.PRNGKey(step)
    pk, sk = jax.random.split(key)
    noise = np.array(jax.random.uniform(pk, (n_rays, 1)) - 0.5)
    sparse = np.array(jax.random.uniform(sk, (n_sparse, 3), minval=-1.0,
                                         maxval=1.0))
    return key, torch.from_numpy(noise), torch.from_numpy(sparse)


def jax_cfg(args, n_steps):
    """The script's build_cfg (without the pallas window probe)."""
    cfg = script().build_config(n_steps, dims=args.dims,
                                samples=args.samples, bf16=args.bf16,
                                agg=args.agg_packed)
    cfg.model.volume.agg_remat = args.agg_remat
    cfg.train.lr_variance_mult = args.var_lr_mult
    return cfg


def as_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def ft_setup(gen: str, packed: bool):
    """Phase ft's first step from the checkpoint ``gen`` in both packages:
    the port's configuration and model, its ``init_volumes`` and first
    batch; the script's JAX configuration (scripts/quality_synthetic.py:
    662-667) under ``sdf_network.packed_trilerp: packed``, its model and
    finetune params and statics from the same init."""
    from gens_torch.convert import load_params
    from gens_torch.data.synthetic import make_scene

    args = qt.parse_args(TINY + ["--phase", "ft", "--steps-ft", "3",
                                 "--gen-ckpt", gen])
    tcfg = qf.ft_cfg(args)
    jcfg = jax_cfg(args, args.steps_ft)
    jcfg.train.anneal_end = max(args.steps_ft // 8, 1)
    jcfg.train.warmup = 0
    jcfg.train.loss.sparse_weight = 0.0
    jcfg.train.loss.smooth_weight = 5e-4
    jcfg.train.loss.pseudo_depth_weight = 0.0
    jcfg.model.sdf_network.packed_trilerp = packed
    tm = TGenSModel(tcfg.model)
    payload = load_params(tm, gen)
    kw = scene_params(-1)
    base = make_scene(n_views=3, hw=(32, 32), n_rays=64, seed=123,
                      spread=0.5, **kw)
    with torch.no_grad():
        vols, masks, feats = tm.init_volumes(
            *[torch.from_numpy(base[k]) for k in ("imgs", "intrs", "c2ws")])
    batch = qf.ft_batches(base, kw, (32, 32), 64, torch.device("cpu"))[0]
    jm = JGenSModel(jcfg.model)
    jp = jax.tree.map(jnp.asarray, payload["params"])
    ftp = {"volumes": [jnp.asarray(v.numpy()) for v in vols],
           **{k: jp[k] for k in ("sdf", "blending", "variance")}}
    static = {"mask_volumes": [jnp.asarray(m.numpy()) for m in masks],
              "features": [jnp.asarray(f.numpy()) for f in feats]}
    jin = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jin["view_ids"] = jin["view_ids"].astype(jnp.int32)
    return dict(tcfg=tcfg, jcfg=jcfg, tm=tm, vols=vols, masks=masks,
                feats=feats, batch=batch, jm=jm, jp=jp, ftp=ftp,
                static=static, jin=jin)


def jax_ft_loss(s):
    """The script's ft loss (scripts/quality_synthetic.py:737-748) of
    ``ft_setup``'s model and statics."""
    jm, jcfg, static = s["jm"], s["jcfg"], s["static"]

    def loss_fn(p, inputs, key, anneal):
        out = jm.forward_finetune(p, static, inputs, anneal, key)
        losses = jl.compute_losses(out, inputs, jcfg.train.loss)
        mse = jnp.mean((out["color_fine"] - inputs["color"]) ** 2)
        losses["psnr"] = 20.0 * jnp.log10(1.0 / jnp.sqrt(mse + 1e-12))
        return losses["loss"], losses
    return loss_fn


@pytest.fixture(scope="module")
def ft_step(tmp_path_factory):
    """A tiny phase b run and its checkpoint, then phase ft's first step
    from it in the port and in the script's ``ft_step``; the grid of the
    port's init volumes in both packages; the port's phase ft run end to
    end, its checkpoint read by the JAX package."""
    tmp = tmp_path_factory.mktemp("ft")
    gen = str(tmp / "gen.ckpt")
    qt.main(TINY + ["--phase", "b", "--steps-b", "2", "--n-train-scenes",
                    "2", "--skip-eval", "--out", str(tmp / "b.json"),
                    "--runs-dir", str(tmp), "--ckpt-out", gen])
    # the volumes' whole gradient comes through the SDF's trilerp, where
    # the JAX packed-diff lookup passes them little of theirs (ROADMAP §C);
    # the port computes the plain trilerp's, which is JAX's under false (the
    # forward is the same function either way)
    s = ft_setup(gen, packed=False)
    tcfg, tm, batch = s["tcfg"], s["tm"], s["batch"]
    vols, masks, feats = s["vols"], s["masks"], s["feats"]
    jm, jp, ftp = s["jm"], s["jp"], s["ftp"]
    optimizer = j_ft_optimizer(s["jcfg"].train)
    loss_fn = jax_ft_loss(s)

    @jax.jit
    def j_ft_step(ftp, opt_state, inputs, key, anneal):
        grads, metrics = jax.grad(loss_fn, has_aux=True)(ftp, inputs, key,
                                                         anneal)
        updates, opt_state = optimizer.update(grads, opt_state, ftp)
        return optax.apply_updates(ftp, updates), opt_state, metrics, grads

    key, noise, sparse = draws(0, 64, 512)
    jnew, _, jmetrics, jgrads = j_ft_step(ftp, optimizer.init(ftp), s["jin"],
                                          key, 0.0)
    step = FinetuneStep(tm, tcfg, vols, masks, feats)
    metrics = step(batch, 0.0, perturb_noise=noise, sparse_pts=sparse)

    # the grid of the init volumes in both packages (ft_init's)
    j_sdf = jax.jit(lambda mlp, v, x: jm.renderer.sdf_fn_for_extraction(
        mlp, v)(x))
    from gens_torch.mesh.extract import eval_sdf_grid

    def both_grids(model, mlp, volumes):
        """The port's -sdf grid at 32³ (K3's plain version) and the JAX
        sdf_fn_for_extraction's at the same points."""
        t_grid = eval_sdf_grid(model.renderer.sdf_fn_for_extraction(
            [torch.as_tensor(np.asarray(v)) for v in volumes]),
            [-1] * 3, [1] * 3, 32, torch.device("cpu"), block=32)
        r = np.linspace(-1, 1, 32, dtype=np.float32)
        pts = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1)
        j_grid = -np.asarray(j_sdf(mlp, [jnp.asarray(v) for v in volumes],
                                   jnp.asarray(pts.reshape(-1, 3))),
                             np.float32).reshape(32, 32, 32)
        return t_grid, j_grid

    from gens_torch.convert import load_params

    tm_init = TGenSModel(tcfg.model)
    load_params(tm_init, gen)
    with torch.no_grad():
        init_grids = both_grids(tm_init, {"sdf": jp["sdf"]},
                                [v.numpy() for v in vols])

    # the port's phase ft end to end, then its checkpoint in JAX
    ft_ckpt = str(tmp / "ft.ckpt")
    res = qt.main(TINY + ["--phase", "ft", "--steps-ft", "3", "--gen-ckpt",
                          gen, "--out", str(tmp / "ft.json"), "--runs-dir",
                          str(tmp), "--ckpt-out", ft_ckpt])
    jft = jckpt.load_checkpoint(ft_ckpt)
    from gens_torch.train.checkpoint import load_finetune_checkpoint

    tm_ft = TGenSModel(tcfg.model)
    _, arrays = load_finetune_checkpoint(tm_ft, ft_ckpt)
    with torch.no_grad():
        ft_grids = both_grids(
            tm_ft, {"sdf": jax.tree.map(jnp.asarray, jft["params"]["sdf"])},
            jft["params"]["volumes"])
    return {"jmetrics": {k: float(v) for k, v in jmetrics.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "jnew": jnew, "jgrads": jgrads, "step": step, "tm": tm,
            "init_grids": init_grids, "ft_grids": ft_grids,
            "port_arrays": arrays, "jft": jft, "res": res, "gen": gen}


def test_ft_first_step_losses_match_the_scripts_ft_step(ft_step):
    jm, pm = ft_step["jmetrics"], ft_step["metrics"]
    assert jm["pseudo_sdf_loss"] > 0 and jm["pseudo_depth_loss"] == 0
    for k, v in jm.items():
        assert pm[k] == pytest.approx(v, rel=FT_LOSS_RTOL, abs=1e-7), (
            k, pm[k], v)


def test_ft_first_step_updates_match_the_scripts_ft_step(ft_step):
    """Adam's first update is lr · g / (|g| + eps): elements whose gradient
    is below 5% of their tensor's max |g| may flip its sign (as in
    tests/test_torch_finetune.py), the rest agree within 1e-6 relative."""
    s = ft_step
    def mlp_state(tree):
        tree = {**as_numpy({k: tree[k] for k in ("sdf", "blending",
                                                 "variance")}),
                "volumes": [], "mask_volumes": [], "features": []}
        return finetune_params_from_jax(tree)[0]

    jg, jn = mlp_state(s["jgrads"]), mlp_state(s["jnew"])
    params = dict(s["tm"].named_parameters())
    pairs = [(jg[n], jn[n], params[n]) for n in jn]
    pairs += [(torch.from_numpy(np.array(g)),
               torch.from_numpy(np.array(n)), v)
              for g, n, v in zip(s["jgrads"]["volumes"],
                                 s["jnew"]["volumes"], s["step"].volumes)]
    checked = 0
    for g, ref, p in pairs:
        keep = g.abs() >= 0.05 * g.abs().max()
        if not keep.any():
            continue
        torch.testing.assert_close(p.detach()[keep], ref[keep], rtol=1e-6,
                                   atol=1e-7)
        checked += int(keep.sum())
    assert checked > 1000 and len(pairs) > 20


def test_ft_init_grid_matches_the_jax_sdf_fn(ft_step):
    t_grid, j_grid = ft_step["init_grids"]
    assert t_grid.shape == j_grid.shape == (32, 32, 32)
    np.testing.assert_allclose(t_grid, j_grid, rtol=1e-4,
                               atol=1e-5 * float(np.abs(j_grid).max()))
    assert float(np.std(j_grid)) > 0.1


def test_jax_reads_the_ports_quality_ft_checkpoint(ft_step):
    """The script's layout, read by gens_tpu's load_checkpoint: the JAX
    SDF of its params and volumes is the port's grid of the same state."""
    jft = ft_step["jft"]
    assert jft["epoch"] == 0 and jft["step"] == 3
    assert set(jft["params"]) == {"sdf", "blending", "variance", "volumes",
                                  "mask_volumes", "features"}
    for k in ("volumes", "mask_volumes", "features"):
        assert len(jft["params"][k]) == 5
        for a, b in zip(jft["params"][k], ft_step["port_arrays"][k]):
            np.testing.assert_array_equal(a, b.numpy())
    t_grid, j_grid = ft_step["ft_grids"]
    np.testing.assert_allclose(t_grid, j_grid, rtol=1e-4,
                               atol=1e-5 * float(np.abs(j_grid).max()))
    assert ft_step["res"]["ft_steps_done"] == 3


def test_jax_reads_the_ports_quality_gen_checkpoint(ft_step):
    """gens_tpu's load_checkpoint with the script's target
    (scripts/quality_synthetic.py:603-608): the params have the JAX model's
    tree, shapes and dtypes, and the step trained."""
    payload = jckpt.load_checkpoint(
        ft_step["gen"], target={"epoch": 0, "step": 0, "params": None})
    assert payload["epoch"] == 0 and payload["step"] == 2
    cfg = jax_cfg(qt.parse_args(TINY), 2)
    jm = JGenSModel(cfg.model)
    ref = jax.eval_shape(lambda k: jm.init_params(
        k, n_src_views=cfg.train_dataset.num_src_view),
                         jax.random.PRNGKey(0))
    got = payload["params"]
    assert (jax.tree.structure(ref)
            == jax.tree.structure(jax.tree.map(np.asarray, got)))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        assert a.shape == b.shape and a.dtype == b.dtype



GROUPS = ("volumes", "sdf", "blending", "variance")
# ||g_port - g_jax|| / ||g_jax|| of phase ft's first step per group, f32
FT_GRAD_RTOL = 1e-3


def grad_groups(named):
    """{group: its gradients, flat, in the order of their names}."""
    out = {}
    for name in sorted(named):
        top = name.split(".")[0]
        if top in GROUPS:
            out.setdefault(top, []).append(named[name].reshape(-1))
    return {k: torch.cat(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ft_gradients(ft_step):
    """Phase ft's first-step gradient from ``ft_step``'s checkpoint: the
    script's ft loss under packed_trilerp true and false, and the port's
    step with and without the reference's detaches."""
    key, noise, sparse = draws(0, 64, 512)
    out = {}
    for packed in (True, False):
        s = ft_setup(ft_step["gen"], packed)
        g, _ = jax.jit(jax.grad(jax_ft_loss(s), has_aux=True))(
            s["ftp"], s["jin"], key, 0.0)
        g = as_numpy(g)
        named, _ = finetune_params_from_jax(
            {**{k: g[k] for k in ("sdf", "blending", "variance")},
             "volumes": [], "mask_volumes": [], "features": []})
        named.update({f"volumes.{i}": torch.from_numpy(np.array(v))
                      for i, v in enumerate(g["volumes"])})
        out["jax_packed" if packed else "jax_plain"] = grad_groups(named)
    for name, ctx in (("port", contextlib.nullcontext),
                      ("port_ref", reference_packed_grad)):
        s = ft_setup(ft_step["gen"], False)
        step = FinetuneStep(s["tm"], s["tcfg"], s["vols"], s["masks"],
                            s["feats"])
        with ctx():
            step(s["batch"], 0.0, perturb_noise=noise, sparse_pts=sparse)
        named = {n: p.grad for n, p in s["tm"].named_parameters()
                 if p.grad is not None}
        named.update({f"volumes.{i}": v.grad
                      for i, v in enumerate(step.volumes)})
        out[name] = grad_groups(named)
    return out


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.slow
def test_ft_gradient_with_the_reference_detaches_is_the_scripts_packed(
        ft_gradients):
    """The volumes' whole gradient comes through the SDF lookups: under
    packed_trilerp true the script's differs from its own under false (by
    0.44 of its norm here: the pseudo points' share is kept, the render
    core's value and ∇SDF share is dropped), the port's is the one under
    false, and the port's with the reference's detaches the one under true,
    per group."""
    g = ft_gradients
    pairs = {"plain": ("port", "jax_plain"), "packed": ("port_ref",
                                                        "jax_packed")}
    errs = {p: {k: rel(g[a][k], g[b][k]) for k in GROUPS}
            for p, (a, b) in pairs.items()}
    print("phase ft, port against the script (plain) and port with the "
          "detaches against the script under true (packed):", errs)
    print("volumes' gradient norm, script false / true:",
          float(g["jax_plain"]["volumes"].norm()),
          float(g["jax_packed"]["volumes"].norm()))
    assert rel(g["jax_packed"]["volumes"], g["jax_plain"]["volumes"]) > 0.1
    for p in pairs:
        for k in GROUPS:
            assert errs[p][k] <= FT_GRAD_RTOL, (p, k, errs[p][k])
