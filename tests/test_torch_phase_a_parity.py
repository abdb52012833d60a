"""Phase a's training step in both packages at the script's widths (128
px, 5 views, 512 rays, a 64³…4³ cascade, 32+32 samples, f32), on the CPU:
the same init (the port's, carried by params_to_jax), batch and draws.
Marked ``slow`` (two JAX compiles at these widths, 1.5-3 minutes); run with
``python -m pytest tests/test_torch_phase_a_parity.py -m slow -s``.

The first step's losses agree. From the second step on, the SDF's volume
features carry weight (the geometric init zeroes them), and the volumes
get a gradient through the SDF. There the JAX step under
``sdf_network.packed_trilerp: true`` (which confs/dtu.yaml and the
quality script set) differs from its own step under ``false`` and from
the port: its packed-diff lookup (gens_tpu/ops/interp.py:786-833) passes
the volumes none of the render core's SDF value and ∇SDF gradient and only
the trilerp's own Hessian part of its Hessian·1 gradient (ROADMAP §C), so
the U-Net gets little. The port computes the plain trilerp's gradient,
which the JAX step computes under ``packed_trilerp: false``; with the
reference's detaches installed (tests/_reference_packed_grad.py) it
computes the JAX step's under ``true``. This test pins these facts and
prints the per-module gradients it compares."""

import contextlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gens_tpu.losses as jl
from gens_torch import losses as tl
from gens_torch.convert import params_from_jax, params_to_jax
from gens_torch.eval import quality_train as qt
from gens_torch.eval.quality import scene_params
from gens_torch.models.gens import GenSModel as TGenSModel
from gens_torch.train.step import TrainStep
from gens_tpu.models.gens import GenSModel as JGenSModel

import _torch_common  # noqa: F401  (torch at one thread)
from _reference_packed_grad import reference_packed_grad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("feature", "reg", "sdf", "blending", "variance")
# per module, ||g_port - g_jax|| / ||g_jax|| against the plain-trilerp JAX
# step, f32 both sides: tests/test_torch_train.py's bounds for the reg net,
# whose InstanceNorm amplifies f32 noise, and the SDF's Hessian·1 term
# (third derivatives of the trilerp) alike; 2e-2 on the rest
GRAD_TOL = {"feature": 2e-2, "reg": 5e-2, "sdf": 5e-2, "blending": 2e-2,
            "variance": 2e-2}

pytestmark = pytest.mark.slow


def script():
    spec = importlib.util.spec_from_file_location(
        "quality_synthetic", os.path.join(REPO, "scripts",
                                          "quality_synthetic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def draws(step: int):
    """The JAX step's key and the perturb noise and sparse points it draws
    from it (gens_tpu/models/renderer.py:501)."""
    key = jax.random.PRNGKey(step)
    pk, sk = jax.random.split(key)
    noise = np.array(jax.random.uniform(pk, (512, 1)) - 0.5)
    sparse = np.array(jax.random.uniform(sk, (512, 3), minval=-1.0,
                                         maxval=1.0))
    return key, torch.from_numpy(noise), torch.from_numpy(sparse)


def grads_by_module(grads):
    """{module: its parameters' gradients, flat, in the order of their
    names}."""
    out = {}
    for name in sorted(grads):
        top = name.split(".")[0]
        if top in MODULES:
            out.setdefault(top, []).append(grads[name].reshape(-1))
    return {k: torch.cat(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def second_step():
    """The losses of the first step in both packages; then, at the port's
    params after that step, the gradient of the second step's loss in the
    port, in the port with the reference's detaches, and in the JAX step
    with packed_trilerp true and false."""
    args = qt.parse_args([])
    tcfg = qt.build_cfg(args, args.steps_a)
    tcfg.train.anneal_end = args.steps_a // 4
    batches, _ = qt.pregen_batches(scene_params(0), 2, False, 0,
                                   (128, 128), 512, 5, 0.5,
                                   torch.device("cpu"))
    torch.manual_seed(0)
    tm = TGenSModel(tcfg.model)
    jitems = [{k: jnp.asarray(v.numpy()) for k, v in b.items()}
              for b in batches]
    jgrads = {}
    for packed in (True, False):
        jcfg = script().build_config(args.steps_a)
        jcfg.train.anneal_end = args.steps_a // 4
        jcfg.model.sdf_network.packed_trilerp = packed
        jm = JGenSModel(jcfg.model)

        def loss_fn(p, inputs, key, anneal, jm=jm, jcfg=jcfg):
            out = jm.forward_train(p, inputs, anneal, False, key)
            losses = jl.compute_losses(out, inputs, jcfg.train.loss)
            return losses["loss"], losses

        jgrads[packed] = jax.jit(jax.grad(loss_fn, has_aux=True))

    def jax_at(packed, step):
        params = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
        g, losses = jgrads[packed](params, jitems[step], draws(step)[0],
                                   step / tcfg.train.anneal_end)
        g = params_from_jax(jax.tree.map(
            lambda x: np.asarray(x, np.float32), g))
        return grads_by_module(g), {k: float(v) for k, v in losses.items()}

    _, jax_first = jax_at(True, 0)
    step = TrainStep(tm, tcfg, steps_per_epoch=1)
    _, noise, sparse = draws(0)
    port_first = step(batches[0], 0.0, False, perturb_noise=noise,
                      sparse_pts=sparse)
    # the second step's gradient at the port's params after the first
    _, noise, sparse = draws(1)
    tm.train()
    anneal = 1 / tcfg.train.anneal_end
    port = {}
    for name, ctx in (("port", contextlib.nullcontext),
                      ("port_ref", reference_packed_grad)):
        tm.zero_grad(set_to_none=True)
        with ctx():
            out = tm.forward_train(batches[1], anneal, False,
                                   perturb_noise=noise, sparse_pts=sparse)
        tl.compute_losses(out, batches[1], tcfg.train.loss)["loss"].backward()
        port[name] = grads_by_module({n: p.grad for n, p
                                      in tm.named_parameters()
                                      if p.grad is not None})
    return {"jax_first": jax_first,
            "port_first": {k: float(v) for k, v in port_first.items()
                           if k != "phase_ms"},
            **port, "jax_packed": jax_at(True, 1)[0],
            "jax_plain": jax_at(False, 1)[0]}


def rel(a, b) -> float:
    return float((a - b).norm() / a.norm())


def test_first_step_losses_match_jax(second_step):
    jf, pf = second_step["jax_first"], second_step["port_first"]
    print("first step, JAX / port:", {k: (jf[k], pf[k]) for k in jf})
    for k, v in jf.items():
        assert pf[k] == pytest.approx(v, rel=1e-4, abs=1e-7), k


def test_second_step_gradient_is_the_plain_trilerps(second_step):
    """The port's gradient is the JAX step's under packed_trilerp false,
    per module."""
    port, plain = second_step["port"], second_step["jax_plain"]
    errs = {k: rel(plain[k], port[k]) for k in MODULES}
    print("port against JAX packed_trilerp=false:", errs)
    for k in MODULES:
        assert errs[k] <= GRAD_TOL[k], (k, errs[k])


def test_jax_packed_trilerp_passes_little_volume_gradient(second_step):
    """Found in the reference: under packed_trilerp true the U-Net's
    gradient, which reaches it only through the volumes, falls far short
    of the plain trilerp's, while the SDF's own agree."""
    plain, packed = second_step["jax_plain"], second_step["jax_packed"]
    norms = {k: (float(plain[k].norm()), float(packed[k].norm()))
             for k in MODULES}
    print("JAX gradient norm, packed_trilerp false / true:", norms)
    print("JAX packed_trilerp true against false:",
          {k: rel(plain[k], packed[k]) for k in MODULES})
    assert rel(plain["sdf"], packed["sdf"]) <= GRAD_TOL["sdf"]
    assert rel(plain["reg"], packed["reg"]) > 0.5, norms["reg"]
    assert norms["reg"][1] < 0.1 * norms["reg"][0], norms["reg"]


def test_reference_detaches_give_the_jax_packed_step(second_step):
    """With the reference's detaches installed, the port's gradient is the
    JAX step's under packed_trilerp true, per module, within the bounds
    that hold the plain port to the JAX step under false."""
    port_ref, packed = second_step["port_ref"], second_step["jax_packed"]
    errs = {k: rel(packed[k], port_ref[k]) for k in MODULES}
    print("port with the reference's detaches against JAX "
          "packed_trilerp=true:", errs)
    print("gradient norm, port with the detaches / JAX true:",
          {k: (float(port_ref[k].norm()), float(packed[k].norm()))
           for k in MODULES})
    for k in MODULES:
        assert errs[k] <= GRAD_TOL[k], (k, errs[k])
