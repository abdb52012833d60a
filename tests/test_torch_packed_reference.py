"""The JAX packed-diff trilerp's volume gradient under the render core's
nesting, pinned on JAX primitives at a tiny size (no model compiles), and
the port's test-side reproduction of it (tests/_reference_packed_grad.py).

The render core (gens_tpu/models/renderer.py:202-220) takes the SDF's value
and ∇SDF from ``jax.vjp`` w.r.t. the points and Hessian·1 from ``jax.jvp``
of that; the training step differentiates all three w.r.t. the volumes.
Through ``trilerp_packed_diff`` the value and ∇SDF then pass the volume
nothing -- the custom JVP rules ``_pd_value_jvp`` and ``_pd_grad_jvp``
(gens_tpu/ops/interp.py:786-822) compute those primal outputs from the
stop-gradient table -- while Hessian·1, a tangent of ``_pd_hess``, passes
the plain trilerp's. One level of differentiation, as the sparse and
pseudo points see it, keeps the plain gradient (tests/test_packed_diff.py
tests up to two levels). ROADMAP §C has the map of every training site."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gens_tpu.ops.interp import (PackedVolume, pack_supercell, trilerp,
                                 trilerp_packed_diff)

import _torch_common  # noqa: F401  (torch at one thread)
from _reference_packed_grad import detach_form_trilerp

OUTPUTS = ("value", "grad", "smooth")
RTOL = 1e-5


@pytest.fixture(scope="module")
def vol_pts():
    rng = np.random.RandomState(0)
    vol = rng.randn(9, 7, 8, 4).astype(np.float32)
    pts = rng.uniform(-1.15, 1.15, (64, 3)).astype(np.float32)
    return vol, pts


def packed(v, p):
    table, dims = pack_supercell(v)
    return trilerp_packed_diff(v, PackedVolume(jax.lax.stop_gradient(table),
                                               dims), p)


def core_terms(lookup, v, pts):
    """(value, ∇SDF, Hessian·1) as ``Renderer.sdf_value_grad_smooth``
    nests them, with channel 0 as the SDF."""
    def grad_fn(p):
        out, vjp = jax.vjp(lambda q: lookup(v, q), p)
        (g,) = vjp(jnp.zeros_like(out).at[:, 0].set(1.0))
        return g, out

    (g, out), (sm, _) = jax.jvp(grad_fn, (pts,), (jnp.ones_like(pts),))
    return {"value": out[:, 0], "grad": g, "smooth": sm}


@pytest.fixture(scope="module")
def jax_side(vol_pts):
    """Under one jit: the plain terms, and per lookup d Σ term² / d volume
    for each output and the one-level d Σ 1.3 sin(value) / d volume."""
    def run(v, p):
        res = {"terms": core_terms(trilerp, v, p)}
        for name, f in (("plain", trilerp), ("packed", packed)):
            res[name] = {o: jax.grad(lambda x, o=o, f=f: jnp.sum(
                core_terms(f, x, p)[o] ** 2))(v) for o in OUTPUTS}
            res[name]["one_level"] = jax.grad(
                lambda x, f=f: jnp.sum(jnp.sin(f(x, p)) * 1.3))(v)
        return res

    out = jax.jit(run)(*(jnp.asarray(a) for a in vol_pts))
    return jax.tree.map(np.asarray, out)


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("output", OUTPUTS)
def test_render_core_nesting_drops_value_and_grad(jax_side, output):
    plain, pk = jax_side["plain"][output], jax_side["packed"][output]
    assert np.linalg.norm(plain) > 1.0
    if output == "smooth":
        assert rel(pk, plain) <= RTOL
    else:
        assert not pk.any()


def test_one_level_keeps_the_plain_gradient(jax_side):
    """grad w.r.t. the volume of a function of the value, the nesting of
    the sparse and pseudo points (as in tests/test_packed_diff.py)."""
    plain = jax_side["plain"]["one_level"]
    pk = jax_side["packed"]["one_level"]
    assert np.linalg.norm(plain) > 1.0
    assert rel(pk, plain) <= RTOL


@pytest.mark.parametrize("output", OUTPUTS)
def test_port_detach_form_is_the_packed_chains_gradient(vol_pts, jax_side,
                                                       output):
    """The port's ``detach_form_trilerp`` under the port's nesting (the
    render core's two ``autograd.grad`` with ``create_graph``) gives the
    volume the JAX packed chain's gradient."""
    vol, pts = vol_pts
    pk = jax_side["packed"][output]
    v = torch.from_numpy(vol).requires_grad_(True)
    p = torch.from_numpy(pts).requires_grad_(True)
    out = detach_form_trilerp(v, p)
    (g,) = torch.autograd.grad(out[:, 0].sum(), p, create_graph=True)
    (sm,) = torch.autograd.grad(g, p, torch.ones_like(g), create_graph=True)
    term = {"value": out[:, 0], "grad": g, "smooth": sm}[output]
    np.testing.assert_allclose(term.detach().numpy(),
                               jax_side["terms"][output], rtol=1e-5,
                               atol=1e-5)
    (gv,) = torch.autograd.grad((term ** 2).sum(), v, allow_unused=True)
    gv = np.zeros_like(vol) if gv is None else gv.numpy()
    if output == "smooth":
        assert rel(gv, pk) <= RTOL
    else:
        assert not gv.any()
