"""Which training lookups of gens_tpu lose their volume gradient under
``sdf_network.packed_trilerp: true``, site by site, on the CPU:

    python tests/_packed_site_map.py [--out MAP.json]

Every site is called through the JAX package's own function, nested as a
training step nests it, on a small random SDF network (feature weights
non-zero) and cascade. For each output the script takes the gradient of
Σ w·output (w fixed random weights) w.r.t. the raw volumes (2D sites: the
feature maps and images) three ways: through the packed lookup, through
the plain one, and (the render core) through the plain one with its
trilerp in the "detach form" -- value and point gradient from the detached
volume, the point Hessian from the live one (``detach_form_trilerp``, the
form tests/_reference_packed_grad.py gives the port). It prints one row
a site and output: the three norms, the packed gradient's relative
difference to the plain and to the detach form, and the verdict against
the plain one ("kept" within ``tol``, "dropped" when zero, else
"partial").

The cause is in the custom JVP rules of gens_tpu/ops/interp.py:
``_pd_value_jvp`` (:808-822) and ``_pd_grad_jvp`` (:786-801) compute their
primal outputs from the stop-gradient table (:833), so a differentiation
level outside the rule's own sees no volume in them; only the tangents,
which go through the custom calls ``_pd_grad`` and ``_pd_hess``, reach it.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gens_tpu.models.sdf_net as jsdf  # noqa: E402
from gens_tpu.config import RenderConfig, SDFNetConfig  # noqa: E402
from gens_tpu.data.synthetic import make_scene  # noqa: E402
from gens_tpu.models.renderer import Renderer, Scene  # noqa: E402
from gens_tpu.models.volume import agg_mean_var  # noqa: E402
from gens_tpu.ops.interp import (DiffPackedCascade,  # noqa: E402
                                 pack_cascade_supercell, pack_supercell2d,
                                 trilerp, trilerp_spatial_hess)
from gens_tpu.ops.projection import lookup_feature  # noqa: E402

DIMS = ((9, 7, 8), (5, 4, 4))
C = 3
N = 64
TOL = 1e-4


def detach_form_trilerp(volume, pts):
    """trilerp whose value and point gradient carry no volume gradient and
    whose point Hessian carries the plain one: the value from the detached
    volume plus ½ dpᵀ H(volume − detached) dp, dp = pts − detached pts,
    which is zero with a zero point gradient but has the trilerp's Hessian
    of the volume's tangent."""
    sv = jax.lax.stop_gradient(volume)
    p0 = jax.lax.stop_gradient(pts)
    dp = pts - p0
    h = trilerp_spatial_hess(volume - sv, p0)
    return trilerp(sv, pts) + 0.5 * jnp.einsum("ni,ncij,nj->nc", dp, h, dp)


def sdf_module(packed: bool) -> jsdf.SDFNetwork:
    return jsdf.SDFNetwork(SDFNetConfig(
        d_out=5, d_hidden=32, n_layers=3, skip_in=(2,), multires=2,
        feat_channels=C * len(DIMS), feat_multires=1, geometric_init=False,
        packed_trilerp=packed))


def rel(a, b) -> float:
    nb = float(jnp.linalg.norm(b))
    if nb == 0.0:
        return 0.0 if float(jnp.linalg.norm(a)) == 0.0 else float("inf")
    return float(jnp.linalg.norm(a - b)) / nb


def flat(tree):
    return jnp.concatenate([jnp.ravel(x) for x in jax.tree.leaves(tree)])


def row(site, lookup, output, g_pk, g_plain, g_form=None, tol=TOL):
    r = {"site": site, "lookup": lookup, "output": output,
         "norm_plain": float(jnp.linalg.norm(g_plain)),
         "norm_packed": float(jnp.linalg.norm(g_pk)),
         "rel_to_plain": rel(g_pk, g_plain)}
    if g_form is not None:
        r["norm_detach_form"] = float(jnp.linalg.norm(g_form))
        r["rel_to_detach_form"] = rel(g_pk, g_form)
    r["verdict"] = ("dropped" if r["norm_packed"] == 0.0 else
                    "kept" if r["rel_to_plain"] < tol else "partial")
    return r


def sdf_sites(rng):
    """The 3D sites: the render core (grad of a jvp of a vjp), the sparse
    random points and the pseudo points (grad of the value), each through a
    scene's packed tables (DiffPackedCascade) and through phase ft's inline
    pack (raw volumes under packed_trilerp: true)."""
    vols = [jnp.asarray(rng.randn(*d, C).astype(np.float32)) for d in DIMS]
    pts = jnp.asarray(rng.uniform(-1.1, 1.1, (N, 3)).astype(np.float32))
    mods = {p: sdf_module(p) for p in (False, True)}
    params = mods[False].init(jax.random.PRNGKey(0), pts, vols)
    rens = {p: Renderer(mods[p], None, None, RenderConfig())
            for p in (False, True)}
    mask_any = jnp.ones(DIMS[0], jnp.float32)

    def sdf_vols(kind, v):
        if kind == "scene":  # build_scene's tables, renderer.py:254-258
            return DiffPackedCascade(list(v), list(pack_cascade_supercell(v)))
        return v  # "inline": gens_tpu/models/sdf_net.py:186-197

    def core(kind, v):
        """(value, latent, ∇SDF, Hessian·1) of the render core."""
        out, g, sm = rens[kind in ("scene", "inline")].sdf_value_grad_smooth(
            {"sdf": params}, sdf_vols(kind, v), pts)
        return {"value": out[:, 0], "latent": out[:, 1:], "grad": g,
                "smooth": sm}

    def value(kind, v):
        """SDFNetwork.sdf, as the sparse random points call it."""
        return {"value": mods[kind in ("scene", "inline")].apply(
            params, pts, sdf_vols(kind, v), method=jsdf.SDFNetwork.sdf)}

    def pseudo(kind, v):
        pv = list(pack_cascade_supercell(v)) if kind == "scene" else None
        scene = Scene(volumes=list(v), mask_volumes=None, features=None,
                      match_features=None, imgs=None, intrs=None, c2ws=None,
                      mask_any=mask_any, packed_volumes=pv)
        return {"value": rens[kind == "scene"].pseudo_sdf(
            {"sdf": params}, scene, pts)}

    def grad_of(fn, kind, key, w):
        return flat(jax.jit(jax.grad(
            lambda v: jnp.sum(fn(kind, v)[key] * w)))(vols))

    rows = []
    for site, fn, kinds in (
            ("render core, renderer.py:278-279", core, ("scene", "inline")),
            ("sparse random points, renderer.py:396", value,
             ("scene", "inline")),
            ("pseudo points, renderer.py:534-549", pseudo, ("scene",))):
        outs = jax.eval_shape(lambda v, f=fn: f("plain", v), vols)
        for key, o in outs.items():
            w = jnp.asarray(rng.randn(*o.shape).astype(np.float32))
            g_plain = grad_of(fn, "plain", key, w)
            g_form = None
            if fn is core:
                plain_lookup = jsdf.lookup_volume_cascade
                jsdf.lookup_volume_cascade = lambda vs, p: jnp.concatenate(
                    [detach_form_trilerp(x, p) for x in vs], axis=-1)
                try:
                    g_form = grad_of(fn, "plain", key, w)
                finally:
                    jsdf.lookup_volume_cascade = plain_lookup
            for kind in kinds:
                rows.append(row(site, ("scene tables" if kind == "scene"
                                       else "inline pack (phase ft)"),
                                key, grad_of(fn, kind, key, w), g_plain,
                                g_form))
    return rows


def image_sites(rng):
    """The 2D sites, each under the one grad w.r.t. the maps that training
    puts around it: the render core's source-view lookup
    (projection.py:122,141; its points come from the sampler without
    gradient) and the aggregation (volume.py:190-200; packed_bilerp true,
    and "table_bf16", the pallas mode's fallback below 16³, whose forward
    reads bf16-rounded rows, so its variance channels' cotangents carry
    2⁻⁸ of rounding: tolerance 1e-2 there)."""
    raw = make_scene(n_views=3, hw=(32, 32), n_rays=8)
    imgs = jnp.asarray(raw["imgs"])
    intrs, c2ws = jnp.asarray(raw["intrs"]), jnp.asarray(raw["c2ws"])
    feats = [jnp.asarray(rng.randn(3, 32 >> i, 32 >> i, 4).astype(np.float32))
             for i in range(2)]
    pts = jnp.asarray(rng.uniform(-0.6, 0.6, (N, 3)).astype(np.float32))

    def lookup(mode, fs, im):
        kw = {}
        if mode:
            kw = dict(packed_features=[pack_supercell2d(x) for x in fs],
                      packed_imgs=pack_supercell2d(im), diff=True)
        return lookup_feature(pts, im, intrs, c2ws, fs, **kw)[0]

    def agg(mode, fs, im):
        vols, _ = agg_mean_var(fs, intrs, c2ws, (8, 4), packed_bilerp=mode)
        return jnp.concatenate([v.reshape(-1) for v in vols])

    rows = []
    for site, fn, modes in (
            ("source-view lookup, projection.py:122,141", lookup, (True,)),
            ("aggregation, volume.py:190-200", agg, (True, "table_bf16"))):
        out = jax.eval_shape(lambda fs, im, f=fn: f(False, fs, im), feats,
                             imgs)
        w = jnp.asarray(rng.randn(*out.shape).astype(np.float32))

        def grad_of(mode, fn=fn, w=w):
            return flat(jax.jit(jax.grad(
                lambda fs, im: jnp.sum(fn(mode, fs, im) * w),
                argnums=(0, 1)))(feats, imgs))

        g_plain = grad_of(False)
        for mode in modes:
            rows.append(row(site, ("bilerp_packed_diff" if mode is True
                                   else "bilerp_supercell_mixed"),
                            "value", grad_of(mode), g_plain,
                            tol=TOL if mode is True else 1e-2))
    return rows


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    args = p.parse_args()
    rng = np.random.RandomState(0)
    rows = sdf_sites(rng) + image_sites(rng)
    for r in rows:
        form = ""
        if "rel_to_detach_form" in r:
            form = (f" detach form {r['norm_detach_form']:.6g}"
                    f" (rel {r['rel_to_detach_form']:.3g})")
        print(f"{r['site']:42s} {r['lookup']:23s} {r['output']:6s} "
              f"plain {r['norm_plain']:.6g} packed {r['norm_packed']:.6g}"
              f" (rel {r['rel_to_plain']:.3g}){form} {r['verdict']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
