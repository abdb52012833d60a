"""K3 (gens_torch/ops/fused_mlp.py): its plain version against the JAX
Pallas kernel run in interpret mode, as tests/test_pallas_mlp.py runs it,
plus the CPU dispatch, the parameter bridge and the trained artifact.

The CUDA kernel itself has no CPU mode: tests/test_torch_cuda.py runs it on
a card, and chip_smoke.py holds it against the plain version at the serving
path's shapes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gens_tpu.config import SDFNetConfig as JSDFCfg
from gens_tpu.models.embedder import positional_encoding
from gens_tpu.models.sdf_net import SDFNetwork as JSDF
from gens_tpu.ops.interp import lookup_volume_cascade_packed, pack_cascade
from gens_tpu.ops.pallas_mlp import sdf_fused_fn as j_fused_fn
from gens_tpu.ops.pallas_mlp import sdf_mlp_fused as j_mlp_fused
from gens_torch import convert
from gens_torch.config import Config, SDFNetConfig
from gens_torch.models.gens import GenSModel
from gens_torch.models.sdf_net import SDFNetwork
from gens_torch.ops import fused_mlp as fm
from gens_torch.utils.profiling import counter

from _torch_common import t

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "quality_gen_r05_sharpen.pkl")
SMALL = dict(d_out=17, d_hidden=48, n_layers=4, skip_in=(2,), multires=4,
             feat_channels=8, feat_multires=2)
# the kernel's tolerance: f32 on both sides, sums in another order
RTOL, ATOL = 1e-4, 1e-5


def port_sdf(cfg_kw, tree):
    net = SDFNetwork(SDFNetConfig(**cfg_kw))
    net.load_state_dict(convert.sdf_state(tree, prefix=""), strict=True)
    return net


@pytest.fixture(scope="module")
def small():
    rng = np.random.RandomState(0)
    jnet = JSDF(JSDFCfg(**SMALL))
    vols = [rng.rand(8 >> i, 8 >> i, 8 >> i, 4).astype(np.float32)
            for i in range(2)]
    pts = rng.uniform(-0.9, 0.9, (64, 3)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                       [jnp.asarray(v) for v in vols])
    tree = jax.tree.map(np.asarray, params)
    return jnet, params, port_sdf(SMALL, tree), vols, pts


@pytest.fixture(scope="module")
def artifact():
    return convert.load_checkpoint(ARTIFACT)


def test_plain_matches_pallas_interpret(small):
    jnet, params, tnet, vols, pts = small
    flat, shapes, offsets = pack_cascade([jnp.asarray(v) for v in vols])
    feats = lookup_volume_cascade_packed(flat, shapes, offsets,
                                         jnp.asarray(pts))
    x_pe = positional_encoding(jnp.asarray(pts), SMALL["multires"])
    feats_pe = positional_encoding(feats, SMALL["feat_multires"])
    ref = np.asarray(j_mlp_fused(params, jnet.cfg, x_pe, feats_pe, tile=32,
                                 interpret=True))
    folded = fm.fold_sdf_mlp(tnet)
    got = fm.sdf_mlp_plain(folded, t(np.asarray(x_pe)),
                           t(np.asarray(feats_pe)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_fused_fn_cpu_dispatch_with_ragged_rows(small):
    jnet, params, tnet, vols, pts = small
    before = counter("k3.launches")
    ref = np.asarray(j_fused_fn(params, jnet.cfg,
                                [jnp.asarray(v) for v in vols], tile=32,
                                interpret=True)(jnp.asarray(pts[:50])))
    got = fm.sdf_fused_fn(tnet, [t(v) for v in vols])(t(pts[:50]))
    assert got.shape == (50,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert counter("k3.launches") == before


def test_wrapper_rejects_other_devices(small):
    folded = fm.fold_sdf_mlp(small[2])
    x = torch.empty((4, 27), device="meta")
    f = torch.empty((4, 40), device="meta")
    with pytest.raises(ValueError, match="no path"):
        fm.sdf_mlp_fused(folded, x, f)


def test_fold_rejects_unsupported_structure():
    net = SDFNetwork(SDFNetConfig(**dict(SMALL, skip_in=(0,), d_hidden=64)))
    with pytest.raises(ValueError):
        fm.fold_sdf_mlp(net)


def test_trained_artifact_loads_at_full_width(artifact):
    assert artifact["params"]["sdf"]["params"]["lin1"]["v"].dtype == np.float16
    model = GenSModel(Config().model)
    convert.load_params(model, artifact)
    v = model.sdf.lin1.v
    assert v.dtype == torch.float32 and tuple(v.shape) == (228, 128)
    np.testing.assert_array_equal(
        v.detach().numpy(),
        artifact["params"]["sdf"]["params"]["lin1"]["v"].astype(np.float32))
    widths = [w.shape for w, _ in fm.fold_sdf_mlp(model.sdf).weights]
    assert widths == [(27, 128), (228, 128), (228, 101), (228, 128),
                      (228, 128), (228, 128), (228, 129)]


def test_trained_plain_matches_pallas_interpret(artifact):
    """Full-width plain K3 on the trained weights vs the Pallas kernel."""
    tree = artifact["params"]["sdf"]
    tree32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    cfg = JSDFCfg()
    rng = np.random.RandomState(1)
    x_pe = rng.uniform(-1, 1, (128, 27)).astype(np.float32)
    feats_pe = rng.uniform(-1, 1, (128, 100)).astype(np.float32)
    ref = np.asarray(j_mlp_fused(tree32, cfg, jnp.asarray(x_pe),
                                 jnp.asarray(feats_pe), tile=64,
                                 interpret=True))
    got = fm.sdf_mlp_plain(fm.fold_sdf_mlp(port_sdf({}, tree)), t(x_pe),
                           t(feats_pe))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_orbax_directory_raises(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        convert.load_checkpoint(str(tmp_path))
