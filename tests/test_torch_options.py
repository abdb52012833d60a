"""The modules behind gens_tpu's model options, port against JAX on the
CPU, forward and (where JAX differentiates) gradients, f32 at rtol 1e-5 /
atol 1e-6 unless a test says otherwise: the idr colour head in its three
modes, GlobalAttn in f32 and bf16, RegNetwork with GlobalAttn,
RegNetworkLite, the adaptive aggregation with a voxel that no view sees,
the MnasNet backbone (1e-4, as tests/test_mnasnet_parity.py) and its
converter and loader, the background-sphere lookups, clean_volume and
``device_memory_stats``."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gens_tpu.models.mnasnet as jmn
import gens_tpu.ops.projection as jp
from gens_tpu.config import FeatureNetConfig as JFeatureNetConfig
from gens_tpu.config import RegNetConfig as JRegNetConfig
from gens_tpu.models.reg_net import GlobalAttn as JGlobalAttn
from gens_tpu.models.reg_net import RegNetwork as JRegNetwork
from gens_tpu.models.reg_net import RegNetworkLite as JRegNetworkLite
from gens_tpu.models.rendering_net import RenderingNetwork as JRendering
from gens_tpu.models.rendering_net import rendering_input_dim as j_input_dim
from gens_tpu.models.volume import AdaptiveAgg as JAdaptiveAgg
from gens_tpu.utils.volume_tools import clean_volume as j_clean_volume
from gens_torch import convert
from gens_torch.config import FeatureNetConfig, RegNetConfig
from gens_torch.models import mnasnet as tmn
from gens_torch.models.reg_net import (GlobalAttn, RegNetwork,
                                       RegNetworkLite, score_divisor)
from gens_torch.models.rendering_net import (RenderingNetwork,
                                             rendering_input_dim)
from gens_torch.models.volume import AdaptiveAgg
from gens_torch.ops import projection as tp
from gens_torch.utils import profiling
from gens_torch.utils.volume_tools import clean_volume

from _torch_common import t, to_np_tree
from test_mnasnet_parity import MnasNetOracle, torch_stages

# atol is taken relative to the largest magnitude of the JAX tensor (a
# gradient of magnitude 10 carries f32 sum-order noise ten times larger)
RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    want = np.asarray(want, np.float32)
    got = np.zeros_like(want) if got is None else np.asarray(
        got.detach() if torch.is_tensor(got) else got, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=msg)


def grads_close(module, prefix, jgrads, rtol=RTOL, atol=ATOL):
    """Every parameter's .grad against the JAX gradient tree (mapped to
    port names by ``convert``)."""
    names = dict(module.named_parameters())
    assert names
    for name, p in names.items():
        close(p.grad, jgrads[prefix + name], rtol, atol, name)


def _reg_state(tree):
    """A JAX reg-net tree as a bare RegNetwork's state dict."""
    return {k[len("reg."):]: v for k, v in convert._reg_state(
        to_np_tree(tree)).items()}


# -- the idr colour head ------------------------------------------------------


@pytest.mark.parametrize("mode,skip_in", [("idr", (2,)), ("no_view_dir", ()),
                                          ("no_normal", ())])
def test_rendering_network_matches_jax(mode, skip_in):
    """(points, normals, view_dirs, features) in that call order, the idr
    concatenation order, the √2 skip, the sigmoid squeeze; gradients w.r.t.
    every input and parameter."""
    rng = np.random.RandomState(0)
    ins = [rng.randn(12, d).astype(np.float32) for d in (3, 3, 3, 16)]
    jnet = JRendering(d_feature=16, mode=mode, d_hidden=64, n_layers=3,
                      skip_in=skip_in, multires_view=2)
    jparams = jnet.init(jax.random.PRNGKey(0), *ins)

    def j_loss(p, *x):
        return jnp.sum(jnp.sin(3.0 * jnet.apply(p, *x)))

    jout = jnet.apply(jparams, *ins)
    jg = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2, 3, 4)))(jparams, *ins)
    net = RenderingNetwork(d_feature=16, mode=mode, d_hidden=64, n_layers=3,
                           skip_in=skip_in, multires_view=2)
    state = {k[len("blending."):]: v for k, v in convert._blending_state(
        to_np_tree(jparams)).items()}
    net.load_state_dict(state, strict=True)
    x = [t(a).requires_grad_(True) for a in ins]
    out = net(*x)
    close(out, jout)
    assert float(out.detach().min()) >= 0 and float(out.detach().max()) <= 1
    torch.sin(3.0 * out).sum().backward()
    for a, b in zip(x, jg[1:]):
        close(a.grad, b)
    grads_close(net, "blending.", convert._blending_state(
        to_np_tree(jg[0])))


def test_rendering_input_dim_matches_jax():
    for mode in ("idr", "no_view_dir", "no_normal"):
        for d_feature, multires in ((8, 0), (128, 4), (16, 1)):
            assert (rendering_input_dim(mode, d_feature, multires)
                    == j_input_dim(mode, d_feature, multires))
    with pytest.raises(ValueError):
        rendering_input_dim("rgb", 8, 0)


# -- GlobalAttn, RegNetwork with it, RegNetworkLite ---------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_attn_matches_jax(dtype):
    """The confs/dtu.yaml shape of the block (128 channels, 4 heads, d_keys
    = d_values = 32, d_ff 256) on a 4³ bottleneck. Under bf16 input the
    Dense layers promote to f32 and the score divisor is √32 in bf16,
    5.65625: the f32 √32 (5.656854) moves the output past the limits."""
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 4, 4, 128) * 2).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    jblock = JGlobalAttn(d_ff=256, d_keys=32, d_values=32, n_heads=4)
    jparams = jblock.init(jax.random.PRNGKey(1), jx)
    # bias and scale off their init, so a swapped leaf would show
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(rng.uniform(-0.2, 0.2, a.shape),
                                  a.dtype), jparams)
    jout = jax.jit(jblock.apply)(jparams, jx)
    assert jout.dtype == jnp.float32
    block = GlobalAttn(128, d_ff=256, d_keys=32, d_values=32, n_heads=4)
    state = {k[len("reg.global_attn."):]: v for k, v in
             convert._global_attn_state(to_np_tree(jparams)["params"]).items()}
    block.load_state_dict(state, strict=True)
    tx = t(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    tx = tx.permute(3, 0, 1, 2).contiguous().requires_grad_(dtype == "float32")
    out = block(tx)
    assert out.dtype == torch.float32
    close(out.permute(1, 2, 3, 0), jout)
    if dtype == "bfloat16":
        assert score_divisor(32, torch.bfloat16) == 5.65625 == float(
            jnp.sqrt(jnp.asarray(32, jnp.bfloat16)))
        # the f32 divisor misses: scale the scores by 5.65625 / √32
        with torch.no_grad():
            f = 5.65625 / float(np.sqrt(np.float32(32)))
            block.query.weight.mul_(f)
            block.query.bias.mul_(f)
            off = float((block(tx).permute(1, 2, 3, 0)
                         - t(np.asarray(jout))).abs().max())
        assert off > ATOL + RTOL * float(np.abs(np.asarray(jout)).max())
        return
    assert score_divisor(32, torch.float32) == float(
        jnp.sqrt(jnp.asarray(32, jnp.float32)))

    def j_loss(p, xx):
        return jnp.sum(jnp.sin(jblock.apply(p, xx)))

    jg_p, jg_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jparams, jx)
    torch.sin(out).sum().backward()
    close(tx.grad.permute(1, 2, 3, 0), jg_x, 1e-5, 1e-5)
    grads_close(block, "reg.global_attn.", convert._global_attn_state(
        to_np_tree(jg_p)["params"]), 1e-5, 1e-5)


def close_to_max(got, want, tol=1e-4):
    """max |got - want| within ``tol`` of max |want|: the U-Net's
    InstanceNorm over 2-8 voxel coarse volumes amplifies f32 sum-order
    noise past elementwise limits."""
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _reg_inputs(rng, dims, c):
    return [rng.rand(d, d, d, c).astype(np.float32) for d in dims]


def _reg_grads_close(net, jg, tol):
    """Per-parameter relative norm, for close_to_max's reason
    (test_torch_train.GRAD_TOL's)."""
    jgs = _reg_state(jg)
    for name, p in net.named_parameters():
        if name == "global_attn.key.bias":
            # zero in exact arithmetic: q·b_key is the same for every key,
            # and the softmax over the keys ignores it
            continue
        a = t(jgs[name])
        err = float((p.grad - a).norm() / (a.norm() + 1e-30))
        assert err <= tol, (name, err)


def _jax_reg_params(net):
    """The port module's fresh params as the JAX tree (flax's apply checks
    every name and shape), without a JAX init; RegNetworkLite's blocks
    are not remat-wrapped, so they carry no "Checkpoint" prefix."""
    tree = convert.params_to_jax(
        {"reg." + k: v for k, v in net.state_dict().items()})["reg"]
    if isinstance(net, RegNetworkLite):
        tree = {"params": {k.replace("Checkpoint", ""): v
                           for k, v in tree["params"].items()}}
    return tree


def test_reg_network_global_attn_matches_jax():
    """RegNetwork with GlobalAttn at a 2³ bottleneck (8 voxels, 16
    channels), f32: outputs and every parameter's gradient."""
    rng = np.random.RandomState(2)
    dims = (16, 8, 4)
    cfg = dict(d_volume=(8,) * 3, d_out=(4,) * 3, d_base=4,
               use_global_attn=True)
    vols = _reg_inputs(rng, dims, 8)
    torch.manual_seed(2)
    net = RegNetwork(RegNetConfig(**cfg))
    jparams = _jax_reg_params(net)
    assert "GlobalAttn_0" in jparams["params"]
    jnet = JRegNetwork(JRegNetConfig(**cfg))
    jv = [jnp.asarray(v)[None] for v in vols]

    def j_loss(p, vs):
        outs = jnet.apply(p, vs)
        return sum(jnp.sum(jnp.sin(o)) for o in outs), outs

    jg, jouts = jax.jit(jax.grad(j_loss, has_aux=True))(jparams, jv)
    outs = net([t(v) for v in vols])
    for o, jo in zip(outs, jouts):
        close_to_max(o, jo[0])
    sum(torch.sin(o).sum() for o in outs).backward()
    _reg_grads_close(net, jg, 1e-3)


def test_reg_network_lite_matches_jax():
    """One output, the finest, in f32 (the cases of
    tests/test_alternatives.py; nothing in either package differentiates
    it)."""
    rng = np.random.RandomState(3)
    dims = (16, 8, 4)
    cfg = dict(d_volume=(8,) * 3, d_out=(4,) * 3, d_base=8)
    vols = _reg_inputs(rng, dims, 8)
    torch.manual_seed(3)
    net = RegNetworkLite(RegNetConfig(**cfg))
    jout = jax.jit(JRegNetworkLite(JRegNetConfig(**cfg)).apply)(
        _jax_reg_params(net), [jnp.asarray(v)[None] for v in vols])
    with torch.no_grad():
        out = net([t(v) for v in vols])
    assert out.shape == (16, 16, 16, 4)
    close_to_max(out, jout[0])


# -- the adaptive aggregation -------------------------------------------------


def _views(rng, n_views=3, hw=(16, 20), c=4):
    """Three cameras 2.5 units from the origin, 0.3 rad apart, looking at
    it with a narrow field of view: the centre of the [-1, 1]³ grid is in
    every image, its corners near the cameras in none."""
    feats = [rng.rand(n_views, hw[0] >> i, hw[1] >> i, c).astype(np.float32)
             for i in range(3)]
    intr = np.array([[20.0, 0, hw[1] / 2], [0, 20.0, hw[0] / 2], [0, 0, 1]],
                    np.float32)
    c2ws = []
    for k in range(n_views):
        ang = 0.3 * k
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R
        c2w[:3, 3] = R @ np.array([0, 0, -2.5], np.float32)
        c2ws.append(c2w)
    return feats, np.stack([intr] * n_views), np.stack(c2ws)


def test_adaptive_agg_matches_jax():
    """Volumes, masks and the gradients w.r.t. the features and the score
    MLPs, with voxels that no view sees (uniform weights over the views'
    out-of-image samples) and voxels seen by one or two views."""
    rng = np.random.RandomState(4)
    feats, intrs, c2ws = _views(rng)
    feats, intrs, c2ws = ([jnp.asarray(f) for f in feats], jnp.asarray(intrs),
                          jnp.asarray(c2ws))
    dims = (8, 4, 2)
    jagg = JAdaptiveAgg(n_scales=3)
    jparams = jax.jit(jagg.init, static_argnums=4)(
        jax.random.PRNGKey(4), feats, intrs, c2ws, dims)

    def j_loss(p, fs):
        vols, masks = jagg.apply(p, fs, intrs, c2ws, dims)
        return sum(jnp.sum(jnp.sin(3.0 * v)) for v in vols), (vols, masks)

    (jg_p, jg_f), (jvols, jmasks) = jax.jit(jax.grad(
        j_loss, argnums=(0, 1), has_aux=True))(jparams, feats)
    agg = AdaptiveAgg([4, 4, 4])
    agg.load_state_dict({k[len("agg."):]: v for k, v in convert._agg_state(
        to_np_tree(jparams)).items()}, strict=True)
    tf = [t(f).requires_grad_(True) for f in feats]
    vols, masks = agg(tf, t(intrs), t(c2ws), dims)
    # the case holds voxels that no view sees and voxels that two or more do
    with torch.no_grad():
        _, seen_any = agg(tf, t(intrs), t(c2ws), dims, min_vis_view=0)
    assert float(seen_any[0].min()) == 0.0
    assert float(np.asarray(jmasks[0]).max()) == 1.0
    for v, m, jv, jm_ in zip(vols, masks, jvols, jmasks):
        assert v.shape[-1] == 4  # C channels, not 2C
        close(v, jv)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm_))
    sum(torch.sin(3.0 * v).sum() for v in vols).backward()
    for f, jgf in zip(tf, jg_f):
        close(f.grad, jgf, 1e-5, 1e-5)
    jgp = convert._agg_state(to_np_tree(jg_p))
    grads_close(agg, "agg.", jgp, 1e-5, 1e-5)


# -- the MnasNet backbone -----------------------------------------------------


@pytest.fixture(scope="module")
def oracle_state():
    """tests/test_mnasnet_parity.py's random torchvision-layout trunk, its
    BN statistics off their init."""
    torch.manual_seed(0)
    net = MnasNetOracle()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
    return net.eval(), {k: v.numpy() for k, v in net.state_dict().items()}


def test_convert_torch_mnasnet_matches_jax(oracle_state):
    _, state = oracle_state
    got = jax.tree_util.tree_flatten_with_path(
        tmn.convert_torch_mnasnet(state))[0]
    want = jax.tree_util.tree_flatten_with_path(
        jmn.convert_torch_mnasnet(state))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_mnasnet_encoder_matches_torchvision_layout(oracle_state):
    """The port's encoder on the converted weights reproduces the
    torchvision trunk's five stages (the k // 2 padding of the strided
    convs on an even, non-square input)."""
    net, state = oracle_state
    enc = tmn.MnasNetEncoder()
    enc.load_state_dict(convert.mnasnet_state(
        tmn.convert_torch_mnasnet(state)), strict=True)
    x = np.random.RandomState(0).rand(2, 3, 64, 96).astype(np.float32)
    want = torch_stages(net, t(x))
    enc.train()  # the BN keeps its running statistics
    with torch.no_grad():
        got = enc(t(x))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        err = float((a - t(b)).abs().max()) / max(float(np.abs(b).max()), 1e-6)
        assert err < 1e-4, (i, err)


def test_mnasnet_feature_network_matches_jax(oracle_state):
    """The whole backbone (encoder, deconv decoder, out_layer heads)
    against flax on the converted encoder weights: the five maps and the
    gradients of every parameter within 1e-4; the BN statistics are
    buffers, unchanged by a train-mode forward."""
    _, state = oracle_state
    x = np.random.RandomState(5).rand(2, 64, 96, 3).astype(np.float32)
    torch.manual_seed(5)
    net = tmn.MnasNetFeatureNetwork(FeatureNetConfig(backbone="mnasnet"))
    net.encoder.load_state_dict(convert.mnasnet_state(
        tmn.convert_torch_mnasnet(state)), strict=True)
    # the port's decoder and heads, the converted encoder, as flax's tree
    variables = convert.params_to_jax(
        {"feature." + k: v for k, v in net.state_dict().items()})["feature"]
    jnet = jmn.MnasNetFeatureNetwork(JFeatureNetConfig(backbone="mnasnet"))

    def j_loss(p):
        outs = jnet.apply({"params": p,
                           "batch_stats": variables["batch_stats"]}, x)
        return sum(jnp.sum(jnp.sin(o)) for o in outs), outs

    jg, jouts = jax.jit(jax.grad(j_loss, has_aux=True))(variables["params"])
    stats = {k: v.clone() for k, v in net.named_buffers()}
    net.train()
    outs = net(t(x))
    for o, jo in zip(outs, jouts):
        scale = float(np.abs(np.asarray(jo)).max())
        err = float((o.detach() - t(np.asarray(jo))).abs().max())
        assert err <= 1e-4 * scale
    sum(torch.sin(o).sum() for o in outs).backward()
    # gradients per parameter in relative norm: each decoder weight's
    # gradient sums 10^4-10^5 products that the next InstanceNorm makes
    # cancel, and torch's CPU convolutions sum them less exactly than XLA
    # (the port's f32 gradients lie up to 1.5e-3 from its own float64
    # ones on these weights, JAX's within 1e-6)
    jgs = convert.mnasnet_state(to_np_tree({"params": jg}))
    for name, p in net.named_parameters():
        a = jgs[name]
        err = float((p.grad - a).norm() / (a.norm() + 1e-30))
        assert err <= 5e-3, (name, err)
    assert not any(k.endswith("running_mean") or k.endswith("running_var")
                   for k, _ in net.named_parameters())
    for k, v in net.named_buffers():
        assert torch.equal(v, stats[k]), k


def test_mnasnet_pretrained_path_loads_the_encoder(oracle_state, tmp_path):
    """The pickle scripts/convert_mnasnet_weights.py writes (the encoder's
    {params, batch_stats} tree), through the port's converter, is what
    ``pretrained_path`` loads into the feature net and its matching copy,
    as the JAX init_params puts it into the ``encoder`` subtree."""
    from gens_torch.config import ModelConfig
    from gens_torch.models.gens import GenSModel

    _, state = oracle_state
    tree = tmn.convert_torch_mnasnet(state)
    path = os.path.join(tmp_path, "mnasnet_encoder.pkl")
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    cfg = ModelConfig()
    cfg.feature_network.backbone = "mnasnet"
    cfg.feature_network.pretrained_path = path
    cfg.volume.volume_dims = (16, 8, 4, 2, 2)
    model = GenSModel(cfg)
    want = convert.mnasnet_state(tree)
    for top in ("feature", "match_feature"):
        got = getattr(model, top).encoder.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (top, k)
    # and the checkpoint layout carries the statistics to JAX and back
    jtree = convert.params_to_jax(model.state_dict())
    assert set(jtree["feature"]) == {"params", "batch_stats"}
    np.testing.assert_array_equal(
        jtree["feature"]["batch_stats"]["encoder"]["stack1"]["block0"][
            "expand"]["bn"]["var"], tree["batch_stats"]["stack1"]["block0"][
            "expand"]["bn"]["var"])


# -- background sphere, clean_volume ------------------------------------------


def test_equirect2sphere_matches_jax():
    rng = np.random.RandomState(6)
    pts = np.concatenate([
        np.array([[0.0, 0.0, 2.0], [4.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                  [0.0, 0.0, 0.1]], np.float32),
        (rng.randn(40, 3) * 2).astype(np.float32)])
    want = jp.equirect2sphere(jnp.asarray(pts))
    got = tp.equirect2sphere(t(pts))
    close(got, want)
    # inside the unit sphere r is clipped to 1
    close(got[:4], [[np.pi / 2, 0, 0.5], [0, 0, 0.25], [0, -np.pi / 2, 1.0],
                    [np.arcsin(0.1), 0, 1.0]], atol=1e-6)
    # gradients off the z axis (the first and fourth points), where
    # atan2(0, 0) has none; at r == 1 exactly (the third) jnp.clip's
    # gradient splits in half
    off_axis = np.delete(pts, [0, 3], axis=0)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jnp.sin(jp.equirect2sphere(p)))))(
        jnp.asarray(off_axis))
    x = t(off_axis).requires_grad_(True)
    torch.sin(tp.equirect2sphere(x)).sum().backward()
    close(x.grad, jg, 1e-5, 1e-5)


def test_lookup_sphe_volume_matches_jax():
    rng = np.random.RandomState(7)
    vol = rng.randn(4, 6, 5, 3).astype(np.float32)
    pts = (rng.randn(50, 3) * 2 + 1).astype(np.float32)

    def j_loss(v, p):
        return jnp.sum(jnp.sin(jp.lookup_sphe_volume(jp.equirect2sphere(p),
                                                     v)))

    want = jp.lookup_sphe_volume(jp.equirect2sphere(jnp.asarray(pts)),
                                 jnp.asarray(vol))
    jgv, jgp = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(vol),
                                                          jnp.asarray(pts))
    v, x = t(vol).requires_grad_(True), t(pts).requires_grad_(True)
    got = tp.lookup_sphe_volume(tp.equirect2sphere(x), v)
    close(got, want)
    torch.sin(got).sum().backward()
    close(v.grad, jgv, 1e-5, 1e-5)
    close(x.grad, jgp, 1e-5, 1e-5)
    const = tp.lookup_sphe_volume(tp.equirect2sphere(x.detach()),
                                  torch.full((4, 6, 5, 3), 2.5))
    close(const, np.full((50, 3), 2.5), atol=1e-5)


def test_clean_volume_matches_jax():
    rng = np.random.RandomState(8)
    cases = []
    m = np.zeros((8, 8, 8), np.float32)
    m[:3, :3, :3] = 1
    m[6:, 6:, 6:] = 1
    cases.append(m)
    d = np.zeros((4, 4, 4), np.float32)
    d[0, 0, 0] = d[1, 1, 1] = 1  # a diagonal touch is connected
    cases += [d, np.zeros((4, 4, 4), np.float32),
              (rng.rand(12, 12, 12) > 0.7).astype(np.float32)]
    for c in cases:
        got, want = clean_volume(c), j_clean_volume(c)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert clean_volume(cases[0]).sum() == 27
    assert clean_volume(cases[1]).sum() == 2


# -- profiling ----------------------------------------------------------------


def test_device_memory_stats_is_none_off_the_card():
    assert profiling.device_memory_stats("cpu") is None
    assert profiling.device_memory_stats(torch.device("cpu")) is None
