"""The options of gens_tpu's model in the port, all four at once, against
the JAX package on the CPU at tiny_config sizes: the MnasNet backbone with
BN statistics away from their init, the adaptive aggregation (d_volume = C),
GlobalAttn at the U-Net bottleneck and the idr colour head. One training
forward and backward (every loss term, every module's gradient), the
parameter bridge both ways with the BN buffers, the one-shot volume build,
and the refusal of the adaptive aggregation under the view axis."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gens_tpu.losses as jl
from gens_tpu.data.synthetic import SyntheticDataset as JData
from gens_tpu.models.gens import GenSModel as JGenSModel
from gens_torch import losses as tl
from gens_torch.convert import params_from_jax, params_to_jax
from gens_torch.main import main
from gens_torch.models.gens import GenSModel as TGenSModel

from _torch_common import t, tiny_configs, to_np_tree
from test_cli import _tiny_overrides


def options_configs():
    """tiny_config with every option of the model switched on, on a
    3-scale cascade (32³, 16³, 8³): the U-Net's bottleneck is then 4³, so
    GlobalAttn attends over 64 voxels (tiny_config's 5 scales leave one,
    where the attention weights are constant), and the JAX trace and
    compile are shorter."""
    jcfg, tcfg = tiny_configs()
    for c in (jcfg, tcfg):
        m = c.model
        m.feature_network.backbone = "mnasnet"
        m.volume.agg = "adaptive"
        m.volume.volume_dims = (32, 16, 8)
        m.reg_network.d_volume = (4,) * 3  # adaptive emits C channels
        m.reg_network.d_out = (4,) * 3
        m.reg_network.use_global_attn = True
        m.sdf_network.feat_channels = 12
        m.color_network.head = "idr"
        m.color_network.idr_d_hidden = 32
        m.color_network.idr_n_layers = 2
        m.render.perturb = 0.0
        m.render.up_sample_steps = 1
    return jcfg, tcfg


def seeded_model(tcfg, seed=0):
    """The port's fresh model with its BN running statistics moved off
    (0, 1), as a pretrained encoder's are (a swapped mean / var, or a BN
    in batch mode, would show), the matching copy synced."""
    torch.manual_seed(seed)
    tm = TGenSModel(tcfg.model)
    with torch.no_grad():
        for name, buf in tm.feature.named_buffers():
            if name.endswith("running_mean"):
                buf.uniform_(-0.3, 0.3)
            else:
                buf.uniform_(0.5, 2.0)
    tm.match_feature.load_state_dict(tm.feature.state_dict())
    return tm


# per module: ||g_port - g_jax|| / ||g_jax||, test_torch_train.GRAD_TOL's
# limits, and the agg score MLPs'
GRAD_TOL = {"sdf": 1e-3, "blending": 1e-3, "variance": 1e-3,
            "feature": 2e-2, "agg": 2e-2, "reg": 5e-2}


@pytest.fixture(scope="module")
def options_step():
    """Both packages' losses and gradients on the same params, batch and
    draws: jax.grad of forward_train + compute_losses (one compile), the
    port's forward_train + compute_losses and backward."""
    jcfg, tcfg = options_configs()
    jm = JGenSModel(jcfg.model)
    # both start from the port's init, carried to JAX by params_to_jax
    # (flax's apply checks every parameter's name and shape)
    tm = seeded_model(tcfg)
    params = params_to_jax(tm.state_dict())
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

    def jax_side(p):
        # one compile: the gradient and the one-shot volume build
        return (jax.grad(loss_fn, has_aux=True)(p),
                jm.init_volumes(p, ji_["imgs"], ji_["intrs"], ji_["c2ws"]))

    (grads, jlosses), jvolumes = jax.jit(jax_side)(
        jax.tree.map(jnp.asarray, params))

    tm.train()  # the BN must keep its running statistics
    tin = {k: t(v) for k, v in item.items()}
    losses = tl.compute_losses(
        tm.forward_train(tin, anneal, False, sparse_pts=t(np.asarray(sparse))),
        tin, tcfg.train.loss)
    losses["loss"].backward()
    return {"jlosses": jlosses, "losses": losses, "tm": tm,
            "jgrads": params_from_jax(to_np_tree(grads)),
            "jvolumes": jvolumes, "item": item}


def test_all_options_losses_match_jax(options_step):
    jlosses, losses = options_step["jlosses"], options_step["losses"]
    assert set(jlosses) <= set(losses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(losses[k].detach()), float(v),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert float(losses["color_loss"].detach()) > 0


def test_all_options_grads_match_jax(options_step):
    tm, jg = options_step["tm"], options_step["jgrads"]
    groups = {}
    for name, p in tm.named_parameters():
        top = name.split(".")[0]
        if top == "match_feature":
            assert p.grad is None
            continue
        # the heads of the two scales past the cascade feed nothing
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert p.grad is not None or re.fullmatch(
            r"feature\.out_layer[45]\.weight", name), name
        a, b = groups.setdefault(top, ([], []))
        a.append(jg[name].reshape(-1))
        b.append(g.reshape(-1))
    assert set(groups) == set(GRAD_TOL)
    for top, (a, b) in groups.items():
        a, b = torch.cat(a), torch.cat(b)
        assert float(a.norm()) > 0, top
        err = float((a - b).norm() / a.norm())
        assert err <= GRAD_TOL[top], (top, err)
    # GlobalAttn and the idr head are on the path, the BN stats are not
    # parameters (no optimizer sees them)
    names = dict(tm.named_parameters())
    assert float(names["reg.global_attn.value.weight"].grad.abs().max()) > 0
    assert not any("running_" in n for n in names)


def test_all_options_params_round_trip(options_step):
    """params_from_jax(params_to_jax(state)) is the port's state, BN
    buffers and every option's subtree included, and the JAX tree it goes
    through holds the layout of each option."""
    tstate = options_step["tm"].state_dict()
    params = params_to_jax(tstate)
    again = params_from_jax(params)
    assert set(again) == set(tstate)
    for k, v in tstate.items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)
    keys = {jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    for part in ("['agg']['params']['agg_mlp_2_out']['kernel']",
                 "['reg']['params']['GlobalAttn_0']['norm2']['scale']",
                 "['feature']['batch_stats']['encoder']['stack6']['block0']"
                 "['project']['bn']['var']",
                 "['match_feature']['params']['out_layer5']['kernel']",
                 "['feature']['params']['decod_layer1']['ConvTranspose_0']",
                 "['blending']['params']['lin2']['g']"):
        assert any(k.startswith(part) for k in keys), part
    assert len(keys) == len(tstate)


def test_init_volumes_under_adaptive(options_step):
    """The one-shot volume build of the finetune regime through the
    adaptive aggregation: volumes, masks and features equal to JAX's."""
    item, jout = options_step["item"], options_step["jvolumes"]
    args = [item[k] for k in ("imgs", "intrs", "c2ws")]
    tm = options_step["tm"]
    vols, masks, feats = tm.init_volumes(*[t(a) for a in args])
    assert len(vols) == len(masks) == 3 and len(feats) == 5
    for m, jm_ in zip(masks, jout[1]):
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm_))
    # the U-Net's f32 sums in another order: within 1e-4 of max |JAX|
    for a, b in list(zip(jout[0], vols)) + list(zip(jout[2], feats)):
        a = np.asarray(a)
        assert b.shape == a.shape
        assert np.abs(b.numpy() - a).max() <= 1e-4 * np.abs(a).max()
    assert vols[0].shape == (32, 32, 32, tm.cfg.reg_network.d_out[0])


def test_adaptive_is_refused_under_the_view_axis(tmp_path, monkeypatch):
    """volume.agg: adaptive with parallel.view=2 raises before a training
    step is built (the JAX aggregation has no view axis)."""
    import gens_torch.runner as runner_mod

    def no_step(*a, **k):
        raise AssertionError("a training step was built")

    monkeypatch.setattr(runner_mod, "TrainStep", no_step)
    monkeypatch.setattr(runner_mod, "ShardedTrainStep", no_step)
    argv = (["--mode", "train", "--device", "cpu", "--set",
             "parallel.view=2", "model.volume.agg=adaptive",
             "model.reg_network.d_volume=[4,4,4,4,4]"]
            + _tiny_overrides(str(tmp_path)))
    with pytest.raises(ValueError, match="adaptive.*no view axis"):
        main(argv)


def test_options_train_then_finetune_through_main(tmp_path):
    """``python -m gens_torch.main --device cpu`` with every option: the
    MnasNet backbone (its encoder from a ``pretrained_path`` pickle in the
    layout of scripts/convert_mnasnet_weights.py), the adaptive
    aggregation, GlobalAttn and the idr head. ``--mode train`` runs its
    steps, keeps the pickle's BN statistics and writes a checkpoint
    (params and batch_stats in the JAX layout) that loads back into a
    fresh model equal to the trained one; ``--mode finetune`` from it
    builds the volumes once through the adaptive aggregation and trains
    them with the idr head."""
    import pickle

    from gens_torch.convert import load_params
    from gens_torch.models.mnasnet import convert_torch_mnasnet
    from test_mnasnet_parity import MnasNetOracle

    torch.manual_seed(0)
    tree = convert_torch_mnasnet(
        {k: v.numpy() for k, v in MnasNetOracle().state_dict().items()})
    path = str(tmp_path / "mnasnet_encoder.pkl")
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    options = ["model.feature_network.backbone=mnasnet",
               f"model.feature_network.pretrained_path={path}",
               "model.volume.agg=adaptive",
               "model.reg_network.d_volume=[4,4,4,4,4]",
               "model.reg_network.use_global_attn=true",
               "model.color_network.head=idr",
               "model.color_network.idr_d_hidden=32"]
    runner = main(["--mode", "train", "--device", "cpu", "--set"] + options
                  + _tiny_overrides(str(tmp_path)))
    assert [s["step"] for s in runner.train_stats] == [1, 2]
    assert all(np.isfinite(s["loss"]) for s in runner.train_stats)
    got = runner.model.feature.encoder.state_dict()
    np.testing.assert_array_equal(
        got["stack2.block1.depthwise.bn.running_var"].numpy(),
        tree["batch_stats"]["stack2"]["block1"]["depthwise"]["bn"]["var"])
    ckpt = str(tmp_path / "checkpoints" / "model_000.ckpt")
    fresh = TGenSModel(runner.cfg.model)
    load_params(fresh, ckpt)
    for k, v in runner.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    ft = main(["--mode", "finetune", "--device", "cpu", "--resume", ckpt,
               "--scene", "s0", "--ref_view", "4", "--set",
               f"base_exp_dir={tmp_path / 'ft'}", "train.epochs=2",
               "finetune_dataset.dataset_name=synthetic",
               "finetune_dataset.num_src_view=2",
               "finetune_dataset.img_hw=[64,64]",
               "finetune_dataset.n_rays=32",
               "finetune_dataset.val_res_level=4", "mesh_resolution=32",
               "train.save_freq=100", "train.val_freq=100"] + options
              + [o for o in _tiny_overrides(str(tmp_path))
                 if o.startswith("model.")])
    steps = [st for st in ft.finetune_stats if "loss" in st]
    assert len(steps) == 2 and all(np.isfinite(st["loss"]) for st in steps)
    assert [v.shape[-1] for v in ft.ft_step.volumes] == [4] * 5
