"""The parts of ``mnasnet-train`` on the CPU: the program's MnasNet-1.0
FPN against the plain reference on the loop's seeded weights, forward and
parameter gradients; the operation count against a forward-hook count of
the reference's convolutions at the published image sizes; the new span
readers on a program without the spans."""

import os

import pytest
import torch

from harness import core, flops_mnasnet
from reference import gens_plain_mnasnet as R
from reference.gens_plain import DeconvBlock, SameConv2d

CELL = core.Cell("mnasnet-train")
LOOP = CELL.loop()
FC = CELL.config["config"]["model"]["feature_network"]


def _nets():
    from gens_torch.config import FeatureNetConfig
    from gens_torch.models.mnasnet import MnasNetFeatureNetwork

    state = {k[len("feature."):]: v for k, v in LOOP.backbone_state(
        CELL, CELL.traffic["backbone_seed"]).items()
        if k.startswith("feature.")}
    prog = MnasNetFeatureNetwork(FeatureNetConfig(**FC))
    ref = R.MnasNetFeatureNetwork(FC)
    for net in (prog, ref):
        net.load_state_dict(state, strict=True)
        net.train()
    return prog, ref


def test_program_backbone_equals_the_reference_forward_and_gradients():
    prog, ref = _nets()
    gen = torch.Generator().manual_seed(3)
    imgs = torch.rand((2, 64, 96, 3), generator=gen)
    got, want = prog(imgs), ref(imgs)
    assert [tuple(g.shape) for g in got] == [
        (2, 64 >> i, 96 >> i, 4) for i in range(5)]
    cots = [torch.randn(w.shape, generator=gen) for w in want]
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-5), \
            float((g - w).abs().max())
    sum((g * c).sum() for g, c in zip(got, cots)).backward()
    sum((w * c).sum() for w, c in zip(want, cots)).backward()
    pg = dict(prog.named_parameters())
    assert pg.keys() == dict(ref.named_parameters()).keys()
    for name, p in ref.named_parameters():
        gap = torch.linalg.norm(pg[name].grad - p.grad) \
            / torch.linalg.norm(p.grad)
        assert gap < 1e-4, (name, float(gap))
    # frozen statistics: no forward moves them
    for name, b in prog.named_buffers():
        assert torch.equal(b, dict(ref.named_buffers())[name]), name


def _hook_macs(hw):
    net = R.MnasNetFeatureNetwork(FC)
    for p in net.parameters():
        torch.nn.init.normal_(p, std=0.1)
    for name, b in net.named_buffers():
        b.fill_(1.0 if name.endswith("var") else 0.0)
    total = []

    def hook(mod, inp, out):
        x = inp[0]
        if isinstance(mod, R.ConvBN):
            w = mod.conv.weight
            h = -(-x.shape[2] // mod.stride)
            wd = -(-x.shape[3] // mod.stride)
            total.append(h * wd * w.shape[0] * w.shape[1] * w.shape[2]
                         * w.shape[3])
        elif isinstance(mod, DeconvBlock):
            total.append(x.numel() * 9 * mod.weight.shape[1])
        elif isinstance(mod, SameConv2d):
            total.append(out.numel() * mod.weight.shape[1] * 9)

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (R.ConvBN, DeconvBlock, SameConv2d))]
    with torch.no_grad():
        net(torch.zeros((1,) + tuple(hw) + (3,)))
    for h in hooks:
        h.remove()
    return sum(total)


@pytest.mark.parametrize("hw,gmacs", [((480, 640), 2.2754),
                                      ((576, 768), 3.2765)])
def test_ops_equal_a_hook_count_of_the_reference(hw, gmacs):
    got = flops_mnasnet.mnasnet_feature_macs(FC["d_out"], hw)
    assert got == _hook_macs(hw)
    assert got / 1e9 == pytest.approx(gmacs, abs=5e-5)
    assert flops_mnasnet.mnasnet_feature_ops(FC["d_out"], 5, hw) \
        == 2 * 5 * got


def test_step_least_time_swaps_the_feature_ops():
    from harness import flops

    model = CELL.config["config"]["model"]
    args = (5, (480, 640), 512, 1024, 2048)
    swap = 4 * 5 * 2 * (flops_mnasnet.mnasnet_feature_macs(
        model["feature_network"]["d_out"], (480, 640))) \
        - 4 * flops.feature_net_ops(model["feature_network"], 5, (480, 640))
    assert flops_mnasnet.train_step_min_seconds(model, *args) \
        == pytest.approx(flops.train_step_min_seconds(model, *args)
                         + swap / flops.PEAK["float32"], rel=1e-12)


@pytest.mark.parametrize("name", ["encoder_ms.train",
                                  "features_bwd_ms.train",
                                  "features_ms_per_view.train"])
def test_new_span_readers_read_none_without_their_spans(name):
    """A program without the backbone's spans and counters (the phase
    keys of the steps before them) reads none; with them, the mean."""
    reader = CELL.reader(name)
    old = [{"build_scene/features": 11.0, "backward": 250.0}] * 3
    assert reader.read({"phase_ms": old}) is None
    assert reader.read({}) is None
    new = [dict(p, **{"features/encoder": 4.0 + i,
                      "backward/features": 20.0 + i,
                      "features/views": 5.0, "features/match_views": 5.0})
           for i, p in enumerate(old)]
    want = {"encoder_ms.train": 5.0, "features_bwd_ms.train": 21.0,
            "features_ms_per_view.train": 1.1}[name]
    assert reader.read({"phase_ms": new}) == pytest.approx(want)


def test_mfu_mnasnet_reads_the_step():
    ctx = {"model": CELL.config["config"]["model"],
           "dims": LOOP.dims(CELL), "step_s": 1.0}
    got = CELL.reader("mfu.mnasnet").read(ctx)
    d = ctx["dims"]
    assert got == pytest.approx(100.0 * flops_mnasnet.train_step_min_seconds(
        ctx["model"], d["n_views"], d["hw"], d["n_rays"], d["n_sparse"],
        d["n_pseudo"]))
    assert CELL.reader("mfu.mnasnet").read({}) is None


def test_configuration_is_dtu_with_the_published_backbone():
    dtu = core.load_json(os.path.join(core.BENCH_DIR, "configs",
                                      "gens-dtu.json"))
    mine = CELL.config
    assert mine["weights"] == dtu["weights"]
    assert mine["config"]["model"]["feature_network"]["backbone"] \
        == "mnasnet"
    a, b = dict(mine["config"]), dict(dtu["config"])
    a["model"] = dict(a["model"], feature_network=None)
    b["model"] = dict(b["model"], feature_network=None)
    assert a == b
    t = core.load_json(os.path.join(core.BENCH_DIR, "traffic",
                                    "train_steps.json"))
    mix = dict(CELL.traffic)
    assert mix.pop("loop") == "train_mnasnet" and t.pop("loop") == "train"
    assert isinstance(mix.pop("backbone_seed"), int)
    assert mix == t
