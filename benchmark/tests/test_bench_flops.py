"""The operation and byte counts against hand counts at small shapes, and
the trace's busy time as the union of the device intervals."""

import math
import os

import pytest
import torch

from harness import core, flops
from harness.trace import DeviceTrace
from reference.gens_plain import FeatureNetwork, Precision, RegNetwork

K1 = core.load_module(os.path.join(core.BENCH_DIR, "metrics",
                                   "k1_roofline.train.py"))
K3 = core.load_module(os.path.join(core.BENCH_DIR, "metrics",
                                   "k3_roofline.mesh.py"))
SMALL_SDF = {"d_in": 3, "multires": 1, "feat_channels": 2,
             "feat_multires": 0, "d_hidden": 4, "n_layers": 2,
             "skip_in": [], "d_out": 3}


def test_k1_launch_by_hand():
    # C 4, 8 queries of which 5 live, a 2 x 3 map: 4·4·8 + 8·5 + 4·4·6 B,
    # 12·4·5 operations
    got = K1.launch_seconds(4, 8, 5, 2, 3)
    assert got == pytest.approx(max(264 / 3.35e12, 240 / 67e12), rel=1e-12)


def test_k3_launch_by_hand():
    # layers (9, 4), (6, 4), (6, 3): 156 operations a row; bytes: rows of
    # 9 + 2 in and 3 out, 89 weights and biases
    assert flops.sdf_widths(SMALL_SDF) == (9, 2, [(9, 4), (6, 4), (6, 3)])
    got = K3.launch_seconds(SMALL_SDF, 10)
    assert got == pytest.approx(max(916 / 3.35e12, 3 * 1560 / 495e12),
                                rel=1e-12)


def test_sdf_mlp_ops_at_the_published_widths():
    cfg = core.load_json(os.path.join(core.BENCH_DIR, "configs",
                                      "gens-dtu.json"))["config"]
    # (27,128), (228,128), (228,101), (228,128) × 3, (228,129)
    assert flops.sdf_mlp_ops(cfg["model"]["sdf_network"]) == 2 * (
        27 * 128 + 228 * 128 + 228 * 101 + 3 * 228 * 128 + 228 * 129)


def test_reg_net_ops_by_hand():
    cfg = {"d_volume": [2, 2], "d_out": [1, 1], "d_base": 2,
           "use_global_attn": False}
    assert flops.reg_net_ops(cfg, [4, 2]) == 44064


def _counted(module, run):
    """2 · output elements · input channels · taps over every conv."""
    total = []

    def hook(mod, inp, out):
        w = mod.weight
        if isinstance(mod, torch.nn.Module) and w.dim() == 5:
            total.append(2 * out.numel() * w.shape[1] * 27)

    for m in module.modules():
        if hasattr(m, "weight") and isinstance(m.weight, torch.nn.Parameter) \
                and m.weight.dim() == 5:
            m.register_forward_hook(hook)
    run()
    return sum(total)


def test_reg_net_ops_match_the_reference_network():
    cfg = {"d_volume": [8, 8, 8], "d_out": [4, 4, 4], "d_base": 8,
           "use_global_attn": False}
    dims = [16, 8, 4]
    net = RegNetwork(cfg)
    for p in net.parameters():
        torch.nn.init.normal_(p, std=0.1)
    prec = Precision(core.load_json(os.path.join(
        core.BENCH_DIR, "configs", "gens-bmvs.json"))["config"]["model"])
    vols = [torch.randn(d, d, d, 8) for d in dims]
    with torch.no_grad():
        n = _counted(net, lambda: net(vols, prec))
    assert flops.reg_net_ops(cfg, dims) == n


def test_feature_net_ops_match_the_reference_network():
    cfg = {"d_enc": [8, 8, 8, 8, 8], "d_out": [4, 4, 4, 4, 4],
           "backbone": "fpn"}
    net = FeatureNetwork(cfg)
    for p in net.parameters():
        torch.nn.init.normal_(p, std=0.1)
    total = []

    def hook(mod, inp, out):
        w = mod.weight
        if w.dim() == 4 and type(mod).__name__ == "SameConv2d":
            total.append(2 * out.numel() * w.shape[1] * 9)
        elif type(mod).__name__ == "DeconvBlock":
            total.append(2 * inp[0].numel() * w.shape[1] * 9)

    for m in net.modules():
        if type(m).__name__ in ("SameConv2d", "DeconvBlock"):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.rand(2, 64, 96, 3))
    assert flops.feature_net_ops(cfg, 2, (64, 96)) == sum(total)


def test_busy_is_the_union_of_device_intervals():
    dev = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 20},
           {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 20},
           {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 70,
            "dur": 10},
           {"ph": "X", "cat": "kernel", "name": "a", "ts": 95, "dur": 5}]
    tr = DeviceTrace(1)
    tr.read_device(dev + [{"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "ts": 5, "dur": 3}],
                   100e-6)
    assert tr.window_s == pytest.approx(100e-6)
    # [10, 40] + [70, 80] + [95, 100]
    assert tr.busy_s == pytest.approx(45e-6)
    assert tr.kernel_seconds("a") == (pytest.approx(25e-6), 2)
    assert [k for k, _ in tr.breakdown()["device_ops"]] == ["a", "b", "c"]


def test_idle_gaps_are_named_by_the_host():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench/slice",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 70, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 95, "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "aten::x", "ts": 40,
           "dur": 30}]
    tr = DeviceTrace(1)
    tr.read_host(ev)
    gaps = dict(tr.gaps)
    assert gaps["host > aten::x"] == pytest.approx(30e-6)
    assert math.isclose(sum(gaps.values()), 55e-6)
