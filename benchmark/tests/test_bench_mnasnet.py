"""Whole runs of ``mnasnet-train`` on the CPU at a tiny size, past the
look for a card: the sound program comes out correct, traced, with the
backbone's span metrics read; with a fault planted in the program's
backbone (BatchNorm on the batch's statistics in ``train()``, flax's
'SAME' padding on the strided convolutions, the frozen copy left with
weights other than the trained copy's) ``correct`` comes out false."""

import json
import time

import pytest
import torch
import torch.nn.functional as F

import run as bench_run
from tiny import tiny_cell, tiny_weights

SEED = 2 ** 33 + 7
NEW = ("encoder_ms.train", "features_bwd_ms.train",
       "features_ms_per_view.train", "mfu.mnasnet")
# the SDF's offset moved so that rays cross a surface at the tiny size:
# the MFC term, which reads the frozen copy's maps, is then not zero
SURFACE_SHIFT = 1.0


def tiny_mnasnet_weights(cell, seed):
    """``tiny_weights`` for the shared trees; the backbone's as the loop
    draws them."""
    loop = cell.loop()
    w = {k: v for k, v in tiny_weights(cell, seed).items()
         if not k.startswith(("feature.", "match_feature."))}
    w.update(loop.backbone_state(cell, cell.traffic["backbone_seed"]))
    last = cell.reference.GenSPlain(cell.config["config"]["model"]).sdf.n_lin
    w[f"sdf.lin{last - 1}.b"][0] -= SURFACE_SHIFT
    return w


def _run(capsys, trace=False):
    cell = tiny_cell("mnasnet-train", f32=True)
    rc = bench_run.run(cell, SEED, 0.5, trace, torch.device("cpu"),
                       time.perf_counter(),
                       weights=tiny_mnasnet_weights(cell, SEED))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_mnasnet_cell_sound_and_traced(capsys):
    res = _run(capsys, trace=True)
    assert res["correct"], res["checks"]
    c = {k: v["value"] for k, v in res["checks"].items()}
    assert c["features1"] < 1e-5
    for k in ("loss1", "ray_weight1", "ray_weight_last", "change_last"):
        assert c[k] < 1e-4, k
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in NEW:
        assert isinstance(m.get(name), float) and m[name] > 0, name
    assert m["encoder_ms.train"] <= m["features_ms.train"]
    assert m["features_bwd_ms.train"] <= m["backward_ms.train"]
    # 5 views through each copy
    assert m["features_ms_per_view.train"] == pytest.approx(
        m["features_ms.train"] / 10)
    assert "mfu.train" not in m


def _batch_statistics(monkeypatch):
    from gens_torch.models import mnasnet

    def forward(self, x):
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=self.training, eps=mnasnet.BN_EPS)

    monkeypatch.setattr(mnasnet.FrozenBatchNorm2d, "forward", forward)


def _same_padding(monkeypatch):
    from gens_torch.models import mnasnet
    from gens_torch.models.feature_net import same_pad

    orig = mnasnet.ConvBN.forward

    def forward(self, x):
        conv = self.conv
        if conv.stride[0] == 1:
            return orig(self, x)
        k = conv.kernel_size[0]
        ph, pw = same_pad(x.shape[2], k, 2), same_pad(x.shape[3], k, 2)
        y = self.bn(F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])),
                             conv.weight, stride=2, groups=conv.groups))
        return F.relu(y) if self.relu else y

    monkeypatch.setattr(mnasnet.ConvBN, "forward", forward)


def _frozen_copy_not_loaded(monkeypatch):
    """The frozen copy keeps its own initial weights: the state dict's
    ``match_feature`` entries are not loaded."""
    from gens_torch.models.gens import GenSModel

    orig = GenSModel.load_state_dict

    def load(self, state, strict=True):
        return orig(self, {k: v for k, v in state.items()
                           if not k.startswith("match_feature.")},
                    strict=False)

    monkeypatch.setattr(GenSModel, "load_state_dict", load)


@pytest.mark.parametrize("fault,number", [
    (_batch_statistics, "features1"), (_same_padding, "features1"),
    (_frozen_copy_not_loaded, "features1")],
    ids=["batch_statistics", "same_padding", "frozen_copy_not_loaded"])
def test_mnasnet_cell_faults(fault, number, monkeypatch, capsys):
    fault(monkeypatch)
    res = _run(capsys)
    assert not res["correct"], res["checks"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]
