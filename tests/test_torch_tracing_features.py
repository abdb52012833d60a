"""The feature nets' spans and counters on the CPU at tiny shapes, for
both backbones (the FPN and MnasNet-1.0): one ``gens/features/encoder``
per copy in the scene build, one ``gens/backward/features`` around the
trained copy's backward (on the thread that runs the backward, after K1's
splats, with every one of the net's gradients accumulated inside it), the
views through each copy counted, and nothing recorded or changed while
the step is not timed."""

import numpy as np
import pytest
import torch

from gens_torch.data.synthetic import SyntheticDataset as TData
from gens_torch.models.gens import GenSModel
from gens_torch.train.step import TrainStep
from gens_torch.utils import profiling

import _torch_common  # noqa: E402,F401  (one torch thread per worker)
from _torch_common import tiny_configs

HW = (64, 64)
N_VIEWS = 5
BACKBONES = ["fpn", "mnasnet"]


def _step(backbone, packed_bilerp="table", seed=0):
    _, cfg = tiny_configs()
    cfg.model.feature_network.backbone = backbone
    cfg.model.volume.packed_bilerp = packed_bilerp
    torch.manual_seed(seed)
    return TrainStep(GenSModel(cfg.model), cfg, 1)


def _batch():
    data = TData(1, N_VIEWS, HW, n_rays=32, n_pseudo_pts=64, mode="train")
    return {k: torch.from_numpy(v) for k, v in data[0].items()
            if isinstance(v, np.ndarray) and v.dtype == np.float32}


def _last_seq():
    got = profiling.records()
    return got[-1].seq if got else 0


@pytest.mark.parametrize("backbone", BACKBONES)
def test_step_has_each_feature_span_once_and_counts_the_views(backbone):
    """Under "pallas" the aggregation's backward is K1's splat (its plain
    version here): the features' backward starts after the last splat
    ends."""
    step = _step(backbone, packed_bilerp="pallas")
    inside = []

    def note(p):
        top = profiling._stack()[-1].path if profiling._stack() else None
        inside.append(top)

    for p in step.model.feature.parameters():
        p.register_post_accumulate_grad_hook(note)
    first = _last_seq()
    m = step(_batch(), 0.5, generator=torch.Generator().manual_seed(1),
             timing=True)
    spans = profiling.records(first)
    enc = [r for r in spans if r.path == "gens/features/encoder"]
    assert len(enc) == 2
    assert all(r.parent.path == "gens/build_scene/features" for r in enc)
    (bwd,) = [r for r in spans if r.path == "gens/backward/features"]
    assert bwd.parent.path == "gens/step/backward"
    assert bwd.thread == bwd.parent.thread  # the CPU backward: the caller's
    splats = [r for r in spans if r.path == "gens/backward/splat"]
    assert splats and max(r.t1 for r in splats) <= bwd.t0
    n_params = len(list(step.model.feature.parameters()))
    assert inside == ["gens/backward/features"] * n_params
    phase = m["phase_ms"]
    assert phase["features/views"] == phase["features/match_views"] \
        == N_VIEWS
    assert phase["features/encoder"] <= phase["build_scene/features"]
    assert phase["backward/features"] <= phase["backward"]
    assert not profiling.enabled()


@pytest.mark.parametrize("backbone", BACKBONES)
def test_untimed_step_records_nothing_and_timing_changes_no_gradient(
        backbone):
    plain, timed = _step(backbone), _step(backbone)
    batch = _batch()
    first = _last_seq()
    plain(batch, 0.5, generator=torch.Generator().manual_seed(1))
    assert _last_seq() == first
    assert profiling.records(first) == []
    timed(batch, 0.5, generator=torch.Generator().manual_seed(1),
          timing=True)
    assert any(r.path == "gens/backward/features"
               for r in profiling.records(first))
    got = dict(timed.model.named_parameters())
    for name, p in plain.model.named_parameters():
        if p.grad is None:
            assert got[name].grad is None, name
        else:
            assert torch.equal(p.grad, got[name].grad), name
            assert torch.equal(p, got[name]), name


def test_frozen_feature_net_opens_no_backward_span():
    """A forward with no gradient to the first layer leaves no hook and
    no span behind."""
    step = _step("mnasnet")
    model = step.model
    model.feature.requires_grad_(False)
    w = model.feature.first_weight
    with profiling.recording() as rec:
        out = model.extract_features(torch.rand(2, 64, 64, 3))
        assert not any(o.requires_grad for o in out)
    assert [r.path for r in rec.records()] == ["gens/features/encoder"]
    assert not w._post_accumulate_grad_hooks
