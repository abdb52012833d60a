"""The port's tracer (``gens_torch/utils/profiling.py``) on the CPU at tiny
shapes: spans nest with their parents' paths, cost nothing while off, take
the open phase as parent on another thread (autograd's backward), reach
the torch profiler's timeline; the training and finetune steps' timed
``phase_ms``; the mesh grid's spans; the launch counters."""

import json
import threading
import tracemalloc
from collections import deque

import numpy as np
import pytest
import torch

from gens_torch.data.synthetic import SyntheticDataset as TData
from gens_torch.mesh.extract import eval_sdf_grid
from gens_torch.models.gens import GenSModel
from gens_torch.ops import gather as gk
from gens_torch.ops import splat as k1
from gens_torch.ops import window_fwd as k2
from gens_torch.train.step import FinetuneStep, TrainStep
from gens_torch.utils import profiling
from gens_torch.utils.profiling import counter, recording, span

import _torch_common  # noqa: E402,F401  (one torch thread per worker)
from _torch_common import tiny_configs

HW = (64, 64)
TRAIN_KEYS = {"build_scene", "render", "backward", "optimizer",
              "build_scene/features", "build_scene/aggregate",
              "build_scene/reg", "render/sampler", "render/core",
              "render/tv", "enqueue",
              "render/sampler/live_share", "features/encoder",
              "backward/features", "features/views", "features/match_views"}


def _paths(spans):
    return [r.path for r in spans]


def test_spans_nest_with_parent_paths():
    with recording() as rec:
        with span("gens/step/render"):
            with span("gens/render/sampler"):
                pass
            with span("gens/render/core"):
                with span("gens/sdf/lookup"):
                    pass
    got = rec.records()
    assert _paths(got) == ["gens/render/sampler", "gens/sdf/lookup",
                           "gens/render/core", "gens/step/render"]
    parents = {r.path: r.parent and r.parent.path for r in got}
    assert parents == {"gens/render/sampler": "gens/step/render",
                       "gens/sdf/lookup": "gens/render/core",
                       "gens/render/core": "gens/step/render",
                       "gens/step/render": None}
    assert all(r.root.path == "gens/step/render" for r in got)
    assert [r.seq for r in got] == sorted(r.seq for r in got)
    for r in got:
        assert r.thread == threading.get_ident()
        assert r.t1 >= r.t0 and r.host_ms >= 0
        # no CUDA here: the device clock is the host's
        assert r.device_ms == r.host_ms
    assert not profiling.enabled()


def test_off_span_is_one_shared_object_and_records_nothing():
    assert not profiling.enabled()
    before = len(profiling.records())
    a, b = span("gens/step/render"), span("gens/render/core")
    assert a is b
    with a:
        with b:
            pass
    with recording(on=False) as rec:
        with span("gens/render/sampler"):
            pass
    assert not profiling.enabled()
    assert len(profiling.records()) == before and rec.records() == []


def test_off_span_allocates_nothing():
    """10,000 spans while off hold no memory afterwards and raise the
    traced peak no higher than the same loop around the shared no-op
    object itself does."""
    def spans(n):
        for _ in range(n):
            with span("gens/sdf/lookup"):
                pass

    def bare(n):
        for _ in range(n):
            with profiling._OFF:
                pass

    spans(10)
    bare(10)
    grown = {}
    tracemalloc.start()
    try:
        for loop in (bare, spans):
            tracemalloc.reset_peak()
            base = tracemalloc.get_traced_memory()[0]
            loop(10000)
            current, peak = tracemalloc.get_traced_memory()
            grown[loop.__name__] = (current - base, peak - base)
    finally:
        tracemalloc.stop()
    assert grown["spans"][0] == 0
    assert grown["spans"][1] <= grown["bare"][1]


def test_span_in_autograd_backward_takes_the_phase_as_parent():
    """K1's span opens inside the aggregation's backward: its parent is
    the step's backward phase (on the card autograd runs it on its own
    thread; here on the caller's)."""
    image = torch.rand((8, 8, 4), requires_grad=True)
    xy = torch.rand((16, 2)) * 7
    with recording() as rec:
        with span("gens/step/render"):
            out = k1.bilerp_agg_splat(image, xy, "float32", "kernel2")
        with span("gens/step/backward"):
            out.sum().backward()
    (splat,) = [r for r in rec.records() if r.path == "gens/backward/splat"]
    assert splat.parent.path == "gens/step/backward"
    assert image.grad is not None


def test_span_on_another_thread_takes_the_open_phase():
    got = {}

    def work():
        with span("gens/backward/splat") as s:
            got["span"] = s

    with recording() as rec:
        with span("gens/step/backward") as phase:
            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    s = got["span"]
    assert s.parent is phase and s.thread != phase.thread
    assert _paths(rec.records()) == ["gens/backward/splat",
                                     "gens/step/backward"]


def test_profiler_turns_spans_on_and_puts_each_path_on_its_timeline(
        tmp_path):
    from torch.profiler import ProfilerActivity, profile

    first = profiling.records()[-1].seq if profiling.records() else 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        with span("gens/mesh/grid"):
            with span("gens/sdf/lookup"):
                torch.ones(8).sum()
            with span("gens/mesh/copy"):
                torch.ones(8).numpy()
    assert not profiling.enabled()
    assert _paths(profiling.records(first)) == [
        "gens/sdf/lookup", "gens/mesh/copy", "gens/mesh/grid"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events
             if e.get("cat") == "user_annotation"}
    assert {"gens/mesh/grid", "gens/sdf/lookup", "gens/mesh/copy"} <= names


def test_log_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_log", deque(maxlen=4))
    with recording() as rec:
        for i in range(10):
            with span(f"gens/step/p{i}"):
                pass
    assert _paths(profiling.records()) == [f"gens/step/p{i}"
                                           for i in range(6, 10)]
    assert _paths(rec.records()) == _paths(profiling.records())


def test_span_ms_keys_phases_and_children():
    with recording() as rec:
        with span("gens/step/backward"):
            for _ in range(3):
                with span("gens/backward/splat"):
                    pass
        with span("gens/mesh/grid"):
            pass
    got = profiling.span_ms(rec.records())
    assert set(got) == {"backward", "backward/splat", "mesh/grid"}
    splats = [r.device_ms for r in rec.records()
              if r.path == "gens/backward/splat"]
    assert got["backward/splat"] == pytest.approx(sum(splats))
    assert all(v >= 0 for v in got.values())


def test_device_counts_wait_until_read():
    name = "test.device_count"
    base = counter(name)
    profiling.count(name, torch.tensor(3))
    profiling.count(name, (torch.arange(10) > 6).sum())
    profiling.count(name, 2)
    assert len(profiling._pending[name]) == 2
    assert counter(name) == base + 8
    assert profiling._pending[name] == []
    assert counter(name) == base + 8


@pytest.mark.parametrize("name,call", [
    ("k1.launches", lambda: k1.splat_bilinear(
        torch.rand((16, 2)) * 7, torch.rand((16, 4)), (8, 8))),
    ("k2.launches", lambda: k2.bilerp_window_fwd(
        torch.rand((8, 8, 4)), torch.rand((16, 2)) * 7)),
    ("p1.launches", lambda: gk.row_gather_take(
        torch.rand((9, 4)), torch.arange(9, dtype=torch.int32))),
    ("p2.launches", lambda: gk.row_gather_take_along(
        torch.rand((9, 4)), torch.arange(9, dtype=torch.int32))),
    ("p3.launches", lambda: gk.onehot_gather(
        torch.rand((9, 4)), torch.arange(9, dtype=torch.int32))),
], ids=["k1", "k2", "p1", "p2", "p3"])
def test_plain_versions_count_no_launch(name, call):
    """A kernel's counter counts its launches (one per call on the card,
    ``tests/test_torch_cuda.py``); the plain versions on the CPU count
    none."""
    before = counter(name)
    call()
    assert counter(name) == before


def _model(seed=0, packed_bilerp="table"):
    _, cfg = tiny_configs()
    cfg.model.volume.packed_bilerp = packed_bilerp
    torch.manual_seed(seed)
    return cfg, GenSModel(cfg.model)


def _train_batch():
    data = TData(1, 3, HW, n_rays=32, n_pseudo_pts=64, mode="train")
    return {k: torch.from_numpy(v) for k, v in data[0].items()
            if isinstance(v, np.ndarray) and v.dtype == np.float32}


@pytest.mark.parametrize("packed_bilerp", ["table", "pallas"])
def test_train_step_timing_returns_each_phase_and_span(packed_bilerp):
    """Under "pallas" the aggregation's backward is the splat (K1's plain
    version here), whose spans add ``backward/splat``."""
    cfg, model = _model(packed_bilerp=packed_bilerp)
    step = TrainStep(model, cfg, 1)
    batch = _train_batch()
    plain = step(batch, 0.5, generator=torch.Generator().manual_seed(0))
    assert "phase_ms" not in plain
    first = profiling.records()[-1].seq if profiling.records() else 0
    m = step(batch, 0.5, generator=torch.Generator().manual_seed(1),
             timing=True)
    phase = m.pop("phase_ms")
    splat = {"backward/splat"} if packed_bilerp == "pallas" else set()
    assert set(phase) == TRAIN_KEYS | splat, sorted(phase)
    assert all(isinstance(v, float) and v >= 0 for v in phase.values())
    assert 0 < phase["render/sampler/live_share"] <= 100
    assert phase["enqueue"] >= phase["build_scene"]
    assert (phase["build_scene/features"] + phase["build_scene/aggregate"]
            + phase["build_scene/reg"]) <= phase["build_scene"]
    assert phase["render/sampler"] + phase["render/core"] <= phase["render"]
    assert all(torch.is_tensor(v) for v in m.values())
    spans = profiling.records(first)
    roots = [r.path for r in spans if r.parent is None]
    assert roots == ["gens/step/build_scene", "gens/step/render",
                     "gens/step/backward", "gens/step/optimizer"]
    assert all(r.parent.path == "gens/step/backward" for r in spans
               if r.path == "gens/backward/splat")
    assert not profiling.enabled()


def _finetune_step():
    cfg, model = _model()
    images = TData(1, 3, HW, mode="finetune").get_all_images()
    vols, masks, feats = model.init_volumes(
        *[torch.from_numpy(images[k]) for k in ("imgs", "intrs", "c2ws")])
    raw = TData(1, 3, HW, n_rays=32, mode="finetune").get_random_rays(1)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()
             if isinstance(v, np.ndarray) and v.dtype == np.float32}
    batch["view_ids"] = torch.from_numpy(np.asarray(raw["view_ids"]))
    return model, FinetuneStep(model, cfg, vols, masks, feats), batch


def test_finetune_step_timing_returns_its_three_phases():
    _, step, batch = _finetune_step()
    m = step(batch, 0.5, generator=torch.Generator().manual_seed(0),
             timing=True)
    phase = m["phase_ms"]
    assert set(phase) == {"render", "backward", "optimizer",
                          "render/sampler", "render/core", "render/tv",
                          "enqueue", "render/sampler/live_share"}, \
        sorted(phase)
    assert all(isinstance(v, float) and v >= 0 for v in phase.values())
    assert 0 < phase["render/sampler/live_share"] <= 100


def test_finetune_step_records_tv_inside_the_render_core():
    """The TV term's span, once a step, inside the render core."""
    _, step, batch = _finetune_step()
    first = profiling.records()[-1].seq if profiling.records() else 0
    step(batch, 0.5, generator=torch.Generator().manual_seed(0),
         timing=True)
    tv = [r for r in profiling.records(first) if r.path == "gens/render/tv"]
    assert [r.parent.path for r in tv] == ["gens/render/core"]
    assert tv[0].t0 <= tv[0].t1
    assert not profiling.enabled()


def test_finetune_step_spans_change_nothing():
    """A recorded step and one with spans off, from the same state, give
    the same metrics, gradients and updated volumes bit for bit."""
    got = []
    for timing in (True, False):
        model, step, batch = _finetune_step()
        m = step(batch, 0.5, generator=torch.Generator().manual_seed(0),
                 timing=timing)
        m.pop("phase_ms", None)
        got.append((m, [v.grad for v in step.volumes],
                    [v.detach() for v in step.volumes],
                    [p.grad for p in model.sdf.parameters()]))
    (m1, g1, v1, s1), (m0, g0, v0, s0) = got
    assert m1.keys() == m0.keys()
    assert all(torch.equal(m1[k], m0[k]) for k in m0)
    for a, b in zip(g1 + v1 + s1, g0 + v0 + s0):
        assert torch.equal(a, b)


def test_mesh_grid_leaves_one_root_with_its_children():
    cfg, model = _model()
    model.eval()
    images = TData(1, 3, HW, mode="finetune").get_all_images()
    with torch.no_grad():
        scene = model.build_scene(*[torch.from_numpy(images[k])
                                    for k in ("imgs", "intrs", "c2ws")])
    sdf_fn = model.renderer.sdf_fn_for_extraction(scene.volumes)
    k3_before = counter("k3.launches")
    with recording() as rec:
        grid = eval_sdf_grid(sdf_fn, [-1] * 3, [1] * 3, 16, "cpu", block=8)
    assert counter("k3.launches") == k3_before  # CPU: the plain MLP
    assert grid.shape == (16, 16, 16)
    spans = rec.records()
    roots = [r for r in spans if r.parent is None]
    assert _paths(roots) == ["gens/mesh/grid"]
    (root,) = roots
    kids = [r for r in spans if r is not root]
    assert all(r.parent is root for r in kids)
    # 2 slabs of 8 x 16 x 16 points, 4 chunks of 8³ each; a grid evaluated
    # on the CPU is written in place, so no slab is copied
    assert sorted(_paths(kids)) == sorted(
        ["gens/sdf/lookup"] * 8 + ["gens/sdf/mlp"] * 8)
