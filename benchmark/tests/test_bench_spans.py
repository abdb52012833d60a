"""The readers of the program's spans and counters on the CPU: the tiny
training cell's traced run reads the seven ``.train`` span metrics; the
tiny mesh cell, where nothing is profiled, reads none of the grid's; the
grid readers over a span log; and the device trace names an idle gap by
the program span over it."""

import json
import time
from collections import deque

import pytest
import torch

import run as bench_run
from harness import core
from harness.trace import SLICE, DeviceTrace, _events
from tiny import tiny_cell, tiny_weights

SEED = 2 ** 33 + 5
TRAIN = ("features_ms.train", "aggregate_ms.train", "reg_ms.train",
         "sampler_ms.train", "render_core_ms.train",
         "sampler_live_share.train", "step_enqueue_ms.train")
MESH = ("grid_lookup_ms.mesh", "grid_mlp_ms.mesh", "grid_enqueue_ms.mesh")


def _traced_run(cell, capsys):
    rc = bench_run.run(cell, SEED, 0.5, True, torch.device("cpu"),
                       time.perf_counter(), weights=tiny_weights(cell, SEED))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_cell_reads_each_span_metric(capsys):
    res = _traced_run(tiny_cell("dtu-train", f32=True), capsys)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in TRAIN:
        assert isinstance(m.get(name), float) and m[name] >= 0, name
    assert 0 < m["sampler_live_share.train"] <= 100
    built = m["features_ms.train"] + m["aggregate_ms.train"] \
        + m["reg_ms.train"]
    assert built <= m["build_scene_ms.train"]
    assert m["sampler_ms.train"] + m["render_core_ms.train"] \
        <= m["render_ms.train"]
    assert not set(MESH) & set(m)


def test_mesh_cell_without_a_profile_reads_no_grid_span(capsys):
    res = _traced_run(tiny_cell("bmvs-mesh"), capsys)
    assert res["correct"], res["checks"]
    assert not set(MESH) & set(res["metrics"])


def test_grid_readers_read_each_root_of_the_span_log(monkeypatch):
    from gens_torch.utils import profiling
    from gens_torch.utils.profiling import recording, span

    monkeypatch.setattr(profiling, "_log", deque(maxlen=64))
    with recording():
        for _ in range(2):
            with span("gens/mesh/grid"):
                for _ in range(3):
                    with span("gens/sdf/lookup"):
                        pass
                    with span("gens/sdf/mlp"):
                        pass
                with span("gens/mesh/copy"):
                    pass
            with span("gens/mesh/isosurface"):
                pass
    spans = profiling.records()
    roots = [r for r in spans if r.path == "gens/mesh/grid"]
    cell = core.Cell("bmvs-mesh")
    ctx = {"trace": object()}
    got = {name: cell.reader(name).read(ctx) for name in MESH}

    def per_root(path, clock):
        return sum(getattr(r, clock) for r in spans
                   if r.path == path) / len(roots)

    assert got["grid_lookup_ms.mesh"] == pytest.approx(
        per_root("gens/sdf/lookup", "device_ms"))
    assert got["grid_mlp_ms.mesh"] == pytest.approx(
        per_root("gens/sdf/mlp", "device_ms"))
    assert got["grid_enqueue_ms.mesh"] == pytest.approx(
        per_root("gens/sdf/lookup", "host_ms")
        + per_root("gens/sdf/mlp", "host_ms"))
    assert all(cell.reader(name).read({"trace": None}) is None
               for name in MESH)


def test_idle_gap_is_named_by_the_program_span_over_it():
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from gens_torch.utils.profiling import span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("gens/mesh/isosurface"):
            with record_function(SLICE):
                time.sleep(0.01)
    tr = DeviceTrace(1)
    tr.read_host(_events(prof))
    assert tr.gaps, "no idle gap in a slice with no device work"
    name, seconds = tr.gaps[0]
    assert name.split(" > ")[0] == "gens/mesh/isosurface"
    assert seconds > 0
