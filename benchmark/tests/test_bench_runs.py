"""Whole runs of both cells on the CPU at a tiny size, past the look for a
card: the sound program comes out correct; with the timed path broken
underneath (a step that leaves its state unchanged, half of the batch
left out with the mean over the rest, an answer altered where it is
made) ``correct`` comes out false. The reference's isosurface against the
program's native one."""

import json
import time

import numpy as np
import pytest
import torch

import run as bench_run
from tiny import tiny_cell, tiny_weights


SEED = 2 ** 33 + 5


def _run(cell, capsys, seconds=0.5):
    rc = bench_run.run(cell, SEED, seconds, False, torch.device("cpu"),
                       time.perf_counter(), weights=tiny_weights(cell, SEED))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_cell_sound(capsys):
    res = _run(tiny_cell("dtu-train", f32=True), capsys)
    assert res["correct"], res["checks"]
    for k in ("loss1", "ray_weight1", "ray_weight_last", "change_last"):
        assert res["checks"][k]["value"] < 1e-4, k
    assert list(res)[-1] == "checks"
    assert {"train_step_ms", "setup_s"} <= set(res["metrics"])


def _half_rays(monkeypatch, after=0):
    from gens_torch.train.step import TrainStep

    orig = TrainStep.__call__
    rays = ("rays_o", "rays_d", "color", "pseudo_depth")
    calls = []

    def half(self, inputs, *a, perturb_noise=None, **kw):
        calls.append(1)
        if len(calls) > after:
            n = inputs["rays_o"].shape[0] // 2
            inputs = {k: (v[:n] if k in rays else v)
                      for k, v in inputs.items()}
            perturb_noise = perturb_noise[:n]
        return orig(self, inputs, *a, perturb_noise=perturb_noise, **kw)

    monkeypatch.setattr(TrainStep, "__call__", half)


def _window_half_rays(monkeypatch):
    """Sound in the set-up's steps, half of the rays left out after them."""
    _half_rays(monkeypatch, after=3)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _window_state_unchanged(monkeypatch):
    """Sound in the set-up's steps, the state left unchanged after them."""
    orig = torch.optim.Adam.step
    calls = []

    def step(self, closure=None):
        calls.append(1)
        if len(calls) <= 3:
            return orig(self, closure)

    monkeypatch.setattr(torch.optim.Adam, "step", step)


def _colour_altered(monkeypatch):
    """Each colour inverted where it is made: the tiny cell's untrained
    colours lie close together, so giving each ray its neighbour's (the
    card's reading of this fault) moves the colour term too little here."""
    from gens_torch.models.renderer import Renderer

    orig = Renderer.render

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        out["color_fine"] = 1.0 - out["color_fine"]
        return out

    monkeypatch.setattr(Renderer, "render", altered)


@pytest.mark.parametrize("fault,number", [
    (_state_unchanged, "change_median"), (_half_rays, "ray_weight1"),
    (_colour_altered, "colour1"), (_window_state_unchanged, "change_last"),
    (_window_half_rays, "ray_weight_last")],
    ids=["state_unchanged", "half_batch", "altered", "window_unchanged",
         "window_half_batch"])
def test_train_cell_faults(fault, number, monkeypatch, capsys):
    fault(monkeypatch)
    res = _run(tiny_cell("dtu-train", f32=True), capsys)
    assert not res["correct"], res["checks"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


def test_mesh_cell_sound(capsys):
    res = _run(tiny_cell("bmvs-mesh"), capsys)
    assert res["correct"], res["checks"]
    assert res["checks"]["mesh_count"]["value"] == 0
    assert {"mesh_scene_s", "setup_s"} <= set(res["metrics"])


def test_mesh_window_cycles_the_pool_and_keeps_two_scenes(capsys):
    cell = tiny_cell("bmvs-mesh")
    cell.traffic["pool"] = 2
    res = _run(cell, capsys, seconds=2.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 2


def _half_grid(monkeypatch):
    import gens_torch.mesh.extract as ex

    orig = ex.eval_sdf_grid

    def half(*a, **kw):
        g = orig(*a, **kw)
        g[g.shape[0] // 2:] = 0.0
        return g

    monkeypatch.setattr(ex, "eval_sdf_grid", half)


def _mesh_altered(monkeypatch):
    import gens_torch.mesh.extract as ex

    orig = ex.grid_to_mesh

    def drop(*a, **kw):
        v, t = orig(*a, **kw)
        return v, t[:-1]

    monkeypatch.setattr(ex, "grid_to_mesh", drop)


def _grid_altered(monkeypatch):
    import gens_torch.mesh.extract as ex

    orig = ex.eval_sdf_grid

    def shift(*a, **kw):
        g = orig(*a, **kw)
        g[:8] += 0.05
        return g

    monkeypatch.setattr(ex, "eval_sdf_grid", shift)


@pytest.mark.parametrize("fault", [_half_grid, _mesh_altered, _grid_altered],
                         ids=["half_batch", "mesh_altered", "grid_altered"])
def test_mesh_cell_faults(fault, monkeypatch, capsys):
    fault(monkeypatch)
    res = _run(tiny_cell("bmvs-mesh"), capsys)
    assert not res["correct"], res["checks"]


def test_reference_isosurface_equals_the_native_one():
    from gens_torch.mesh.extract import grid_to_mesh
    from reference.isosurface import isosurface_stats, mesh_stats

    ax = np.linspace(-1, 1, 40, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    g = (0.5 - np.sqrt(x ** 2 + y ** 2 + (1.3 * z) ** 2)
         + 0.05 * np.sin(7 * x) * np.cos(5 * y)).astype(np.float32)
    g[10:12, 20:22, 5:7] = 0.0
    want = mesh_stats(*grid_to_mesh(g, [-1] * 3, [1] * 3))
    got = isosurface_stats(torch.from_numpy(g), [-1] * 3, [1] * 3)
    assert got["n_tris"] == want["n_tris"] > 0
    assert got["n_verts"] == want["n_verts"]
    assert got["area"] == pytest.approx(want["area"], rel=1e-6)


def test_checkpoint_weights_equal_the_programs_reading():
    """The harness's own reading of the checkpoint file gives both sides
    what the program's converter gives it."""
    from gens_torch.convert import load_checkpoint, params_from_jax
    from harness.core import ROOT
    from harness.weights import checkpoint_state
    import os

    path = os.path.join(ROOT, "artifacts", "quality_gen_r05_sharpen.pkl")
    ours = checkpoint_state(path, "cpu")
    theirs = params_from_jax(load_checkpoint(path)["params"])
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
