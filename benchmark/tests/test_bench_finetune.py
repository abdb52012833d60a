"""``finetune-train`` on the CPU at a tiny size, past the look for a card:
the program's finetune step against the plain finetune reference leaf by
leaf; the sound program comes out correct, traced, with the finetune's
span metrics read; with a fault planted in the program (the volumes'
rates reversed, one level's volume gradient dropped, each colour altered
where it is made, the loss over half of the rays, one level's initial
volume altered in the build) ``correct`` comes out false."""

import dataclasses
import json
import time

import pytest
import torch

import run as bench_run
from tiny import tiny_cell, tiny_weights

SEED = 2 ** 33 + 11
NEW = ("tv_ms.finetune", "adam_roofline.finetune", "mfu.finetune")


def tiny_finetune_cell():
    """``tiny_cell``'s cut, and the finetune dataset's: 64x64 views, 64
    rays, 32 pseudo points."""
    cell = tiny_cell("finetune-train")
    cell.config["config"]["finetune_dataset"].update(
        img_hw=[64, 64], n_rays=64, n_pseudo_pts=32)
    return cell


def _run(capsys, trace=False):
    cell = tiny_finetune_cell()
    rc = bench_run.run(cell, SEED, 0.5, trace, torch.device("cpu"),
                       time.perf_counter(), weights=tiny_weights(cell, 3))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _gap(a, b):
    return float(torch.linalg.norm((a - b).double())
                 / torch.linalg.norm(b.double()))


def test_finetune_step_matches_the_reference():
    """The initial leaves of the program's build and the reference's;
    loss, colour term, each volume's first gradient and each volume's
    change over the first three steps under ``lr_vol``, to float32
    rounding."""
    cell = tiny_finetune_cell()
    loop = cell.loop()
    st = loop.setup(cell, SEED, torch.device("cpu"), tiny_weights(cell, 3))
    assert st.build < 1e-6
    ref = loop.reference_steps(cell, st.init, st.leaves0, st.views, st.vids,
                               SEED, st.device)
    assert sorted(st.vids) == [0, 1, 2]   # one cycle of the views
    assert st.losses == pytest.approx(ref["losses"], rel=1e-6)
    assert st.terms1["color_loss"] == pytest.approx(
        ref["terms1"]["color_loss"], rel=1e-6)
    for i, v0 in enumerate(st.leaves0["volumes"]):
        n = f"vol{i}"
        assert torch.linalg.norm(ref["first_grad"][n]) > 0, n
        assert _gap(st.first_grad[n], ref["first_grad"][n]) < 1e-6, n
        assert _gap(st.after[n] - v0, ref["after"][n] - v0) < 1e-4, n
    loop.free(st)


def test_finetune_cell_sound_and_traced(capsys):
    res = _run(capsys, trace=True)
    assert res["correct"], res["checks"]
    c = {k: v["value"] for k, v in res["checks"].items()}
    for k in ("build", "loss1", "ray_weight1", "vol_grad1",
              "ray_weight_last", "change_last"):
        assert c[k] < 1e-6, k
    assert c["vol_change_last"] < 1e-4
    assert list(res)[-1] == "checks"
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in NEW + ("render_ms.train", "backward_ms.train",
                       "optimizer_ms.train", "sampler_ms.train",
                       "render_core_ms.train", "step_enqueue_ms.train"):
        assert isinstance(m.get(name), float) and m[name] > 0, name
    assert m["tv_ms.finetune"] <= m["render_core_ms.train"]
    assert 0 < m["adam_roofline.finetune"] <= 100
    assert "mfu.train" not in m and "k1_roofline.train" not in m


def test_finetune_cell_end_to_end(capsys):
    res = _run(capsys)
    assert res["correct"], res["checks"]
    assert {"train_step_ms", "setup_s"} <= set(res["metrics"])
    assert res["attempted"] >= 1 and res["failed"] == 0


def _lr_vol_reversed(monkeypatch):
    from gens_torch.train import step

    orig = step.make_finetune_optimizer

    def reversed_rates(model, volumes, tcfg):
        return orig(model, volumes, dataclasses.replace(
            tcfg, lr_vol=tuple(tcfg.lr_vol)[::-1]))

    monkeypatch.setattr(step, "make_finetune_optimizer", reversed_rates)


def _volume_grad_dropped(monkeypatch):
    """The finest volume read through a detached copy: no gradient."""
    from gens_torch.models.gens import GenSModel

    orig = GenSModel.forward_finetune

    def dropped(self, volumes, *a, **kw):
        return orig(self, [volumes[0].detach()] + list(volumes[1:]), *a,
                    **kw)

    monkeypatch.setattr(GenSModel, "forward_finetune", dropped)


def _colour_altered(monkeypatch):
    """Each colour inverted where it is made: the tiny cell's untrained
    colours lie close together, so giving each ray its neighbour's (the
    card's reading of this fault, ``control_finetune.py``) moves the
    colour term too little here."""
    from gens_torch.models.renderer import Renderer

    orig = Renderer.render

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        out["color_fine"] = 1.0 - out["color_fine"]
        return out

    monkeypatch.setattr(Renderer, "render", altered)


RAY_KEYS = ("rays_o", "rays_d", "color", "pseudo_depth")


def _half_batch(monkeypatch):
    """The step's loss over the first half of its rays alone."""
    from gens_torch.train.step import FinetuneStep

    orig = FinetuneStep.__call__

    def half(self, inputs, *a, perturb_noise=None, **kw):
        n = len(inputs["rays_o"]) // 2
        inputs = {k: v[:n] if k in RAY_KEYS else v for k, v in inputs.items()}
        return orig(self, inputs, *a, perturb_noise=perturb_noise[:n], **kw)

    monkeypatch.setattr(FinetuneStep, "__call__", half)


def _build_altered(monkeypatch):
    """The coarsest initial volume of the program's build scaled by 1.01."""
    from gens_torch.models.gens import GenSModel

    orig = GenSModel.init_volumes

    def altered(self, *a, **kw):
        volumes, masks, features = orig(self, *a, **kw)
        return volumes[:-1] + [volumes[-1] * 1.01], masks, features

    monkeypatch.setattr(GenSModel, "init_volumes", altered)


@pytest.mark.parametrize("fault,number", [
    (_lr_vol_reversed, "vol_change_last"),
    (_volume_grad_dropped, "vol_grad1"),
    (_colour_altered, "colour1"),
    (_half_batch, "ray_weight1"),
    (_build_altered, "build")],
    ids=["lr_vol_reversed", "volume_grad_dropped", "altered", "half_batch",
         "build_altered"])
def test_finetune_cell_faults(fault, number, monkeypatch, capsys):
    fault(monkeypatch)
    res = _run(capsys)
    assert not res["correct"], res["checks"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]
