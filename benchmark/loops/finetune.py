"""Per-scene finetune steps back to back in a closed loop (the traffic
mix's ``"loop": "finetune"``).

Set-up loads the configuration's weights on the device, builds the
program's model, makes the seed's scene at the finetune dataset's size and
builds its cascade volumes, masks and features once through
``GenSModel.init_volumes`` from all of its views, as the runner's finetune
does from a generalizable checkpoint. The plain reference builds them too,
from the same weights and views (``FinetunePlain.init_volumes``); the
number ``build`` holds the program's build against it, and both sides'
steps start from the reference's leaves, so a fault in the program's build
cannot reach the reference. Then ``FinetuneStep`` on those leaves. Each
step takes its reference view from the program's ``ViewCycle`` over
permutations drawn from the seed, a batch of rays on that view with the
views in the order [that view, the others] and ``view_ids`` set, calls the
step with the cosine-anneal ratio of its step count and reads the step's
metrics back, as ``Runner._finetune_lead`` does. The first
``check_steps`` steps warm every shape (the first runs eagerly, the second
captures the step's CUDA graph and replays it) and are what the reference
follows afterwards; the window's steps replay the graph, or run eagerly
where they are timed. ``loops/train.py`` lends its ray probe (each ray's colour and
∂loss/∂colour), its device snapshot of the trained tensors and Adam's
moments before each window step, its window and its profiled slices.

The check (after the window, with the program's state freed) runs the
plain reference (``reference/gens_plain_finetune.py``) from the same
weights and its own initial volumes, masks and features on the same
batches, and compares ``loops/train.py``'s numbers over every trained leaf
(the MLPs' and the five volumes, ``vol0`` … ``vol4``), and two of the
volumes' own: ``vol_grad1``, the worst level's relative L2 gap of the first
step's gradient, and ``vol_change_last``, the worst level's relative L2 gap
of the change in the window's last step, which the reference takes again
from the state that step started from; beside them set-up's ``build``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from harness import compare, core, scenes
from harness.weights import cell_weights

T = core.load_module(os.path.join(core.BENCH_DIR, "loops", "train.py"))

STEP_KEYS = ("imgs", "intrs", "c2ws", "near", "far", "view_ids")
SCENE_KEYS = ("imgs", "intrs", "c2ws")
LEAVES = ("volumes", "mask_volumes", "features")
BATCH_KEYS = T.BATCH_KEYS
VIEWS = 5   # the draw stream of the view order
end_to_end = T.end_to_end


class State:
    pass


def dims(cell) -> Dict:
    """The sizes this mix runs at, from the configuration's dataset."""
    ds = cell.config["config"][cell.traffic["dataset"]]
    return {"n_views": ds["num_views"], "hw": tuple(ds["img_hw"]),
            "n_rays": ds["n_rays"], "n_pseudo": ds["n_pseudo_pts"],
            "n_sparse": cell.traffic["n_sparse"]}


def make_scene(cell, seed: int) -> Dict:
    d = dims(cell)
    return scenes.make_scene(cell.traffic["scene"], d["n_views"], d["hw"],
                             seed, 0)


def on_view(scene: Dict, vid: int) -> Dict:
    """The scene seen from view ``vid``: views in the order [vid, the
    others], as the finetune dataset gives them."""
    order = [vid] + [i for i in range(len(scene["imgs"])) if i != vid]
    out = dict(scene)
    for k in ("imgs", "intrs", "c2ws"):
        out[k] = np.ascontiguousarray(scene[k][order])
    out["view_ids"] = np.asarray(order, np.int64)
    return out


def batch(cell, views: List[Dict], seed: int, step: int, vid: int
          ) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch on view ``vid``."""
    d = dims(cell)
    out = {k: views[vid][k] for k in STEP_KEYS}
    out.update(scenes.train_batch(views[vid], d["n_rays"], d["n_pseudo"],
                                  d["n_sparse"], seed, step))
    return out


class Trained:
    """The finetune's trained tensors by name: the model's ``mlp`` group
    by its state-dict names, then the volumes as ``vol0`` … (what
    ``loops/train.py``'s ``Snapshot`` copies)."""

    def __init__(self, model, step):
        from gens_torch.convert import FINETUNE_MODULES

        self.named = [(f"{top}.{n}", p) for top in FINETUNE_MODULES
                      for n, p in getattr(model, top).named_parameters()]
        self.named += [(f"vol{i}", v) for i, v in enumerate(step.volumes)]

    def named_parameters(self):
        return iter(self.named)

    def host(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().to("cpu", copy=True) for n, p in self.named}

    def grads(self) -> Dict[str, torch.Tensor]:
        return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                .to("cpu", copy=True) for n, p in self.named}


def setup(cell, seed: int, device, weights=None) -> State:
    """``weights`` (a state dict) replaces the configuration's (tests)."""
    from gens_torch.config import config_from_dict
    from gens_torch.models.gens import GenSModel
    from gens_torch.train.step import FinetuneStep, ViewCycle

    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.cfg = config_from_dict(cell.config["config"])
    if device.type == "cuda":
        # as the runner sets them: float32 products in full precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if weights is None:
        weights = cell_weights(cell, device)
    st.init = {k: v.detach().to("cpu", copy=True) for k, v in weights.items()}
    model = GenSModel(st.cfg.model).to(device)
    model.load_state_dict(weights, strict=True)
    del weights
    st.model = model
    scene = make_scene(cell, seed)
    st.views = [on_view(scene, v) for v in range(len(scene["imgs"]))]
    pin = device.type == "cuda"
    st.host = [{k: T._host(v[k], pin) for k in STEP_KEYS} for v in st.views]
    st.scene = {k: scene[k] for k in SCENE_KEYS}
    x = scene_inputs(st.scene, device)
    built = dict(zip(LEAVES, model.init_volumes(*x)))
    leaves = reference_leaves(cell, st.init, x, device)
    st.build = build_gap(built, leaves)
    del built
    st.leaves0 = {k: [t.to("cpu", copy=True) for t in leaves[k]]
                  for k in LEAVES}
    st.step = FinetuneStep(model, st.cfg, *(leaves[k] for k in LEAVES))
    del leaves
    st.order = ViewCycle(len(st.views), scenes.rng_for(seed, VIEWS))
    st.vids, st.n_steps = [], 0
    st.trained = Trained(model, st.step)
    st.losses = []
    st.probe = T.RayProbe(model)
    for i in range(cell.traffic["check_steps"]):
        metrics = run_step(st)
        st.losses.append(metrics["loss"])
        if i == 0:
            st.rays1 = st.probe.take()
            st.first_grad = st.trained.grads()
            st.terms1 = T.terms(metrics)
    st.after = st.trained.host()
    st.snap = T.Snapshot(st.trained, st.step.optimizer)
    st.snap.take(st.n_steps)  # warms the copy's kernels
    return st


def scene_inputs(scene: Dict, device) -> List[torch.Tensor]:
    """The scene's images and cameras, every view, on ``device``."""
    return [torch.from_numpy(np.ascontiguousarray(scene[k])).to(device)
            for k in SCENE_KEYS]


def reference_leaves(cell, init: Dict[str, torch.Tensor], x, device,
                     tf32: bool = False) -> Dict[str, List[torch.Tensor]]:
    """The plain reference's initial ``LEAVES`` of the scene ``x`` (every
    view's images and cameras on ``device``) under the weights ``init``;
    ``tf32`` builds them as the control."""
    R = cell.reference
    mcfg = cell.config["config"]["model"]
    prec = R.Precision(mcfg, None, tf32)
    with torch.device(device):
        ref = R.FinetunePlain(mcfg)
    ref.load_state_dict({k: v.to(device) for k, v in init.items()},
                        strict=True)
    with R.precision(prec):
        return dict(zip(LEAVES, ref.init_volumes(*x, prec)))


def build_gap(prog: Dict[str, List[torch.Tensor]],
              ref: Dict[str, List[torch.Tensor]]) -> float:
    """``build``: the worst relative L2 gap of one level's volume or mask
    or one scale's features of the program's initial leaves against the
    reference's (``compare.volume_gap`` of each)."""
    gaps = {k: [compare.volume_gap([p], [r]) for p, r in zip(prog[k], ref[k])]
            for k in LEAVES}
    print(f"initial leaves: gap by level {gaps}", file=sys.stderr)
    return max(max(g) for g in gaps.values())


def run_step(st: State, timing: bool = False) -> Dict:
    """One finetune step of the window's call and feed; its metrics on
    the host."""
    from gens_torch.train.schedule import cos_anneal_ratio

    k, vid = st.n_steps, st.order.view
    b = batch(st.cell, st.views, st.seed, k, vid)
    pin = st.device.type == "cuda"
    host = dict(st.host[vid])
    host.update({key: T._host(b[key], pin) for key in BATCH_KEYS})
    inputs = {key: v.to(st.device, non_blocking=True)
              for key, v in host.items()}
    noise = T._host(b["perturb_noise"], pin).to(st.device, non_blocking=True)
    sparse = T._host(b["sparse_pts"], pin).to(st.device, non_blocking=True)
    metrics = st.step(inputs, cos_anneal_ratio(
        k, st.cfg.train.anneal_end), perturb_noise=noise, sparse_pts=sparse,
        timing=timing)
    st.order.advance()
    st.vids.append(vid)
    phase = metrics.pop("phase_ms", None)
    out = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
    if phase is not None:
        out["phase_ms"] = phase
    st.n_steps += 1
    return out


def window(st: State, seconds: float, trace: bool) -> Dict:
    """``train.window`` with this loop's step (below); the state after the
    last step is the trained tensors'."""
    win = T.window(st, seconds, trace)
    st.last["after"] = st.trained.host()
    return win


def trace(st: State, win: Dict) -> None:
    """After the window, whose steps were timed and so ran eagerly:
    ``trace_steps`` untimed steps (the step's replays) timed on the host
    clock, then profiled slices of as many: the device's activity alone,
    then with the host's operators."""
    from harness.trace import DeviceTrace

    n = st.cell.traffic["trace_steps"]
    t0 = time.perf_counter()
    for _ in range(n):
        run_step(st)
    win["untimed_step_s"] = (time.perf_counter() - t0) / n
    tr = DeviceTrace(n)
    with tr.record_device(torch):
        for _ in range(n):
            run_step(st)
    with tr.record_host(torch):
        for _ in range(n):
            run_step(st)
    win["trace"] = tr


def context(st: State, win: Dict) -> Dict:
    """What the per-layer readers read: ``loops/train.py``'s, with the
    step time of the untimed steps after a traced window (the replays
    that the profiled slices record) where there are any, and the
    elements Adam updates, of the five volumes and of the ``mlp``
    group."""
    model = st.cell.config["config"]["model"]
    vol = sum(p.numel() for n, p in st.trained.named if n.startswith("vol"))
    mlp = sum(p.numel() for n, p in st.trained.named
              if not n.startswith("vol"))
    step_s = win.get("untimed_step_s",
                     win["seconds"] / max(win["steps"], 1))
    return {"phase_ms": win["phase_ms"], "trace": win.get("trace"),
            "step_s": step_s,
            "model": model, "dims": dims(st.cell), "device": st.device,
            "volume_params": vol, "mlp_params": mlp}


def free(st: State) -> None:
    if hasattr(st, "trained"):
        del st.trained
    T.free(st)


FAULTS = ("lr_vol_reversed", "volume_grad_dropped", "altered", "half_batch")
DROPPED = 0   # the level whose gradient "volume_grad_dropped" drops


def reference_steps(cell, init: Dict[str, torch.Tensor], leaves: Dict,
                    views: List[Dict], vids: List[int], seed: int, device,
                    steps=None, before=None, tf32: bool = False,
                    fault=None) -> Dict:
    """The plain reference through ``steps`` (by default the first
    ``check_steps``; step ``k`` on view ``vids[k]``) from the weights
    ``init``, the initial ``leaves`` (``volumes``, ``mask_volumes``,
    ``features``) and, where given, ``before`` (a snapshot's ``params``,
    which replace the trained ones, its Adam moments and ``t``, the steps
    taken): each step's loss, the first step's loss terms, gradients and
    each ray's colour gradient, and the trained tensors after the steps.
    ``tf32`` makes it the control; ``fault`` plants one of ``FAULTS``
    ("lr_vol_reversed": the volumes' rates in reverse order;
    "volume_grad_dropped": level ``DROPPED`` gets no gradient; "altered":
    each ray given its neighbour's rendered colour where it is made;
    "half_batch": the loss over the first half of the rays alone)."""
    R = cell.reference
    mcfg = cell.config["config"]["model"]
    tcfg = dict(cell.config["config"]["train"])
    if fault == "lr_vol_reversed":
        tcfg["lr_vol"] = list(tcfg["lr_vol"])[::-1]
    prec = R.Precision(mcfg, None, tf32)
    with torch.device(device):
        ref = R.FinetunePlain(mcfg)
    ref.load_state_dict({k: v.to(device) for k, v in init.items()},
                        strict=True)
    ref.train()
    params = before["params"] if before is not None else {}
    with torch.no_grad():
        for n, p in ref.trained():
            if n in params:
                p.copy_(params[n])
    vols = [params.get(f"vol{i}", v).to(device).clone().requires_grad_(True)
            for i, v in enumerate(leaves["volumes"])]
    masks = [m.to(device) for m in leaves["mask_volumes"]]
    feats = [f.to(device) for f in leaves["features"]]
    opt = R.FinetuneAdam(ref, vols, tcfg)
    if before is not None:
        opt.t = before["t"]
        for n, _ in opt.named:
            if n in before["exp_avg"]:
                opt.m[n].copy_(before["exp_avg"][n])
                opt.v[n].copy_(before["exp_avg_sq"][n])
    out = {"losses": []}
    steps = range(cell.traffic["check_steps"]) if steps is None else steps
    with R.precision(prec):
        for i, k in enumerate(steps):
            b = batch(cell, views, seed, k, vids[k])
            x = {key: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for key, v in b.items()}
            if fault == "half_batch":
                half = len(x["rays_o"]) // 2
                for key in ("rays_o", "rays_d", "color", "pseudo_depth",
                            "perturb_noise"):
                    x[key] = x[key][:half]
            for _, p in opt.named:
                p.grad = None
            used = [v.detach() if fault == "volume_grad_dropped"
                    and j == DROPPED else v for j, v in enumerate(vols)]
            preds = ref.render_finetune(
                used, masks, feats, x,
                R.cos_anneal_ratio(k, tcfg["anneal_end"]),
                x["perturb_noise"], x["sparse_pts"], prec)
            if fault == "altered":
                preds["color_fine"] = torch.roll(preds["color_fine"], 1, 0)
            preds["color_fine"].retain_grad()
            losses = R.compute_losses(preds, x, tcfg["loss"])
            losses["loss"].backward()
            out["losses"].append(float(losses["loss"].detach()))
            if i == 0:
                out["terms1"] = {n: float(v.detach())
                                 for n, v in losses.items()
                                 if n.endswith("_loss")}
                out["first_grad"] = {
                    n: (p.grad if p.grad is not None
                        else torch.zeros_like(p)).detach().to("cpu",
                                                              copy=True)
                    for n, p in opt.named}
                out["rays1"] = {"colour": preds["color_fine"].detach().to(
                                    "cpu", copy=True),
                                "grad": preds["color_fine"].grad.to(
                                    "cpu", copy=True)}
            del preds, losses
            opt.step()
    out["after"] = {n: p.detach().to("cpu", copy=True) for n, p in opt.named}
    return out


def last_step_reference(st: State, **kw) -> Dict:
    """The reference's take of the window's last step, from the state that
    step started from."""
    before = st.last["before"]
    return reference_steps(st.cell, st.init, st.leaves0, st.views, st.vids,
                           st.seed, st.device, steps=[before["t"]],
                           before=before, **kw)


def volume_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                what: str) -> float:
    """The worst level's relative L2 gap between the volumes ``vol0`` …
    of two trees."""
    names = sorted(n for n in ref if n.startswith("vol"))
    gaps = []
    for n in names:
        p, r = prog[n].double(), ref[n].double()
        gaps.append(float(torch.linalg.norm((p - r).reshape(-1))
                          / torch.linalg.norm(r.reshape(-1))))
    print(f"{what}: gap by level {gaps}", file=sys.stderr)
    return max(gaps)


def volume_numbers(prog_first: Dict, ref_first: Dict, prog_last: Dict,
                   ref_last: Dict, before: Dict) -> Dict[str, float]:
    """``vol_grad1`` from the first gradients; ``vol_change_last`` from
    the trained tensors after the last step and before it."""
    out = {"vol_grad1": volume_gaps(prog_first, ref_first,
                                    "volumes' first gradient")}
    if prog_last is not None:
        names = [n for n in before if n.startswith("vol")]
        out["vol_change_last"] = volume_gaps(
            {n: prog_last[n] - before[n] for n in names},
            {n: ref_last[n] - before[n] for n in names},
            "volumes' change in the last step")
    return out


def numbers(prog: Dict, ref: Dict, init: Dict, prog_last=None,
            ref_last=None, before=None) -> Dict[str, float]:
    """Every compared number of the cell: ``compare.train_numbers`` of the
    first steps over the trained tensors (from ``init``, the initial
    volumes under their names), ``compare.last_step_numbers`` of the
    window's last step, and ``volume_numbers``."""
    out = compare.train_numbers(prog, ref, init)
    if prog_last is not None:
        out.update(compare.last_step_numbers(prog_last, ref_last,
                                             before["params"]))
    out.update(volume_numbers(
        prog["first_grad"], ref["first_grad"],
        prog_last and prog_last["after"], ref_last and ref_last["after"],
        before and before["params"]))
    return out


def trained_init(st: State) -> Dict[str, torch.Tensor]:
    out = {n: st.init[n] for n in st.after if not n.startswith("vol")}
    out.update({f"vol{i}": v for i, v in enumerate(st.leaves0["volumes"])})
    return out


def check(st: State, win: Dict) -> Dict[str, float]:
    free(st)
    st.ref_first = reference_steps(st.cell, st.init, st.leaves0, st.views,
                                   st.vids, st.seed, st.device)
    prog = {"losses": st.losses, "terms1": st.terms1, "rays1": st.rays1,
            "first_grad": st.first_grad, "after": st.after}
    prog_last = None
    if getattr(st, "last", None) is not None:
        st.ref_last = last_step_reference(st)
        m = st.last["metrics"]
        prog_last = {"losses": [m["loss"]], "terms1": T.terms(m),
                     "rays1": st.last["rays1"], "after": st.last["after"]}
    out = {"build": st.build}
    out.update(numbers(prog, st.ref_first, trained_init(st), prog_last,
                       getattr(st, "ref_last", None),
                       st.last["before"] if prog_last is not None else None))
    return out


# loops/train.py's window drives this loop's step
T.run_step = run_step
