"""Training steps back to back in a closed loop (the traffic mix's
``"loop": "train"``).

Set-up loads the configuration's weights on the device, builds the program's model
and its training step (``gens_torch.train.step.TrainStep``) once, makes a
pool of scenes from the seed, and drives that step object through its
first ``check_steps`` steps on distinct scenes: they warm every shape and
are what the reference follows afterwards. The model's ``render_train``
is wrapped on the instance to keep each ray's rendered colour and its
gradient ∂loss/∂colour, read after the first step and the last. The
window then calls the
same object on the pool's scenes in turn, one batch a step copied from
pinned host memory as the runner's training loop copies it, and reads the
step's metrics back each step as the runner does. Before each window step
the parameters and Adam's moments are copied on the device, so that after
the window they hold the state its last step started from.

The check (after the window, with the program's state freed) runs the
plain reference from the same weights on the same first batches and
compares each step's loss, the first step's colour term and per-ray
weights in the loss, each leaf's first gradient (the program's from its
Adam state after one step) and each leaf's change over the steps. Then it
takes the window's last step again from the state that step started from
and compares its per-ray weights and each leaf's change (its loss and
colour term are printed beside the reference's).
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from harness import compare, scenes
from harness.weights import cell_weights

STEP_KEYS = ("imgs", "intrs", "c2ws", "near", "far")
BATCH_KEYS = ("rays_o", "rays_d", "color", "pseudo_depth", "pseudo_pts")


class State:
    pass


def dims(cell) -> Dict:
    """The sizes this mix runs at, from the configuration's dataset."""
    ds = cell.config["config"][cell.traffic["dataset"]]
    model = cell.config["config"]["model"]
    return {"n_views": ds["num_src_view"] + 1, "hw": tuple(ds["img_hw"]),
            "n_rays": ds["n_rays"], "n_pseudo": ds["n_pseudo_pts"],
            "n_sparse": model["render"]["n_sparse_pts"]}


def make_pool(cell, seed: int) -> List[Dict]:
    d, t = dims(cell), cell.traffic
    return [scenes.make_scene(t["scene"], d["n_views"], d["hw"], seed, i)
            for i in range(t["pool"])]


def batch(cell, pool, seed: int, step: int) -> Dict[str, np.ndarray]:
    d = dims(cell)
    scene = pool[step % len(pool)]
    out = {k: scene[k] for k in STEP_KEYS}
    out.update(scenes.train_batch(scene, d["n_rays"], d["n_pseudo"],
                                  d["n_sparse"], seed, step))
    return out


def setup(cell, seed: int, device, weights=None) -> State:
    """``weights`` (a state dict) replaces the configuration's (tests)."""
    from gens_torch.config import config_from_dict
    from gens_torch.models.gens import GenSModel
    from gens_torch.train.step import TrainStep

    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    t = cell.traffic
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
    st.step = TrainStep(model, st.cfg, t["steps_per_epoch"],
                        start_step=t["start_epoch"] * t["steps_per_epoch"])
    st.pool = make_pool(cell, seed)
    pin = device.type == "cuda"
    st.host = [{k: _host(s[k], pin) for k in STEP_KEYS} for s in st.pool]
    st.n_steps = 0
    st.losses, st.first_grad, st.after = [], None, None
    st.probe = RayProbe(model)
    for i in range(t["check_steps"]):
        metrics = run_step(st)
        st.losses.append(metrics["loss"])
        if i == 0:
            st.rays1 = st.probe.take()
            st.first_grad = first_gradient(st)
            st.terms1 = terms(metrics)
    st.after = _host_params(model)
    st.snap = Snapshot(model, st.step.optimizer)
    st.snap.take(st.n_steps)  # warms the copy's kernels
    return st


def terms(metrics: Dict) -> Dict[str, float]:
    return {k: v for k, v in metrics.items() if k.endswith("_loss")}


def _host_params(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}


class RayProbe:
    """Each ray's rendered colour and its gradient ∂loss/∂colour in the
    latest step, from the model's ``render_train`` wrapped on this
    instance until ``close``. The colour is kept with ``retain_grad``, so
    a step pays no copy and no synchronization for it."""

    def __init__(self, model):
        self.model, self.colour = model, None
        inner = model.render_train

        def render_train(*args, **kwargs):
            out = inner(*args, **kwargs)
            self.colour = out["color_fine"]
            if self.colour.requires_grad:
                self.colour.retain_grad()
            return out

        model.render_train = render_train

    def take(self) -> Dict[str, torch.Tensor]:
        got = {"colour": self.colour.detach().to("cpu", copy=True)}
        if self.colour.grad is not None:
            got["grad"] = self.colour.grad.to("cpu", copy=True)
        return got

    def close(self) -> None:
        del self.model.render_train
        self.colour = None


class Snapshot:
    """Device copies of every parameter and of Adam's two moments, taken
    by three foreach copies; ``step`` is the number of steps taken before
    the copy."""

    def __init__(self, model, opt):
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.moment_names = [n for n, p in named if "exp_avg" in
                             opt.state.get(p, {})]
        moved = [p for _, p in named if "exp_avg" in opt.state.get(p, {})]
        self.src = {"params": [p.detach() for _, p in named],
                    "exp_avg": [opt.state[p]["exp_avg"] for p in moved],
                    "exp_avg_sq": [opt.state[p]["exp_avg_sq"] for p in moved]}
        self.buf = {k: [torch.empty_like(x) for x in v]
                    for k, v in self.src.items()}
        self.step = None

    def take(self, step: int) -> None:
        for k, src in self.src.items():
            if src:
                torch._foreach_copy_(self.buf[k], src)
        self.step = step

    def host(self) -> Dict:
        out = {"t": self.step}
        for k, bufs in self.buf.items():
            names = self.names if k == "params" else self.moment_names
            out[k] = {n: b.to("cpu", copy=True) for n, b in zip(names, bufs)}
        return out


def _host(a: np.ndarray, pin: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if pin else t


def run_step(st: State, timing: bool = False) -> Dict:
    """One step of the window's call and feed; its metrics on the host."""
    t = st.cell.traffic
    k = st.n_steps
    b = batch(st.cell, st.pool, st.seed, k)
    pin = st.device.type == "cuda"
    host = dict(st.host[k % len(st.host)])
    host.update({key: _host(b[key], pin) for key in BATCH_KEYS})
    inputs = {key: v.to(st.device, non_blocking=True)
              for key, v in host.items()}
    noise = _host(b["perturb_noise"], pin).to(st.device, non_blocking=True)
    sparse = _host(b["sparse_pts"], pin).to(st.device, non_blocking=True)
    metrics = st.step(inputs, t["cos_anneal_ratio"],
                      use_match_features=t["use_match_features"],
                      perturb_noise=noise, sparse_pts=sparse, timing=timing)
    phase = metrics.pop("phase_ms", None)
    out = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
    if phase is not None:
        out["phase_ms"] = phase
    st.n_steps += 1
    return out


def first_gradient(st: State) -> Dict[str, torch.Tensor]:
    """Each leaf's gradient as Adam got it, from its first moment after
    one step: exp_avg = (1 - b1) g."""
    opt = st.step.optimizer
    b1 = opt.param_groups[0]["betas"][0]
    out = {}
    for n, p in st.model.named_parameters():
        if p in opt.state and "exp_avg" in opt.state[p]:
            out[n] = (opt.state[p]["exp_avg"] / (1 - b1)).to("cpu", copy=True)
    return out


def window(st: State, seconds: float, trace: bool) -> Dict:
    """Steps back to back while the window lasts (with ``trace`` each one
    timed by phase); the state each step starts from is copied first."""
    win = {"phase_ms": [], "losses": []}
    dev = st.device
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ends = []
    while time.perf_counter() - t0 < seconds:
        st.snap.take(st.n_steps)
        m = run_step(st, timing=trace)
        ends.append(time.perf_counter())
        win["losses"].append(m["loss"])
        if trace:
            win["phase_ms"].append(m["phase_ms"])
    win["seconds"] = time.perf_counter() - t0
    win["steps"] = len(ends)
    win["failed"] = int(sum(not np.isfinite(x) for x in win["losses"]))
    st.last = {"metrics": m, "before": st.snap.host(),
               "after": _host_params(st.model), "rays1": st.probe.take()}
    _print_steps(np.diff([t0] + ends))
    return win


def _print_steps(steps: np.ndarray) -> None:
    q = np.percentile(steps, [25, 50, 75]) * 1e3
    half = len(steps) // 2
    print(f"window: {len(steps)} steps, step ms quartiles "
          f"{q.round(1).tolist()}, first half mean "
          f"{steps[:half].mean() * 1e3 if half else float('nan'):.1f}, "
          f"second half mean {steps[half:].mean() * 1e3:.1f}",
          file=sys.stderr)


def trace(st: State, win: Dict) -> None:
    """Profiled slices of ``trace_steps`` steps after the window: the
    device's activity alone, then with the host's operators."""
    from harness.trace import DeviceTrace

    n = st.cell.traffic["trace_steps"]
    tr = DeviceTrace(n)
    first = st.n_steps
    with tr.record_device(torch):
        for _ in range(n):
            run_step(st)
    win["traced_scenes"] = [st.pool[k % len(st.pool)]
                            for k in range(first, st.n_steps)]
    with tr.record_host(torch):
        for _ in range(n):
            run_step(st)
    win["trace"] = tr


def end_to_end(st: State, win: Dict) -> Dict[str, float]:
    return {"train_step_ms": win["seconds"] / max(win["steps"], 1) * 1e3}


def context(st: State, win: Dict) -> Dict:
    """What the per-layer readers read."""
    d = dims(st.cell)
    model = st.cell.config["config"]["model"]
    return {"phase_ms": win["phase_ms"], "trace": win.get("trace"),
            "step_s": win["seconds"] / max(win["steps"], 1),
            "traced_scenes": win.get("traced_scenes", []),
            "model": model, "dims": d, "device": st.device}


def free(st: State) -> None:
    if hasattr(st, "probe"):
        st.probe.close()
    for name in ("probe", "model", "step", "host", "snap"):
        if hasattr(st, name):
            delattr(st, name)
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_steps(cell, init: Dict[str, torch.Tensor], pool, seed: int,
                    device, steps=None, moments=None, prec_kind=None,
                    tf32=False, fault=None) -> Dict:
    """The plain reference through ``steps`` (by default the first
    ``check_steps``) from the parameters ``init`` and, where given, Adam's
    ``moments`` (a snapshot's ``exp_avg``, ``exp_avg_sq`` and ``t``, the
    steps taken): each step's loss, the first step's loss terms,
    gradients and each ray's colour gradient, and the parameters after the
    steps. ``prec_kind``/``tf32`` make it the control; ``fault`` plants
    one of the faults the check has to catch ("half_batch": the loss over
    the first half of the rays alone; "altered": each ray given its
    neighbour's rendered colour where it is made)."""
    t, mcfg = cell.traffic, cell.config["config"]["model"]
    tcfg = cell.config["config"]["train"]
    R = cell.reference
    prec = R.Precision(mcfg, prec_kind, tf32)
    with torch.device(device):
        ref = R.GenSPlain(mcfg)
    ref.load_state_dict({k: v.to(device) for k, v in init.items()},
                        strict=True)
    ref.train()
    opt = R.Adam(ref, tcfg, t["steps_per_epoch"],
                 t["start_epoch"] * t["steps_per_epoch"])
    if moments is not None:
        opt.t = moments["t"]
        for n, _ in opt.named:
            if n in moments["exp_avg"]:
                opt.m[n].copy_(moments["exp_avg"][n])
                opt.v[n].copy_(moments["exp_avg_sq"][n])
    d = dims(cell)
    out = {"losses": []}
    steps = range(t["check_steps"]) if steps is None else steps
    with R.precision(prec):
        for i, k in enumerate(steps):
            b = batch(cell, pool, seed, k)
            x = {key: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for key, v in b.items()}
            if fault == "half_batch":
                half = d["n_rays"] // 2
                for key in ("rays_o", "rays_d", "color", "pseudo_depth",
                            "perturb_noise"):
                    x[key] = x[key][:half]
            for p in ref.parameters():
                p.grad = None
            scene = ref.build_scene(x["imgs"], x["intrs"], x["c2ws"], prec)
            preds = ref.render_train(scene, x, t["cos_anneal_ratio"],
                                     t["use_match_features"],
                                     x["perturb_noise"], x["sparse_pts"],
                                     prec)
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
            del scene, preds, losses
            opt.step()
    out["after"] = {n: p.detach().to("cpu", copy=True)
                    for n, p in ref.named_parameters()}
    return out


def last_step_reference(st: State, **kw) -> Dict:
    """The reference's take of the window's last step, from the state that
    step started from."""
    before = st.last["before"]
    return reference_steps(st.cell, before["params"], st.pool, st.seed,
                           st.device, steps=[before["t"]], moments=before,
                           **kw)


def check(st: State, win: Dict) -> Dict[str, float]:
    free(st)
    ref = st.ref_first = reference_steps(st.cell, st.init, st.pool, st.seed,
                                         st.device)
    prog = {"losses": st.losses, "terms1": st.terms1, "rays1": st.rays1,
            "first_grad": st.first_grad, "after": st.after}
    out = compare.train_numbers(prog, ref, st.init)
    if getattr(st, "last", None) is not None:
        st.ref_last = last_step_reference(st)
        m = st.last["metrics"]
        prog_last = {"losses": [m["loss"]], "terms1": terms(m),
                     "rays1": st.last["rays1"], "after": st.last["after"]}
        out.update(compare.last_step_numbers(
            prog_last, st.ref_last, st.last["before"]["params"]))
    return out
