"""Training steps back to back with the MnasNet-1.0 FPN backbone (the
traffic mix's ``"loop": "train_mnasnet"``): ``loops/train.py``'s loop, set-up,
window, trace and check, with two additions.

Set-up passes the weights: every shared tree from the configuration's
checkpoint (``harness.weights.checkpoint_state``, the FPN's feature trees
dropped) and the MnasNet trees drawn here from the traffic's
``backbone_seed`` by the program's state-dict names (the plain
reference's, which are the same): convolutions lecun-normal, BatchNorm
scale, bias, mean and variance drawn so that no BatchNorm is the
identity, ``match_feature`` equal to ``feature``.

The check adds ``features1``: the worst scale's relative L2 gap between
the trained copy's five maps in the first step (the model's
``extract_features`` wrapped on the instance, as ``RayProbe`` wraps
``render_train``) and the reference backbone's maps of the same images
from the same weights, and the same of the frozen copy's maps against the
reference's frozen copy (whose maps only the MFC term reads, and weakly).
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict, List

import torch

from harness import core
from harness.weights import cell_weights

T = core.load_module(os.path.join(core.BENCH_DIR, "loops", "train.py"))

dims, make_pool = T.dims, T.make_pool
trace, end_to_end, context = T.trace, T.end_to_end, T.context
reference_steps, last_step_reference = T.reference_steps, \
    T.last_step_reference


def backbone_state(cell, seed: int) -> Dict[str, torch.Tensor]:
    """The ``feature`` and ``match_feature`` trees, on the CPU: one
    generator seeded with ``seed``, the leaves in the reference's order."""
    net = cell.reference.MnasNetFeatureNetwork(
        cell.config["config"]["model"]["feature_network"])
    gen = torch.Generator().manual_seed(seed)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    state = {}
    for name, t in net.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("bn.weight"):
            v = uniform(shape, 0.5, 1.5)
        elif name.endswith("bn.bias"):
            v = 0.2 * torch.randn(shape, generator=gen)
        elif name.endswith("running_mean"):
            v = 0.2 * torch.randn(shape, generator=gen)
        elif name.endswith("running_var"):
            v = uniform(shape, 0.5, 2.0)
        else:
            # conv (O, I / groups, k, k): fan-in I / groups · k²; the
            # decoder's transposed conv (I, O, 3, 3), as the program: 9 I
            fan_in = (shape[0] if name.startswith("decod_layer")
                      else shape[1]) * shape[2] * shape[3]
            v = torch.randn(shape, generator=gen) / math.sqrt(fan_in)
        state["feature." + name] = v
    state.update({"match_" + n: v.clone() for n, v in state.items()})
    return state


def cell_weights_mnasnet(cell, device) -> Dict[str, torch.Tensor]:
    shared = {k: v for k, v in cell_weights(cell, device).items()
              if not k.startswith(("feature.", "match_feature."))}
    shared.update({k: v.to(device) for k, v in backbone_state(
        cell, cell.traffic["backbone_seed"]).items()})
    return shared


class FeatureProbe(T.RayProbe):
    """``RayProbe``, and each feature net's first maps and their images:
    the model's ``extract_features`` wrapped on the instance too, copying
    once a copy, in the set-up's first step."""

    def __init__(self, model):
        super().__init__(model)
        self.first = {}
        inner = model.extract_features

        def extract_features(imgs, match=False):
            out = inner(imgs, match)
            tree = "match_feature" if match else "feature"
            if tree not in self.first:
                self.first["imgs"] = imgs.detach().to("cpu", copy=True)
                self.first[tree] = [f.detach().to("cpu", copy=True)
                                    for f in out]
            return out

        model.extract_features = extract_features

    def close(self) -> None:
        del self.model.extract_features
        super().close()


T.RayProbe = FeatureProbe


def setup(cell, seed: int, device, weights=None):
    """``weights`` (a state dict) replaces the configuration's (tests)."""
    if weights is None:
        weights = cell_weights_mnasnet(cell, device)
    st = T.setup(cell, seed, device, weights)
    st.features1 = st.probe.first
    return st


def window(st, seconds: float, trace: bool) -> Dict:
    """``train.window``; the BatchNorm statistics, buffers that the
    snapshot of the parameters leaves out, are added to the state the
    last step started from, as the program holds them after it."""
    win = T.window(st, seconds, trace)
    st.last["before"]["params"].update(
        {n: b.detach().to("cpu", copy=True)
         for n, b in st.model.named_buffers()})
    return win


def reference_features(cell, init: Dict[str, torch.Tensor],
                       imgs: torch.Tensor, device, tf32: bool = False,
                       tree: str = "feature") -> List[torch.Tensor]:
    """The reference backbone's five maps of ``imgs`` from ``init``'s
    ``tree`` (``feature`` or ``match_feature``), in float32 (TF32 in its
    products under ``tf32``: the control)."""
    R = cell.reference
    mcfg = cell.config["config"]["model"]
    with torch.device(device):
        net = R.MnasNetFeatureNetwork(mcfg["feature_network"])
    pre = tree + "."
    net.load_state_dict({k[len(pre):]: v.to(device)
                         for k, v in init.items() if k.startswith(pre)},
                        strict=True)
    with torch.no_grad(), R.precision(R.Precision(mcfg, None, tf32)):
        return [f.to("cpu") for f in net(imgs.to(device))]


def features_gap(prog: List[torch.Tensor], ref: List[torch.Tensor],
                 what: str = "feature") -> float:
    """The worst scale's relative L2 gap."""
    gaps = [float(torch.linalg.norm((p.double() - r.double()).reshape(-1))
                  / torch.linalg.norm(r.double().reshape(-1)))
            for p, r in zip(prog, ref)]
    print(f"{what} maps, first step: gap by scale {gaps}", file=sys.stderr)
    return max(gaps)


def control_features1(cell, init, seed: int, device) -> float:
    """``features1`` with the reference backbone under TF32 in the
    program's place, on the first step's images."""
    imgs = torch.from_numpy(make_pool(cell, seed)[0]["imgs"])
    return features_gap(
        reference_features(cell, init, imgs, device, tf32=True),
        reference_features(cell, init, imgs, device))


def check(st, win: Dict) -> Dict[str, float]:
    out = T.check(st, win)
    f = st.features1
    out["features1"] = max(
        features_gap(f[tree], reference_features(
            st.cell, st.init, f["imgs"], st.device, tree=tree), tree)
        for tree in ("feature", "match_feature"))
    return out
