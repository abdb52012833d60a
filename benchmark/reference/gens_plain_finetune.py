"""The plain reference of GenS's per-scene finetune: the five cascade
volumes are trained leaves, the masks and the source views' features are
frozen, and Adam updates the SDF, blending and variance networks under one
learning rate and each volume under its own.

Plain PyTorch in float32 (the caller sets TF32 off through
``precision(...)``). The render, the losses, the TV term and the schedule
are ``gens_plain.py``'s; this file adds the build of the finetune's
leaves, the scene made of given leaves,
the NeuS cosine-anneal ratio and the finetune's Adam. See FINETUNE.md for
what it was copied from and where it departs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from .gens_plain import (GenSPlain, Precision, combine_mask_cascade,
                         compute_losses, precision, warmup_cosine_factor)

__all__ = ["GenSPlain", "FinetunePlain", "FinetuneAdam", "Precision",
           "precision", "compute_losses", "cos_anneal_ratio", "MLP_MODULES"]

# the modules in the ``mlp`` group; the feature nets and the U-Net are not
# trained (the volumes take their place)
MLP_MODULES = ("sdf", "blending", "variance")


def cos_anneal_ratio(progress: float, anneal_end: float) -> float:
    if anneal_end <= 0:
        return 1.0
    return min(1.0, float(progress) / anneal_end)


class FinetunePlain(GenSPlain):
    """``GenSPlain`` rendering a scene made of given cascade volumes."""

    @torch.no_grad()
    def init_volumes(self, imgs, intrs, c2ws, prec: Precision) -> tuple:
        """The one-shot build of the finetune's leaves from all views of a
        scene, with no graph: (volumes, mask volumes, features)."""
        features = self.feature(imgs)
        raw, masks = self.aggregate(features, intrs, c2ws, prec)
        return self.reg(raw, prec), masks, features

    def scene(self, volumes: Sequence[torch.Tensor],
              mask_volumes: Sequence[torch.Tensor],
              features: Sequence[torch.Tensor],
              inputs: Dict[str, torch.Tensor]) -> Dict:
        """The scene of one batch: ``volumes`` and ``mask_volumes`` as
        given; the frozen ``features`` of every view (in the scene's own
        order) taken in the batch's order ``inputs["view_ids"]``, which
        serve as the matching features too."""
        feats = [f.index_select(0, inputs["view_ids"]) for f in features]
        return {"volumes": list(volumes), "mask_volumes": list(mask_volumes),
                "features": feats, "match_features": feats,
                "imgs": inputs["imgs"], "intrs": inputs["intrs"],
                "c2ws": inputs["c2ws"],
                "mask_any": combine_mask_cascade(mask_volumes)}

    def render_finetune(self, volumes, mask_volumes, features, inputs,
                        cos_anneal: float, perturb_noise, sparse_pts,
                        prec: Precision) -> Dict:
        """The training render of the batch on the scene of the leaves,
        on the matching features."""
        return self.render_train(
            self.scene(volumes, mask_volumes, features, inputs), inputs,
            cos_anneal, True, perturb_noise, sparse_pts, prec)

    def trained(self) -> List:
        """(name, parameter) of the ``mlp`` group, by state-dict names."""
        return [(n, p) for n, p in self.named_parameters()
                if n.split(".")[0] in MLP_MODULES]


class FinetuneAdam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root) over the
    ``mlp`` group at ``lr_mlp`` and one group per volume ``vol{i}`` at
    ``lr_vol[i]``, under ``warmup_cosine_factor(t, epochs, warmup,
    alpha)`` counted in steps."""

    def __init__(self, model: FinetunePlain, volumes: Sequence[torch.Tensor],
                 train_cfg: Dict):
        lr_vol = list(train_cfg["lr_vol"])
        if len(lr_vol) != len(volumes):
            raise ValueError(f"{len(volumes)} volumes but {len(lr_vol)} "
                             "lr_vol entries")
        self.named = model.trained() + [(f"vol{i}", v)
                                        for i, v in enumerate(volumes)]
        self.lr = {n: train_cfg["lr_mlp"] for n, _ in model.trained()}
        self.lr.update({f"vol{i}": lr for i, lr in enumerate(lr_vol)})
        self.tc = train_cfg
        self.m = {n: torch.zeros_like(p) for n, p in self.named}
        self.v = {n: torch.zeros_like(p) for n, p in self.named}
        self.t = 0

    @torch.no_grad()
    def step(self):
        tc = self.tc
        factor = warmup_cosine_factor(self.t, tc["epochs"], tc["warmup"],
                                      tc["alpha"])
        self.t += 1
        b1, b2 = 0.9, 0.999
        for n, p in self.named:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            lr = self.lr[n] * factor
            denom = (self.v[n].sqrt() / math.sqrt(1 - b2 ** self.t)).add_(1e-8)
            p.addcdiv_(self.m[n], denom, value=-lr / (1 - b1 ** self.t))
