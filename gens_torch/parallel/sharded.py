"""The sharded training step over the ('data', 'view') axes (counterpart of
``pad_views`` and ``make_sharded_train_step`` in
gens_tpu/parallel/sharded.py).

* ``data``: each data row trains one scene; the parameter gradients are
  all-reduced over every rank and divided by the number of rows, so the
  update follows the mean over scenes of each scene's gradient, as the
  one-device step's on each scene would.
* ``view``: the V ranks of a row split the scene's views (padded to a
  multiple of V, ``view_valid`` zero on the padding) and its rays and
  pseudo points. A rank extracts features from its own views; the volume
  cascade aggregates the group's sums (``models/volume.py``); the
  features, images and cameras are gathered for the blending and the MFC
  warp (``GenSModel.build_scene``); a rank renders its own rays, and every
  loss is a (numerator, denominator) pair summed over the group
  (``losses.py``).

The gradient rule: every rank backpropagates its own share of the row's
loss (its numerators over the group's denominators, 1/V of the TV term
that every rank computes from the same volumes), and the shares sum to the
one-device gradient. A plain all-reduce does that sum, not
``DistributedDataParallel``, whose division by the world size would be
wrong under ``view``. The JAX step scales its gradient by data × view
(ROADMAP §C); this one does not.

The metrics are the row's loss terms, averaged over the rows. A rank's
random draws (the perturbation, the sparse points) come from its own
generator, seeded from (seed, data row, view column) by the runner.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from gens_torch.config import Config
from gens_torch.losses import compute_losses
from gens_torch.models.gens import GenSModel
from gens_torch.parallel.collectives import share_sum
from gens_torch.parallel.distributed import RankLayout
from gens_torch.train.step import TrainStep

# per-ray and per-point entries of a batch, split over the view group
RAY_KEYS = ("rays_o", "rays_d", "color", "depth", "pseudo_depth")
POINT_KEYS = ("pseudo_pts",)


def pad_views(inputs: Dict[str, torch.Tensor], n_view_shards: int
              ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Pad the view axis (dim 0 of imgs (V, H, W, 3), intrs, c2ws) to a
    multiple of ``n_view_shards``: zero images, identity cameras (never
    used: ``view_valid`` is 0). Adds ``view_valid (V_pad,)``. Returns
    (inputs, V_real)."""
    imgs = inputs["imgs"]
    V = imgs.shape[0]
    pad = -V % n_view_shards
    out = dict(inputs)
    if pad:
        out["imgs"] = torch.cat(
            [imgs, imgs.new_zeros((pad,) + imgs.shape[1:])])
        for k, n in (("intrs", 3), ("c2ws", 4)):
            eye = torch.eye(n, dtype=inputs[k].dtype, device=inputs[k].device)
            out[k] = torch.cat([inputs[k], eye.expand(pad, n, n)])
    out["view_valid"] = (torch.arange(V + pad, device=imgs.device) < V).to(
        imgs.dtype)
    return out, V


def shard(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """The i-th of ``n`` equal contiguous blocks of dim 0."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]


def broadcast_model(model: torch.nn.Module) -> None:
    """Every parameter and buffer from rank 0 (collective)."""
    for t in model.state_dict().values():
        dist.broadcast(t, src=0)


class ShardedTrainStep(TrainStep):
    """:class:`TrainStep` on one rank of ``layout``. ``inputs`` is the
    whole batch of this rank's data row (every rank of a row holds the same
    one); ``perturb_noise`` and ``sparse_pts``, when given, are this rank's
    own. Construction broadcasts the model from rank 0; after a call
    ``.grad`` holds the all-reduced gradients the update used."""

    def __init__(self, model: GenSModel, cfg: Config, steps_per_epoch: int,
                 layout: RankLayout, start_step: int = 0):
        super().__init__(model, cfg, steps_per_epoch, start_step)
        self.layout = layout
        broadcast_model(model)

    def _scene(self, inputs):
        lay = self.layout
        padded, n_views = pad_views(
            {k: inputs[k] for k in ("imgs", "intrs", "c2ws")}, lay.n_view)
        mine = {k: shard(v, lay.n_view, lay.view_col)
                for k, v in padded.items()}
        scene = self.model.build_scene(
            mine["imgs"], mine["intrs"], mine["c2ws"],
            view_valid=mine["view_valid"], group=lay.view_group,
            n_views=n_views)
        local = dict(inputs)
        for k in RAY_KEYS + POINT_KEYS:
            if k in local:
                local[k] = shard(local[k], lay.n_view, lay.view_col)
        return scene, local

    def _losses(self, outputs, inputs):
        if "pseudo_valid" in inputs:
            # a scene without pseudo points carries zeros and a 0 flag
            outputs["pseudo_sdf"] = outputs["pseudo_sdf"] * inputs[
                "pseudo_valid"]
        return compute_losses(outputs, inputs, self.cfg.train.loss,
                              group=self.layout.view_group)

    def _psnr(self, pred, target):
        sq = torch.sum((pred - target) ** 2)
        cnt = torch.tensor(float(target.numel()), device=sq.device)
        group = self.layout.view_group
        if group is not None:
            sq, cnt = share_sum(sq, group), share_sum(cnt, group)
        return 20.0 * torch.log10(1.0 / torch.sqrt(sq / cnt + 1e-12))

    def _reduce_grads(self):
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat)
        flat /= self.layout.n_data
        for p, g in zip(params, torch.split(flat, [p.numel()
                                                   for p in params])):
            p.grad = g.view_as(p)

    def _reduce_metrics(self, metrics):
        keys = list(metrics)
        vec = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(vec)
        vec /= dist.get_world_size()
        return dict(zip(keys, vec.unbind()))
