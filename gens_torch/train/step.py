"""The generalizable training step and the finetune step (counterpart of
gens_tpu/train/step.py and the finetune step of gens_tpu/runner.py):
forward, losses, and an Adam update with per-group learning rates under a
warmup-cosine schedule.

Groups, as the JAX ``_param_labels``: ``mlp`` (``sdf``, ``blending``) at
``lr_mlp``; ``variance`` at ``lr_mlp · lr_variance_mult``; ``feat``
(``feature``, ``reg``) at ``lr_feat``. The frozen ``match_feature`` copy is
in no group (optax ``set_to_zero``). The schedule is a ``LambdaLR`` on
``warmup_cosine_factor(step / steps_per_epoch, …)``, stepped after each
update, so the first update uses the factor at step 0 as optax's count does.
torch's Adam and optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the
square root) compute the same update.

Finetune, as the JAX ``make_finetune_optimizer``: ``mlp`` (``sdf``,
``blending`` and ``variance``, all at ``lr_mlp``; ``lr_variance_mult``
plays no part) and ``vol0`` … ``vol{n-1}``, one per cascade volume at
``lr_vol[i]``, under ``warmup_cosine_factor(step, epochs, warmup, alpha)``
counted in raw steps.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from gens_torch.config import Config, TrainConfig
from gens_torch.convert import FINETUNE_MODULES
from gens_torch.losses import compute_losses
from gens_torch.models.gens import GenSModel
from gens_torch.train.schedule import warmup_cosine_factor

# top-level module -> optimizer group
GROUPS = {"sdf": "mlp", "blending": "mlp", "variance": "variance",
          "feature": "feat", "reg": "feat"}
# the sharded step's backward phase includes the gradient all-reduce
PHASES = ("build_scene", "render", "backward", "optimizer")
FINETUNE_PHASES = ("render", "backward", "optimizer")


def param_groups(model: GenSModel, tcfg: TrainConfig) -> List[Dict]:
    lrs = {"mlp": tcfg.lr_mlp,
           "variance": tcfg.lr_mlp * tcfg.lr_variance_mult,
           "feat": tcfg.lr_feat}
    params = {g: [] for g in lrs}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        if top == "match_feature":
            continue
        params[GROUPS[top]].append(p)
    return [{"name": g, "params": params[g], "lr": lrs[g]} for g in lrs]


def make_optimizer(model: GenSModel, tcfg: TrainConfig, steps_per_epoch: int,
                   start_step: int = 0):
    """(Adam, LambdaLR); ``start_step`` resumes the schedule's count."""
    opt = torch.optim.Adam(param_groups(model, tcfg), betas=(0.9, 0.999),
                           eps=1e-8)

    def factor(step: int) -> float:
        return warmup_cosine_factor((step + start_step) / steps_per_epoch,
                                    tcfg.epochs, tcfg.warmup, tcfg.alpha)

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def make_finetune_optimizer(model: GenSModel, volumes: Sequence[torch.Tensor],
                            tcfg: TrainConfig):
    """(Adam, LambdaLR) over the ``mlp`` group (sdf, blending, variance)
    and one group per cascade volume."""
    if len(volumes) != len(tcfg.lr_vol):
        raise ValueError(f"{len(volumes)} volumes but {len(tcfg.lr_vol)} "
                         "train.lr_vol entries")
    mlp = [p for top in FINETUNE_MODULES
           for p in getattr(model, top).parameters()]
    groups = [{"name": "mlp", "params": mlp, "lr": tcfg.lr_mlp}]
    groups += [{"name": f"vol{i}", "params": [v], "lr": lr}
               for i, (v, lr) in enumerate(zip(volumes, tcfg.lr_vol))]
    opt = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)

    def factor(step: int) -> float:
        return warmup_cosine_factor(step, tcfg.epochs, tcfg.warmup,
                                    tcfg.alpha)

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse + 1e-12))


def sync_match_features(model: GenSModel) -> None:
    """Copy the live feature net into the frozen matching copy."""
    model.match_feature.load_state_dict(model.feature.state_dict())


class _Marks:
    """Phase boundaries: CUDA events on the card, the host clock on the
    CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


class TrainStep:
    """``step(inputs, cos_anneal_ratio, use_match_features, ...)`` runs one
    update of ``model`` and returns its metrics as 0-d tensors (the losses,
    ``psnr`` and ``s_val``). After the call the parameters' ``.grad`` hold
    this step's gradients. With ``timing=True`` the metrics also hold
    ``phase_ms``: milliseconds of build_scene, render (with the losses),
    backward and the optimizer update.

    The sharded step (``parallel/sharded.py``) overrides the hooks
    ``_scene``, ``_losses``, ``_psnr``, ``_reduce_grads`` and
    ``_reduce_metrics``; here they are the one-device step's."""

    def __init__(self, model: GenSModel, cfg: Config, steps_per_epoch: int,
                 start_step: int = 0):
        self.model = model
        self.cfg = cfg
        self.optimizer, self.scheduler = make_optimizer(
            model, cfg.train, steps_per_epoch, start_step)

    def __call__(self, inputs: Dict[str, torch.Tensor],
                 cos_anneal_ratio: float, use_match_features: bool = False,
                 generator: Optional[torch.Generator] = None,
                 perturb_noise: Optional[torch.Tensor] = None,
                 sparse_pts: Optional[torch.Tensor] = None,
                 timing: bool = False) -> Dict:
        model = self.model
        model.train()
        self.optimizer.zero_grad(set_to_none=True)
        marks = _Marks(inputs["imgs"].device) if timing else None
        scene, inputs = self._scene(inputs)
        if marks:
            marks.mark()
        outputs = model.render_train(scene, inputs, cos_anneal_ratio,
                                     use_match_features, generator,
                                     perturb_noise, sparse_pts)
        losses = self._losses(outputs, inputs)
        if marks:
            marks.mark()
        losses["loss"].backward()
        self._reduce_grads()
        if marks:
            marks.mark()
        self.optimizer.step()
        self.scheduler.step()
        if marks:
            marks.mark()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["psnr"] = self._psnr(outputs["color_fine"].detach(),
                                     inputs["color"])
        metrics["s_val"] = outputs["s_val"].detach().mean()
        metrics = self._reduce_metrics(metrics)
        if marks:
            metrics["phase_ms"] = dict(zip(PHASES, marks.ms()))
        return metrics

    def _scene(self, inputs: Dict[str, torch.Tensor]):
        """(the scene, the batch the render and the losses read)."""
        return self.model.build_scene(inputs["imgs"], inputs["intrs"],
                                      inputs["c2ws"]), inputs

    def _losses(self, outputs: Dict, inputs: Dict) -> Dict:
        return compute_losses(outputs, inputs, self.cfg.train.loss)

    def _psnr(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return psnr(pred, target)

    def _reduce_grads(self) -> None:
        pass

    def _reduce_metrics(self, metrics: Dict) -> Dict:
        return metrics


class FinetuneStep:
    """The per-scene finetune step. The five cascade ``volumes`` become
    ``nn.Parameter``s (``self.volumes``); ``mask_volumes`` and
    ``features`` stay frozen. ``step(inputs, cos_anneal_ratio, ...)``
    (``inputs`` with ``view_ids``) runs one update of the volumes and of
    the model's sdf, blending and variance modules and returns the losses
    and ``psnr`` as 0-d tensors; ``.grad`` then holds this step's
    gradients. With ``timing=True`` the metrics also hold ``phase_ms``:
    milliseconds of render (with the losses), backward and the optimizer
    update."""

    def __init__(self, model: GenSModel, cfg: Config,
                 volumes: Sequence[torch.Tensor],
                 mask_volumes: Sequence[torch.Tensor],
                 features: Sequence[torch.Tensor]):
        self.model = model
        self.cfg = cfg
        self.volumes = [nn.Parameter(v.detach().clone()) for v in volumes]
        self.mask_volumes = [m.detach() for m in mask_volumes]
        self.features = [f.detach() for f in features]
        self.optimizer, self.scheduler = make_finetune_optimizer(
            model, self.volumes, cfg.train)

    def __call__(self, inputs: Dict[str, torch.Tensor],
                 cos_anneal_ratio: float,
                 generator: Optional[torch.Generator] = None,
                 perturb_noise: Optional[torch.Tensor] = None,
                 sparse_pts: Optional[torch.Tensor] = None,
                 timing: bool = False) -> Dict:
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        marks = _Marks(inputs["imgs"].device) if timing else None
        outputs = self.model.forward_finetune(
            self.volumes, self.mask_volumes, self.features, inputs,
            cos_anneal_ratio, generator, perturb_noise, sparse_pts)
        losses = compute_losses(outputs, inputs, self.cfg.train.loss)
        if marks:
            marks.mark()
        losses["loss"].backward()
        if marks:
            marks.mark()
        self.optimizer.step()
        self.scheduler.step()
        if marks:
            marks.mark()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["psnr"] = psnr(outputs["color_fine"].detach(),
                               inputs["color"])
        if marks:
            metrics["phase_ms"] = dict(zip(FINETUNE_PHASES, marks.ms()))
        return metrics
