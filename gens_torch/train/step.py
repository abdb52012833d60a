"""The generalizable training step and the finetune step (counterpart of
gens_tpu/train/step.py and the finetune step of gens_tpu/runner.py):
forward, losses, and an Adam update with per-group learning rates under a
warmup-cosine schedule.

Groups, as the JAX ``_param_labels``: ``mlp`` (``sdf``, ``blending``) at
``lr_mlp``; ``variance`` at ``lr_mlp · lr_variance_mult``; ``feat``
(``feature``, ``agg``, ``reg``) at ``lr_feat``. The frozen
``match_feature`` copy is in no group (optax ``set_to_zero``), nor are the
MnasNet BN statistics, which are buffers (the JAX label "frozen"). The
schedule is a ``LambdaLR`` on
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
from gens_torch.utils import profiling
from gens_torch.utils.profiling import span

# top-level module -> optimizer group
GROUPS = {"sdf": "mlp", "blending": "mlp", "variance": "variance",
          "feature": "feat", "agg": "feat", "reg": "feat"}
SAMPLER_COUNTS = ("sampler.sdf_points", "sampler.sdf_live")
FEATURE_COUNTS = ("features.views", "features.match_views")


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


def _phase_ms(rec: profiling.recording, counts0: List[int],
              enqueue_ms: float) -> Dict[str, float]:
    """The step's ``phase_ms``: device ms of each phase and of each span
    inside it, summed over the step; ``enqueue``, the host ms from the
    step's entry to the end of its last phase; the sampler's live share,
    the % of the points its SDF evaluates that lie inside the voxel mask;
    and, where the step ran the feature nets, the views through the
    trained and the frozen copy (``features/views``,
    ``features/match_views``)."""
    out = profiling.span_ms(rec.records())
    out["enqueue"] = enqueue_ms
    points, live, views, match_views = (
        profiling.counter(n) - c
        for n, c in zip(SAMPLER_COUNTS + FEATURE_COUNTS, counts0))
    if points:
        out["render/sampler/live_share"] = 100.0 * live / points
    if views or match_views:
        out["features/views"] = float(views)
        out["features/match_views"] = float(match_views)
    return out


class TrainStep:
    """``step(inputs, cos_anneal_ratio, use_match_features, ...)`` runs one
    update of ``model`` and returns its metrics as 0-d tensors (the losses,
    ``psnr`` and ``s_val``). After the call the parameters' ``.grad`` hold
    this step's gradients. With ``timing=True`` the step's spans record
    (``utils/profiling.py``) and the metrics also hold ``phase_ms``: device
    milliseconds of build_scene, render (with the losses), backward and
    the optimizer update (with the scheduler), of each span inside them
    (``build_scene/features``, ``render/sampler``, ...), ``enqueue``,
    ``render/sampler/live_share`` and the views through each feature net
    (see :func:`_phase_ms`).

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
        t_entry = time.perf_counter_ns()
        model = self.model
        model.train()
        self.optimizer.zero_grad(set_to_none=True)
        counts0 = [profiling.counter(n) for n in
                   SAMPLER_COUNTS + FEATURE_COUNTS] if timing else None
        with profiling.recording(timing) as rec:
            with span("gens/step/build_scene"):
                scene, inputs = self._scene(inputs)
            with span("gens/step/render"):
                outputs = model.render_train(scene, inputs, cos_anneal_ratio,
                                             use_match_features, generator,
                                             perturb_noise, sparse_pts)
                losses = self._losses(outputs, inputs)
            # the sharded step's backward phase includes the all-reduce
            with span("gens/step/backward"):
                losses["loss"].backward()
                self._reduce_grads()
            with span("gens/step/optimizer"):
                self.optimizer.step()
                self.scheduler.step()
        enqueue_ms = (time.perf_counter_ns() - t_entry) * 1e-6
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["psnr"] = self._psnr(outputs["color_fine"].detach(),
                                     inputs["color"])
        metrics["s_val"] = outputs["s_val"].detach().mean()
        metrics = self._reduce_metrics(metrics)
        if timing:
            metrics["phase_ms"] = _phase_ms(rec, counts0, enqueue_ms)
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
    gradients. With ``timing=True`` the metrics also hold ``phase_ms``, as
    :class:`TrainStep`'s without build_scene.

    On the card, an untimed call replays a CUDA graph of the forward, the
    losses and the backward, and then runs the optimizer update and the
    schedule as the eager step does. The step's render issues some twenty
    thousand small kernels, and the host that launches them one by one
    takes about three times the device's time; the graph launches them at
    once, with their launch parameters fixed at the capture. It is
    captured at the second of two untimed calls in a row that agree in
    what it holds fixed (:func:`_graph_key`) while no profiler records,
    after warm-up passes that change no state; so a cos-anneal ratio still
    rising is not captured. The render's random draws are made before the
    replay, from ``generator`` as the render makes them. A call whose
    cos-anneal ratio or inputs' names, shapes or dtypes differ from those
    captured, whose inputs are off the card, or that is timed (a span
    cannot be timed inside a graph) runs eagerly, on the same kernels;
    after a capture the eager step zeroes the gradients in place, since
    the graph writes them where it found them. On the card every call runs
    on the step's own stream, after the work its caller's stream holds and
    before that stream's next."""

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
        self.graph: Optional[_Graph] = None
        self._last_key = None
        self.stream = (torch.cuda.Stream(self.volumes[0].device)
                       if self.volumes[0].is_cuda else None)

    def __call__(self, inputs: Dict[str, torch.Tensor],
                 cos_anneal_ratio: float,
                 generator: Optional[torch.Generator] = None,
                 perturb_noise: Optional[torch.Tensor] = None,
                 sparse_pts: Optional[torch.Tensor] = None,
                 timing: bool = False) -> Dict:
        args = (inputs, cos_anneal_ratio, generator, perturb_noise,
                sparse_pts, timing)
        if self.stream is None:
            return self._step(*args)
        # every step on one stream of its own, which the graph is captured
        # on: autograd runs a leaf's gradient accumulation on the stream it
        # first met the leaf on, and a capture fails where that is another
        caller = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            out = self._step(*args)
        caller.wait_stream(self.stream)
        return out

    def _step(self, inputs, cos_anneal_ratio, generator, perturb_noise,
              sparse_pts, timing) -> Dict:
        if not timing and self.stream is not None:
            perturb_noise, sparse_pts = self._draws(
                inputs, generator, perturb_noise, sparse_pts)
            key = _graph_key(inputs, cos_anneal_ratio, perturb_noise,
                             sparse_pts)
            # no capture while the profiler records: spans would time it
            if (key is not None and self.graph is None
                    and key == self._last_key and not profiling.enabled()):
                self.graph = _Graph(self, key, inputs, cos_anneal_ratio,
                                    perturb_noise, sparse_pts)
            self._last_key = key
            if self.graph is not None and key == self.graph.key:
                return self._replay(inputs, perturb_noise, sparse_pts)
        t_entry = time.perf_counter_ns()
        self.model.train()
        self.optimizer.zero_grad(set_to_none=self.graph is None)
        counts0 = [profiling.counter(n) for n in
                   SAMPLER_COUNTS + FEATURE_COUNTS] if timing else None
        with profiling.recording(timing) as rec:
            with span("gens/step/render"):
                outputs, losses = self._render(
                    inputs, cos_anneal_ratio, generator, perturb_noise,
                    sparse_pts)
            with span("gens/step/backward"):
                losses["loss"].backward()
            with span("gens/step/optimizer"):
                self.optimizer.step()
                self.scheduler.step()
        enqueue_ms = (time.perf_counter_ns() - t_entry) * 1e-6
        metrics = _metrics(outputs, losses, inputs)
        if timing:
            metrics["phase_ms"] = _phase_ms(rec, counts0, enqueue_ms)
        return metrics

    def _render(self, inputs, cos_anneal_ratio, generator, perturb_noise,
                sparse_pts):
        """(the render's outputs, the losses)."""
        outputs = self.model.forward_finetune(
            self.volumes, self.mask_volumes, self.features, inputs,
            cos_anneal_ratio, generator, perturb_noise, sparse_pts)
        return outputs, compute_losses(outputs, inputs, self.cfg.train.loss)

    def _draws(self, inputs, generator, perturb_noise, sparse_pts):
        """The render's random draws, made where and as
        ``Renderer.render`` makes them in training, on the rays' device."""
        rc = self.model.renderer.cfg
        dev = inputs["rays_o"].device
        if perturb_noise is None and rc.perturb > 0:
            perturb_noise = torch.rand((inputs["rays_o"].shape[0], 1),
                                       generator=generator) - 0.5
        if sparse_pts is None:
            sparse_pts = (torch.rand((rc.n_sparse_pts, 3),
                                     generator=generator) * 2.0 - 1.0)
        if perturb_noise is not None:
            perturb_noise = perturb_noise.to(dev)
        return perturb_noise, sparse_pts.to(dev)

    def _replay(self, inputs, perturb_noise, sparse_pts) -> Dict:
        g = self.graph
        for k, v in inputs.items():
            g.inputs[k].copy_(v)
        if perturb_noise is not None:
            g.perturb_noise.copy_(perturb_noise)
        g.sparse_pts.copy_(sparse_pts)
        self.model.train()
        g.graph.replay()
        self.optimizer.step()
        self.scheduler.step()
        return {k: v.clone() for k, v in g.metrics.items()}


def _metrics(outputs: Dict, losses: Dict, inputs: Dict) -> Dict:
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["psnr"] = psnr(outputs["color_fine"].detach(), inputs["color"])
    return metrics


def _graph_key(inputs: Dict, cos_anneal_ratio: float, *draws):
    """What a captured finetune graph holds fixed: the cos-anneal ratio and
    each input's and draw's name, shape and dtype (a draw may be None);
    None where an input is not a tensor on the card."""
    if not all(torch.is_tensor(v) and v.is_cuda for v in inputs.values()):
        return None
    named = list(inputs.items()) + [(f"draw{i}", d)
                                    for i, d in enumerate(draws)]
    return (float(cos_anneal_ratio),) + tuple(
        (k, None if v is None else (tuple(v.shape), v.dtype))
        for k, v in sorted(named, key=lambda kv: kv[0]))


GRAPH_WARMUP = 2   # forward-backward passes before the capture


class _Graph:
    """A finetune step's forward, losses and backward captured as one CUDA
    graph on ``step``'s tensors: the inputs it reads (``inputs``,
    ``perturb_noise``, ``sparse_pts``, copied into before each replay),
    the metrics it writes, and ``key`` (:func:`_graph_key`)."""

    def __init__(self, step: FinetuneStep, key, inputs: Dict,
                 cos_anneal_ratio: float, perturb_noise, sparse_pts):
        self.key = key
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        self.perturb_noise = (None if perturb_noise is None
                              else perturb_noise.clone())
        self.sparse_pts = sparse_pts.clone()
        step.model.train()

        def forward_backward():
            outputs, losses = step._render(
                self.inputs, cos_anneal_ratio, None, self.perturb_noise,
                self.sparse_pts)
            losses["loss"].backward()
            return _metrics(outputs, losses, self.inputs)

        for _ in range(GRAPH_WARMUP):
            step.optimizer.zero_grad(set_to_none=True)
            forward_backward()
        # captured with no gradients, the backward writes them afresh
        step.optimizer.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=step.stream):
            self.metrics = forward_backward()


class ViewCycle:
    """The finetune's order of reference views: a permutation of the
    scene's ``n_views`` drawn from ``rng`` (numpy), walked one view a step
    (``view``, then ``advance`` after the step) and drawn anew once every
    view has had its step."""

    def __init__(self, n_views: int, rng):
        self.n_views, self.rng = n_views, rng
        self.perm = rng.permutation(n_views)
        self.steps = 0

    @property
    def view(self) -> int:
        return int(self.perm[self.steps % self.n_views])

    def advance(self) -> None:
        self.steps += 1
        if self.steps % self.n_views == 0:
            self.perm = self.rng.permutation(self.n_views)
