"""Training, validation and finetune orchestrator (counterpart of
``Runner.train``, ``Runner.validate``, ``validate_all``, ``Runner.finetune``
and ``_finetune_validate`` in gens_tpu/runner.py).

Datasets: ``get_dataset`` dispatches as the JAX one does (synthetic, the
DTU and BlendedMVS readers and their finetune variants), and the readers
draw from the runner's ``RandomState(seed)``, which also draws the epoch
permutations.

Training: the epoch loop over the train dataset in a seeded random order,
the matching-feature resync every ``match_sync_every`` epochs, the cosine
anneal ratio, ``use_match_features`` from fractional epoch 5, the loss and
PSNR logged every ``log_freq`` epochs, checkpoints every ``save_freq`` and
validation every ``val_freq`` epochs. One worker thread decodes item i+1
into pinned memory while step i runs (``utils/prefetch.py``). ``--resume
auto`` continues from the newest good checkpoint (``latest_checkpoint``);
a resumed run takes the checkpoint's optimizer state in either package's
form (``train/checkpoint.py::load_optimizer_state``: the port's numpy
state, or the JAX package's optax Adam state);
a SIGTERM writes ``preempt.ckpt`` at the next log point or epoch end and
returns (``utils/preemption.py``); a non-finite loss writes
``emergency.ckpt`` and raises.

Several ranks (``parallel/distributed.py``, one process each, ``data`` ×
``view`` of them): a step trains ``parallel.data`` scenes, one per data
row, through ``parallel/sharded.py``; an epoch is ceil(len / data) steps
of an identically seeded order whose remainder wraps into a fresh
permutation, and each rank decodes only its row's item. The ranks of a
row decode it with identically seeded draws, which a checksum proves at
each epoch's first step. Rank 0 alone writes the checkpoints, the metrics
log and the code backup, and the others wait at a barrier until a
checkpoint is on disk; the preemption flag is agreed at every log point.
Validation splits its S scenes over min(W, S) groups of contiguous ranks
(``parallel/distributed.py::val_partition``); a group's leader builds each
of its scenes and broadcasts it, the group's ranks render its rays in
chunks split as the JAX render splits them over devices
(``parallel/render_split.py``), and the leader alone meshes, writes and
scores it. The metric sums are merged over the ranks.

Validation, per scene: build the scene, extract the mesh through K3, clean
it when ``clean_mesh`` is set (``mesh/clean.py``: the views' masks, then the
frustum first-hit consensus, before the scale transform), render the val ray
grid in fixed-size chunks, save images (depth in magma over [0, 2.5]), and
compute PSNR and depth errors.

Finetune, per scene (the experiment directory is
``<base_exp_dir>/<scene>/view<ref_view>``): build the volumes once from all
views (or resume them from a finetune checkpoint), then take ``epochs``
steps, each on a view drawn from a seeded permutation, with the loss logged
every ``log_freq`` steps, a checkpoint every ``save_freq`` steps and
validation (K3 mesh and chunked render of view 0) every ``val_freq`` steps
and at the end. Under several ranks rank 0 runs all of that, and the others
join only its validations' renders, told by a control message from rank 0
at every step whether to go on, validate or stop.

``logs/metrics.jsonl`` under the experiment directory gets the JAX
runner's records (train, train_avg, val, val_avg, finetune), and train and
finetune runs copy the package to ``codes_recording/gens_torch``.

The runner works on one explicit device. It sets float32 matmuls and
convolutions to full precision (no TF32), as the JAX reference computes
them on the CPU.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gens_torch.config import Config
from gens_torch.convert import (FINETUNE_MODULES, load_checkpoint,
                                load_params)
from gens_torch.data.image_io import magma, write_png
from gens_torch.mesh.clean import clean_mesh
from gens_torch.mesh.extract import eval_sdf_grid, grid_to_mesh
from gens_torch.mesh.ply import apply_transform, write_ply
from gens_torch.models.gens import GenSModel
from gens_torch.models.renderer import Scene
from gens_torch.parallel.distributed import (RankLayout, ValGroup,
                                             allreduce_host,
                                             allreduce_host_sums, barrier,
                                             broadcast_ints,
                                             broadcast_tensors,
                                             is_main_process, make_layout,
                                             process_count, rank_seed,
                                             val_groups)
from gens_torch.parallel.render_split import (RAY_KEYS, broadcast_scene,
                                              split_render)
from gens_torch.parallel.sharded import ShardedTrainStep
from gens_torch.train.checkpoint import (latest_checkpoint,
                                         load_finetune_checkpoint,
                                         load_optimizer_state,
                                         save_checkpoint,
                                         save_finetune_checkpoint)
from gens_torch.train.schedule import cos_anneal_ratio
from gens_torch.train.step import (FinetuneStep, TrainStep,
                                   sync_match_features)
from gens_torch.utils.meters import DictAverageMeter, MetricsLogger
from gens_torch.utils.prefetch import prefetch_map
from gens_torch.utils.preemption import PreemptionGuard


def get_dataset(cfg, mode: str = "val",
                rng: Optional[np.random.RandomState] = None):
    """The dataset named by a DatasetConfig in ``mode`` "train", "val" or
    "finetune": synthetic (``num_src_view + 1`` views in every mode, its
    own seed); in finetune mode DTU or else BlendedMVS finetune; DTU; else
    BlendedMVS. The readers draw from ``rng``."""
    name = cfg.dataset_name.lower().replace("dataset", "")
    if name == "synthetic":
        from gens_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(
            n_scenes=len(cfg.scene) if cfg.scene else 4,
            n_views=cfg.num_src_view + 1, hw=tuple(cfg.img_hw),
            n_rays=cfg.n_rays, val_res_level=cfg.val_res_level,
            n_pseudo_pts=min(cfg.n_pseudo_pts, 256), mode=mode)
    if mode == "finetune":
        if name in ("dtu", "dtufinetune"):
            from gens_torch.data.dtu_finetune import DTUFinetuneDataset

            return DTUFinetuneDataset(cfg, rng=rng)
        from gens_torch.data.bmvs import BMVSFinetuneDataset

        return BMVSFinetuneDataset(cfg, rng=rng)
    if name == "dtu":
        from gens_torch.data.dtu import DTUDataset

        return DTUDataset(cfg, mode, rng=rng)
    from gens_torch.data.bmvs import BMVSDataset

    return BMVSDataset(cfg, mode, rng=rng)


def subsample_to_val_grid(full: np.ndarray, h: int, w: int) -> np.ndarray:
    """Index a full-resolution map at the val ray grid's pixels
    (floor(linspace(0, dim-1, n)), as the datasets build the grid)."""
    ty = np.linspace(0, full.shape[0] - 1, h).astype(np.int64)
    tx = np.linspace(0, full.shape[1] - 1, w).astype(np.int64)
    return full[ty[:, None], tx[None, :]]


def epoch_order(rng: np.random.RandomState, n: int, n_data: int
                ) -> np.ndarray:
    """An epoch's item order: ceil(n / n_data) steps of ``n_data`` items,
    the remainder wrapping into a fresh permutation instead of being
    dropped (gens_tpu/runner.py:420-428); with one data row, one
    permutation."""
    need = -(-n // n_data) * n_data
    reps = -(-need // n)
    return np.concatenate([rng.permutation(n) for _ in range(reps)])[:need]


def materialize_schema(item: Dict, use_pseudo: bool, n_pseudo: int) -> Dict:
    """Give an item without pseudo points zero points and a 0
    ``pseudo_valid`` (1 where it has them), and zero pseudo depths, so
    that every scene presents the same batch (gens_tpu/runner.py:347)."""
    if not use_pseudo:
        return item
    item = dict(item)
    if "pseudo_pts" in item:
        item["pseudo_valid"] = np.ones((), np.float32)
    else:
        item["pseudo_pts"] = np.zeros((n_pseudo, 3), np.float32)
        item["pseudo_valid"] = np.zeros((), np.float32)
    if "pseudo_depth" not in item:
        item["pseudo_depth"] = np.zeros(item["rays_o"].shape[0], np.float32)
    return item


def _float_arrays(raw: Dict) -> Dict[str, torch.Tensor]:
    """The float32 arrays of a dataset item as CPU tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in raw.items()
            if isinstance(v, np.ndarray) and v.dtype == np.float32}


# the finetune's control messages from rank 0, one a step: [code, step]
FT_STEP, FT_VALIDATE, FT_DONE, FT_FAILED = range(4)


class Runner:
    # the validation metrics, merged over the ranks as [count, Σ metric…]
    VAL_METRIC_KEYS = ("psnr", "color_loss", "render_depth_loss",
                       "sdf_depth_loss")

    def __init__(self, cfg: Config, device):
        self.cfg = cfg
        self.main = is_main_process()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        # a fresh model is initialized from the seed (training without
        # --resume); the scene order and the render draws have their own
        torch.manual_seed(cfg.train.seed)
        self.model = GenSModel(cfg.model).to(self.device).eval()
        self.rng = np.random.RandomState(cfg.train.seed)
        self.generator = torch.Generator().manual_seed(cfg.train.seed)
        self.exp_dir = cfg.base_exp_dir
        if cfg.mode == "finetune":
            fd = cfg.finetune_dataset
            self.exp_dir = os.path.join(self.exp_dir, fd.scene[0],
                                        f"view{fd.ref_view[0]}")
        if self.main:
            os.makedirs(self.exp_dir, exist_ok=True)
        self.logger = MetricsLogger(
            os.path.join(self.exp_dir, "logs") if self.main else None)
        if cfg.mode in ("train", "finetune") and self.main:
            self._backup_code()
        # seconds and rates of the last validate() call, per scene
        self.stats = []
        # the validation groups, by (world, number of scenes)
        self._val_groups: Dict[Tuple[int, int], ValGroup] = {}
        # per training / finetune step: step, seconds and metrics
        self.train_stats = []
        self.finetune_stats = []

    def close(self) -> None:
        self.logger.close()

    def _backup_code(self) -> None:
        """Copy the package into the experiment directory (once)."""
        src = os.path.dirname(os.path.abspath(__file__))
        dst = os.path.join(self.exp_dir, "codes_recording", "gens_torch")
        if not os.path.exists(dst):
            shutil.copytree(src, dst,
                            ignore=shutil.ignore_patterns("__pycache__"))

    def run(self, resume: Optional[str] = None):
        if self.cfg.mode == "val":
            return self.validate_all(resume)
        if self.cfg.mode == "train":
            return self.train(resume)
        if self.cfg.mode == "finetune":
            return self.finetune(resume)
        raise ValueError(f"unknown mode {self.cfg.mode!r}")

    def _preempt_guard(self) -> PreemptionGuard:
        """The SIGTERM guard of this runner, installed on first use;
        ``train`` restores the previous handler when it returns."""
        if not hasattr(self, "_preempt"):
            self._preempt = PreemptionGuard().__enter__()
        return self._preempt

    def _save(self, name: str, epoch: int, step: int,
              step_fn: TrainStep) -> None:
        """Rank 0 writes ``checkpoints/<name>``; every rank returns once it
        is on disk."""
        if self.main:
            save_checkpoint(os.path.join(self.exp_dir, "checkpoints", name),
                            epoch, step, self.model, step_fn.optimizer)
        barrier()

    def _preempt_save(self, epoch: int, step: int, step_fn: TrainStep,
                      complete: bool = False) -> None:
        """Write ``preempt.ckpt``. Mid-epoch it records epoch - 1, so that a
        resumed run replays the interrupted epoch from its start (the
        params keep its partial progress); at an epoch's end
        (``complete``) the resumed run starts at epoch + 1."""
        self._save("preempt.ckpt", epoch if complete else epoch - 1, step,
                   step_fn)
        print(f"preemption checkpoint saved at epoch {epoch} (step {step}); "
              "exiting", flush=True)

    def _host_batch(self, dataset, idx: int, schema: bool = False
                    ) -> Tuple[Dict[str, torch.Tensor], float]:
        """Item ``idx``'s float32 arrays as CPU tensors, pinned when the
        runner is on the card, and the seconds its decoding and this
        took. ``schema``: through :func:`materialize_schema` first."""
        t0 = time.perf_counter()
        item = dataset[idx]
        if schema:
            item = materialize_schema(
                item, self.cfg.train.loss.pseudo_sdf_weight > 0,
                self.cfg.train_dataset.n_pseudo_pts)
        host = _float_arrays(item)
        if self.device.type == "cuda":
            host = {k: v.pin_memory() for k, v in host.items()}
        return host, time.perf_counter() - t0

    def train(self, resume: Optional[str] = None) -> Dict[str, float]:
        """The generalizable training loop; ``resume`` continues from a
        checkpoint (params, optimizer state, epoch and step), "auto" from
        the newest in the experiment directory or from scratch when there
        is none. Returns the mean metrics of the last epoch. Under
        ``parallel.data`` × ``view`` > 1 every rank calls it, in a world of
        that many ranks."""
        cfg, tc = self.cfg, self.cfg.train
        if cfg.model.volume.agg == "adaptive" and cfg.parallel.view > 1:
            # the JAX aggregation takes no axis_name, so its ranks would
            # weight their own views alone (ROADMAP.md C)
            raise ValueError(
                f"volume.agg: adaptive with parallel.view={cfg.parallel.view}"
                ": the adaptive aggregation has no view axis; use "
                "parallel.view=1")
        n_data = cfg.parallel.data
        layout = None
        if n_data * cfg.parallel.view > 1 or process_count() > 1:
            layout = make_layout(n_data, cfg.parallel.view)
            self.generator = torch.Generator().manual_seed(
                rank_seed(tc.seed, layout.data_row, layout.view_col))
        dataset = get_dataset(cfg.train_dataset, "train", self.rng)
        # the JAX runner takes parallel.data scenes a step: its steps per
        # epoch and LR schedule follow from it
        steps_per_epoch = -(-len(dataset) // n_data)
        # identical on every rank; the item draws of different data rows
        # (self.rng) diverge
        order_rng = (self.rng if n_data == 1
                     else np.random.RandomState(tc.seed))
        ckpt_dir = os.path.join(self.exp_dir, "checkpoints")
        if resume == "auto":
            resume = latest_checkpoint(ckpt_dir)
        start_epoch, step, payload = 0, 0, None
        if resume:
            payload = load_params(self.model, resume)
            start_epoch = int(payload["epoch"]) + 1
            step = int(payload.get("step", 0))
        self.start_epoch = start_epoch
        if layout is None:
            step_fn = TrainStep(self.model, cfg, steps_per_epoch,
                                start_step=step)
        else:
            step_fn = ShardedTrainStep(self.model, cfg, steps_per_epoch,
                                       layout, start_step=step)
        self.step_fn = step_fn
        self.opt_state_form = None
        if payload is not None and payload.get("opt_state") is not None:
            self.opt_state_form = load_optimizer_state(
                step_fn.optimizer, self.model, payload["opt_state"])
            if self.main:
                print(f"[train] resumed the optimizer state ("
                      f"{self.opt_state_form} form) of {resume} at step "
                      f"{step}", flush=True)
        means: Dict[str, float] = {}
        preempt = self._preempt_guard()
        try:
            for epoch in range(start_epoch, tc.epochs):
                if epoch % cfg.model.match_sync_every == 0:
                    sync_match_features(self.model)
                step, means, stopped = self._train_epoch(
                    dataset, step_fn, epoch, step, preempt,
                    epoch_order(order_rng, len(dataset), n_data), layout)
                if stopped:
                    return means
                self.logger.log("train_avg", means, epoch)
                if self.main:
                    print(f"[train] epoch {epoch} mean: " + ", ".join(
                        f"{k} {v:.5f}" for k, v in means.items()),
                        flush=True)
                if (epoch + 1) % tc.save_freq == 0 or epoch + 1 >= tc.epochs:
                    self._save(f"model_{epoch:03d}.ckpt", epoch, step,
                               step_fn)
                if (epoch + 1) % tc.val_freq == 0:
                    self.model.eval()
                    self.validate(epoch)
                if preempt.requested_global():
                    self._preempt_save(epoch, step, step_fn, complete=True)
                    return means
        finally:
            preempt.__exit__(None, None, None)
            del self._preempt
        return means

    def _train_epoch(self, dataset, step_fn: TrainStep, epoch: int, step: int,
                     preempt: PreemptionGuard, order: np.ndarray,
                     layout: Optional[RankLayout] = None
                     ) -> Tuple[int, Dict[str, float], bool]:
        """One epoch over ``order`` (this rank's items: every ``n_data``-th
        from its data row), the next item decoded on the prefetch thread
        while a step runs. Returns the step count, the epoch's mean metrics
        and whether a preemption stopped it (after writing
        ``preempt.ckpt`` at a log point)."""
        if layout is not None:
            order = order[layout.data_row::layout.n_data]
        n = len(order)
        log_every = max(1, int(self.cfg.train.log_freq * n))
        avg = DictAverageMeter()
        t_epoch = time.perf_counter()
        batches = prefetch_map(
            lambda i: self._host_batch(dataset, int(i), layout is not None),
            list(order))
        try:
            for batch in range(n):
                t0 = time.perf_counter()
                host, decode_s = next(batches)
                data_wait_s = time.perf_counter() - t0
                if batch == 0 and layout is not None:
                    check_row_batch(host, layout)
                inputs = {k: v.to(self.device, non_blocking=True)
                          for k, v in host.items()}
                del host
                scalars, seconds = self._train_step(step_fn, inputs,
                                                    epoch + batch / n)
                step += 1
                if not np.isfinite(scalars["loss"]):
                    # every rank sees the same (all-reduced) metrics
                    self._save("emergency.ckpt", epoch, step, step_fn)
                    raise FloatingPointError(
                        f"non-finite loss at epoch {epoch}: {scalars} -- "
                        "emergency checkpoint saved")
                self.train_stats.append({
                    "epoch": epoch, "step": step, "step_s": seconds,
                    "data_wait_s": data_wait_s, "decode_s": decode_s,
                    **scalars})
                avg.update(scalars)
                if batch % log_every == 0:
                    if self.main:
                        print(f"[train] epoch {epoch} step {step}: loss "
                              f"{scalars['loss']:.5f} psnr "
                              f"{scalars['psnr']:.3f} ({seconds:.3f} s, "
                              f"data wait {data_wait_s:.3f} s)", flush=True)
                    self.logger.log("train", {
                        **avg.avg_data,
                        "sec_per_step": (time.perf_counter() - t_epoch)
                        / (batch + 1)}, epoch * n + batch)
                    if preempt.requested_global():
                        self._preempt_save(epoch, step, step_fn)
                        return step, avg.avg_data, True
        finally:
            batches.close()
        return step, avg.avg_data, False

    def _train_step(self, step_fn: TrainStep, inputs, frac: float
                    ) -> Tuple[Dict[str, float], float]:
        """One update at fractional epoch ``frac``; its metrics and
        seconds."""
        self._sync()
        t0 = time.perf_counter()
        metrics = step_fn(inputs, cos_anneal_ratio(frac,
                                                   self.cfg.train.anneal_end),
                          use_match_features=frac >= 5,
                          generator=self.generator)
        # one device sync per step: every metric in one copy
        scalars = dict(zip(metrics, torch.stack(
            list(metrics.values())).tolist()))
        return scalars, time.perf_counter() - t0

    def validate_all(self, resume: Optional[str]) -> Dict[str, float]:
        if not resume:
            raise ValueError("val mode needs a checkpoint (--resume)")
        payload = load_params(self.model, resume)
        return self.validate(int(payload.get("epoch", 0)))

    def finetune(self, resume: Optional[str]) -> Dict[str, float]:
        """Per-scene finetune from a generalizable checkpoint (the volumes
        are built from all views) or a finetune one (the volumes, masks,
        features and MLPs are restored; the step count and the optimizer
        state are not, as in JAX). Returns the mean metrics of the run;
        ``finetune_stats`` holds the per-step ones, ``init_volumes_s`` the
        volume build's seconds and ``ft_step`` the :class:`FinetuneStep`.
        Under several ranks rank 0 runs the finetune (its draws and files
        are the one-process run's) and every rank calls this: the others
        load the checkpoint's modules, split each validation's render with
        rank 0 and return rank 0's means."""
        if not resume:
            raise ValueError("finetune needs a checkpoint (--resume)")
        payload = load_checkpoint(resume)
        self.init_volumes_s = None
        if not self.main:
            return self._finetune_follow(payload)
        self._ft_validating = False
        try:
            means = self._finetune_lead(payload)
        except BaseException:
            # the others wait for a control message, unless they are in a
            # validation's collectives, which this process's exit breaks
            if process_count() > 1 and not self._ft_validating:
                try:
                    broadcast_ints([FT_FAILED, -1])
                except RuntimeError:  # the others are gone already
                    pass
            raise
        if process_count() > 1:
            broadcast_ints([FT_DONE, -1])
            dist.broadcast_object_list([means], src=0)
        return means

    def _finetune_lead(self, payload) -> Dict[str, float]:
        """The finetune's steps, checkpoints and validations (rank 0)."""
        cfg, tc = self.cfg, self.cfg.train
        dataset = get_dataset(cfg.finetune_dataset, "finetune", self.rng)
        if "volumes" in payload["params"]:
            _, arrays = load_finetune_checkpoint(self.model, payload)
            volumes, masks, features = (
                [a.to(self.device) for a in arrays[k]]
                for k in ("volumes", "mask_volumes", "features"))
        else:
            load_params(self.model, payload)
            raw = self._tensors(dataset.get_all_images())
            self._sync()
            t0 = time.perf_counter()
            volumes, masks, features = self.model.init_volumes(
                raw["imgs"], raw["intrs"], raw["c2ws"])
            self._sync()
            self.init_volumes_s = time.perf_counter() - t0
        step_fn = FinetuneStep(self.model, cfg, volumes, masks, features)
        self.ft_step = step_fn
        ckpt_dir = os.path.join(self.exp_dir, "checkpoints")
        avg = DictAverageMeter()
        perm = self.rng.permutation(dataset.num_views)
        for step in range(tc.epochs):
            if process_count() > 1:
                broadcast_ints([FT_STEP, step])
            vid = int(perm[step % len(perm)])
            raw = dataset.get_random_rays(vid)
            inputs = self._tensors(raw)
            inputs["view_ids"] = torch.from_numpy(raw["view_ids"]).to(
                self.device)
            self._sync()
            t0 = time.perf_counter()
            metrics = step_fn(inputs, cos_anneal_ratio(step, tc.anneal_end),
                              generator=self.generator)
            scalars = dict(zip(metrics, torch.stack(
                list(metrics.values())).tolist()))
            seconds = time.perf_counter() - t0
            self.finetune_stats.append({"step": step, "vid": vid,
                                        "step_s": seconds, **scalars})
            avg.update(scalars)
            if (step + 1) % len(perm) == 0:
                perm = self.rng.permutation(dataset.num_views)
            if (step + 1) % max(1, int(tc.log_freq)) == 0:
                print(f"[finetune] step {step} view {vid}: loss "
                      f"{scalars['loss']:.5f} psnr {scalars['psnr']:.3f} "
                      f"({seconds:.3f} s)", flush=True)
                self.logger.log("finetune", scalars, step)
            last = step + 1 >= tc.epochs
            if (step + 1) % tc.save_freq == 0 or last:
                save_finetune_checkpoint(
                    os.path.join(ckpt_dir, f"model_{step:03d}.ckpt"), step,
                    self.model, step_fn.volumes, step_fn.mask_volumes,
                    step_fn.features)
            if (step + 1) % tc.val_freq == 0 or last:
                if process_count() > 1:
                    broadcast_ints([FT_VALIDATE, step])
                self._ft_validating = True
                self._finetune_validate(step_fn, dataset, step)
                self._ft_validating = False
        return avg.avg_data

    def _finetune_follow(self, payload) -> Dict[str, float]:
        """A rank other than 0 in a finetune: the checkpoint's modules
        (rank 0 sends the finetuned ones at each validation), then rank 0's
        messages until it is done."""
        if "volumes" in payload["params"]:
            load_finetune_checkpoint(self.model, payload)
        else:
            load_params(self.model, payload)
        while True:
            code, step = broadcast_ints([0, 0])
            if code == FT_VALIDATE:
                self._finetune_validate(None, None, step)
            elif code == FT_DONE:
                means = [None]
                dist.broadcast_object_list(means, src=0)
                return means[0]
            elif code == FT_FAILED:
                raise RuntimeError("rank 0 failed in the finetune")

    @torch.no_grad()
    def _finetune_validate(self, step_fn: Optional[FinetuneStep], dataset,
                           step: int) -> None:
        """K3 mesh of the finetuned volumes and the chunked render of view
        0's val grid; appends the call's seconds and counts to
        ``finetune_stats``. Under several ranks every rank calls it (the
        others with no ``step_fn`` and ``dataset``): rank 0 sends the
        finetuned sdf, blending and variance modules, the scene and the
        rays, and the render splits over the world."""
        group = None
        if process_count() > 1:
            group = self._val_group(1)
            params = [t for top in FINETUNE_MODULES
                      for t in getattr(self.model, top).state_dict().values()]
            got, _, _ = broadcast_tensors(
                params if group.is_leader else None, None, group,
                self.device)
            if not group.is_leader:
                for t, v in zip(params, got):
                    t.copy_(v)
        scene = raw = inputs = None
        if step_fn is not None:
            raw = dataset.get_rays_at(0)
            inputs = self._tensors(raw)
            view_ids = torch.from_numpy(raw["view_ids"]).to(self.device)
            feats = [f.index_select(0, view_ids) for f in step_fn.features]
            scene = Scene(volumes=[v.detach() for v in step_fn.volumes],
                          mask_volumes=step_fn.mask_volumes, features=feats,
                          match_features=feats, imgs=inputs["imgs"],
                          intrs=inputs["intrs"], c2ws=inputs["c2ws"])
        st, _ = self._mesh_and_render(scene, raw, inputs, f"step{step}",
                                      f"ft{step}", group=group)
        self.finetune_stats.append({"val_step": step, **st})

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensors(self, raw: Dict) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device) for k, v in _float_arrays(raw).items()}

    def _val_group(self, n_scenes: int) -> ValGroup:
        """This rank's validation group for ``n_scenes`` scenes, built on
        first use (collective then)."""
        key = (process_count(), n_scenes)
        if key not in self._val_groups:
            self._val_groups[key] = val_groups(n_scenes)
        return self._val_groups[key]

    def render_chunked(self, scene: Scene, inputs, chunk: int = 512,
                       group: Optional[ValGroup] = None
                       ) -> Optional[Dict[str, np.ndarray]]:
        """Chunked full-image render at a fixed chunk size (the rays padded
        with copies of the last ray); with a ``group`` of several ranks
        this rank's share of the chunks, the whole render returned on the
        leader and None on the others."""
        return split_render(self.model.renderer, scene, inputs, chunk,
                            group)[0]

    @torch.no_grad()
    def validate(self, epoch: int = 0) -> Dict[str, float]:
        """Per scene: build, mesh, render, metrics. Records per-scene
        seconds and counts in ``self.stats``, the last scene and its SDF
        grid in ``last_scene`` / ``last_sdf_grid``; returns mean metrics.
        Several ranks (collective: every rank calls it): the scenes go to
        the groups of ``val_partition``; each rank records its own render
        seconds and rays, the leader also the mesh and the metrics, and
        the means are over every leader's scenes."""
        cfg = self.cfg
        dataset = get_dataset(cfg.val_dataset, "val", self.rng)
        group = self._val_group(len(dataset))
        self.stats = []
        avg = DictAverageMeter()
        for idx in group.scenes:
            scene = raw = inputs = None
            st = {}
            if group.is_leader:
                raw = dataset[idx]
                inputs = self._tensors(raw)
                st["scene"] = raw["scene"]
                self._sync()
                t0 = time.perf_counter()
                scene = self.model.build_scene(
                    inputs["imgs"], inputs["intrs"], inputs["c2ws"])
                self._sync()
                st["build_scene_s"] = time.perf_counter() - t0
            mesh_st, rend = self._mesh_and_render(
                scene, raw, inputs, f"epoch{epoch}", epoch,
                clean=cfg.clean_mesh, group=group)
            st.update(mesh_st)
            if raw is None:
                self.stats.append(st)
                continue
            h, w = int(raw["hw"][0]), int(raw["hw"][1])
            scalars = {k: st[k] for k in ("psnr", "color_loss")}
            depth_ref = subsample_to_val_grid(np.asarray(raw["depth_ref"]),
                                              h, w)
            dmask = (depth_ref > 0).astype(np.float32)
            for name in ("render_depth", "sdf_depth"):
                d = rend[name].reshape(h, w)
                err = (np.abs(d - depth_ref) * dmask).sum()
                scalars[name + "_loss"] = float(err / (dmask.sum() + 1e-8))
            st.update(scalars)
            self.stats.append(st)
            avg.update(scalars)
            self.logger.log("val", scalars, epoch * 1000 + idx)
        sums = allreduce_host_sums([avg.count] + [
            avg.sum.get(k, 0.0) for k in self.VAL_METRIC_KEYS])
        means = {k: float(sums[1 + i]) / max(float(sums[0]), 1.0)
                 for i, k in enumerate(self.VAL_METRIC_KEYS)}
        self.logger.log("val_avg", means, epoch)
        return means

    def _mesh_and_render(self, scene: Optional[Scene], raw: Optional[Dict],
                         inputs, name: str, tag, clean: bool = False,
                         group: Optional[ValGroup] = None
                         ) -> Tuple[Dict, Optional[Dict[str, np.ndarray]]]:
        """Extract the scene's mesh through K3, clean it by ``raw``'s masks
        and cameras when ``clean`` (as the JAX ``Runner.validate`` does; its
        finetune validation does not), write it as
        ``meshes/<scene>_<name>.ply``, render ``inputs``' rays in chunks and
        save the images under ``tag``. Returns (seconds, counts, PSNR and
        colour L1 against ``raw["color"]``; the render). The SDF grid is
        kept in ``last_sdf_grid``, the render in ``last_render``. With a
        ``group`` of several ranks every member calls it: the leader (the
        one with ``scene``, ``raw`` and ``inputs``) broadcasts the scene
        and the rays, the render splits over the group, and only the
        leader meshes, writes and scores; the others get (their render
        seconds, rays and transfer counts; None)."""
        st = {"group_size": 1 if group is None else group.size}
        rays = None if inputs is None else {k: inputs[k] for k in RAY_KEYS}
        if group is not None and group.size > 1:
            self._sync()
            t0 = time.perf_counter()
            scene, rays, scene_name, st["broadcast_bytes"] = \
                broadcast_scene(scene, rays, None if raw is None
                                else raw["scene"], group, self.device)
            self._sync()
            st["broadcast_s"] = time.perf_counter() - t0
            st["scene"] = scene_name
            if group.is_leader:
                print(f"[val] {scene_name}: broadcast "
                      f"{st['broadcast_bytes']} B to {group.size - 1} "
                      f"rank(s) in {st['broadcast_s']:.3f} s", flush=True)
        self.last_scene = scene
        if raw is not None:
            st.update(self._mesh(scene, raw, name, clean))
        rend, render_st = split_render(self.model.renderer, scene, rays,
                                       group=group)
        st.update(render_st)
        st["rays_per_s"] = st["rays"] / st["render_s"]
        if raw is None:
            return st, None
        self.last_render = rend
        st["render_finite"] = bool(all(np.isfinite(v).all()
                                       for v in rend.values()))
        h, w = int(raw["hw"][0]), int(raw["hw"][1])
        self._save_val_images(raw, rend, (h, w), tag)
        color = rend["color_fine"].reshape(h, w, 3)
        gt = np.asarray(raw["color"]).reshape(h, w, 3)
        mse = float(((color - gt) ** 2).mean())
        st["psnr"] = 20.0 * np.log10(1.0 / np.sqrt(mse + 1e-12))
        st["color_loss"] = float(np.abs(color - gt).mean())
        return st, rend

    def _mesh(self, scene: Scene, raw: Dict, name: str, clean: bool
              ) -> Dict:
        """The mesh of ``_mesh_and_render``; its seconds and counts."""
        st = {}
        t0 = time.perf_counter()
        sdf_fn = self.model.renderer.sdf_fn_for_extraction(scene.volumes)
        grid = eval_sdf_grid(sdf_fn, raw["bound_min"], raw["bound_max"],
                             self.cfg.mesh_resolution, self.device)
        st["mesh_grid_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        verts, tris = grid_to_mesh(grid, raw["bound_min"], raw["bound_max"])
        st["isosurface_s"] = time.perf_counter() - t0
        st["n_tris"] = int(len(tris))
        st["grid_finite"] = bool(np.isfinite(grid).all())
        self.last_sdf_grid = grid
        if clean and len(verts):
            t0 = time.perf_counter()
            verts, tris = clean_mesh(verts, tris, np.asarray(raw["masks"]),
                                     np.asarray(raw["intrs"]),
                                     np.asarray(raw["c2ws"]))
            st["clean_s"] = time.perf_counter() - t0
            st["n_tris_clean"] = int(len(tris))
        if len(verts):
            verts = apply_transform(verts, np.asarray(raw["scale_mat"]))
        mesh_dir = os.path.join(self.exp_dir, "meshes")
        os.makedirs(mesh_dir, exist_ok=True)
        write_ply(os.path.join(mesh_dir, f"{raw['scene']}_{name}.ply"),
                  verts, tris)
        return st

    def _save_val_images(self, raw, rend, hw, tag):
        h, w = hw
        name = raw.get("file_name", raw.get("scene", "val"))
        out_img = (rend["color_fine"].reshape(h, w, 3) * 256).clip(0, 255)
        rot = np.linalg.inv(np.asarray(raw["c2ws"])[0, :3, :3])
        normal = rend["normal"].reshape(-1, 3) @ rot.T
        normal_img = (normal.reshape(h, w, 3) * 128 + 128).clip(0, 255)
        images = [("val_img", out_img.astype(np.uint8)),
                  ("val_normal", normal_img.astype(np.uint8))]
        for sub in ("render_depth", "sdf_depth"):
            images.append(("val_" + sub, magma(rend[sub].reshape(h, w),
                                               0.0, 2.5)))
        for sub, arr in images:
            d = os.path.join(self.exp_dir, sub)
            os.makedirs(d, exist_ok=True)
            write_png(os.path.join(d, f"{name}_epoch{tag}.png"), arr)


def check_row_batch(host: Dict[str, torch.Tensor], layout: RankLayout
                    ) -> None:
    """The ranks of a view group decode the same item through identically
    seeded draws; a checksum of the batch, compared over the group
    (collective), proves they hold the same one."""
    if layout.view_group is None:
        return
    c = float(sum(float(v.double().sum()) for v in host.values()))
    hi, neg_lo = allreduce_host([c, -c], op=dist.ReduceOp.MAX,
                                group=layout.view_group)
    if hi != -neg_lo:
        raise RuntimeError(
            f"the ranks of data row {layout.data_row} decoded different "
            f"batches (checksums {-neg_lo} to {hi})")
