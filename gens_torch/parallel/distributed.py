"""Multi-process plumbing (counterpart of gens_tpu/parallel/distributed.py):
rank detection, the process group, the rank layout of the ('data', 'view')
axes and the host-side reductions.

One process per rank. Launch contract, as the JAX package's:

    # torchrun (sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    torchrun --nproc_per_node=N -m gens_torch.main --conf ... \
        --set parallel.data=D parallel.view=V          # N == D * V

    # explicit env vars (any launcher)
    RANK=r WORLD_SIZE=n LOCAL_RANK=l MASTER_ADDR=host0 MASTER_PORT=port \
        python -m gens_torch.main --conf ...

    # SLURM (srun sets SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID,
    # SLURM_NODELIST)
    srun python -m gens_torch.main --conf ...

Rank r owns data row r // V and view column r % V; the V ranks of a data
row form its view group (:func:`make_layout`). A validation splits its S
scenes over min(W, S) groups of contiguous ranks (:func:`val_partition`):
a group renders each of its scenes with the rays split over its ranks.
Rank r runs on
``cuda:{LOCAL_RANK}`` (:func:`rank_device`); the collectives ride NCCL for
CUDA tensors and gloo for CPU tensors, or gloo when asked (ranks that share
one card: NCCL refuses two ranks on one device). A single process skips
initialization, and every helper then degrades to the local behaviour.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# a rank that waits longer than this in a collective raises instead of
# hanging: long enough for a validation scene that another rank still
# renders
TIMEOUT = timedelta(minutes=30)


@dataclass
class ProcessEnv:
    """Resolved multi-process coordinates."""

    rank: int
    world_size: int
    coordinator: Optional[str]  # address:port of rank 0

    @property
    def is_distributed(self) -> bool:
        return self.world_size > 1


def detect_process_env(default_port: int = 29400) -> ProcessEnv:
    """Read process coordinates from the environment.

    Priority: explicit RANK/WORLD_SIZE -> SLURM -> single process. The
    coordinator address comes from COORDINATOR_ADDRESS, else MASTER_ADDR
    [+ MASTER_PORT] (torchrun's), else the first SLURM node.
    """
    env = os.environ
    coordinator = env.get("COORDINATOR_ADDRESS")
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = (
            f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', default_port)}")

    if "RANK" in env and "WORLD_SIZE" in env:
        return ProcessEnv(int(env["RANK"]), int(env["WORLD_SIZE"]),
                          coordinator)
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        if coordinator is None:
            nodelist = env.get("SLURM_NODELIST", "")
            # first entry of a SLURM nodelist; bracketed ranges take the
            # first index ("host[3-7,9]" -> "host3")
            head = nodelist.split(",")[0]
            if "[" in head:
                prefix, rng = head.split("[", 1)
                head = prefix + rng.split("-")[0].split(",")[0].rstrip("]")
            coordinator = f"{head}:{default_port}" if head else None
        return ProcessEnv(int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                          coordinator)
    return ProcessEnv(0, 1, coordinator)


def detect_local_rank(penv: ProcessEnv) -> int:
    """This process's index among the ranks of its host: LOCAL_RANK
    (torchrun), else SLURM_LOCALID, else the global rank (one host)."""
    env = os.environ
    for key in ("LOCAL_RANK", "SLURM_LOCALID"):
        if key in env:
            return int(env[key])
    return penv.rank


def rank_device(name: str, local_rank: int, n_cards: int) -> torch.device:
    """The device rule: a bare "cuda" is ``cuda:{local_rank}``, which must
    exist; a named device ("cuda:0", "cpu") is taken as given, so ranks
    share a card only when the caller names it."""
    device = torch.device(name)
    if device.type != "cuda" or device.index is not None:
        return device
    if local_rank >= n_cards:
        raise RuntimeError(
            f"local rank {local_rank} has no card of its own ({n_cards} "
            "visible): launch at most one rank per card, or name a device "
            "(--device cuda:0) and --dist_backend gloo to share one")
    return torch.device("cuda", local_rank)


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize(penv: ProcessEnv, backend: str,
               timeout: timedelta = TIMEOUT) -> None:
    """Join the process group of ``penv`` (idempotent; a single process is
    a no-op). Call once per process before any collective."""
    if not penv.is_distributed or dist.is_initialized():
        return
    if penv.coordinator is None:
        raise RuntimeError(
            "no coordinator: set MASTER_ADDR[/MASTER_PORT] or "
            "COORDINATOR_ADDRESS (torchrun and srun set them)")
    dist.init_process_group(backend, init_method=f"tcp://{penv.coordinator}",
                            world_size=penv.world_size, rank=penv.rank,
                            timeout=timeout)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0 writes the checkpoints, the metrics log and the code
    backup."""
    return process_index() == 0


def comm_device() -> torch.device:
    """Where host values go for a collective: the current card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allreduce_host(vec, op=dist.ReduceOp.SUM, group=None) -> np.ndarray:
    """Reduce a small host vector over ``group`` (the world by default);
    every member must call it. A single process returns it as it is."""
    vec = np.asarray(vec, np.float64)
    if not dist.is_initialized():
        return vec
    t = torch.from_numpy(vec.copy()).to(comm_device())
    dist.all_reduce(t, op=op, group=group)
    return t.cpu().numpy()


def allreduce_host_sums(vec) -> np.ndarray:
    """Sum a small host vector over every process (the validation's
    ``[count, Σ metric…]``); collective."""
    return allreduce_host(vec)


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


@dataclass
class RankLayout:
    """This rank's place on the ('data', 'view') axes: data row
    ``rank // n_view``, view column ``rank % n_view``. ``view_group`` is
    the process group of the row's ranks (None when ``n_view`` is 1: the
    view collectives are then skipped)."""

    n_data: int
    n_view: int
    rank: int
    view_group: Optional[object] = None

    @property
    def data_row(self) -> int:
        return self.rank // self.n_view

    @property
    def view_col(self) -> int:
        return self.rank % self.n_view


def make_layout(n_data: int, n_view: int) -> RankLayout:
    """The layout of this rank in a world of ``n_data * n_view`` ranks,
    with the view group of every data row built (collective: every rank
    creates every group, in the same order)."""
    world = process_count()
    if world != n_data * n_view:
        raise ValueError(
            f"parallel.data={n_data} x parallel.view={n_view} needs "
            f"{n_data * n_view} ranks, and {world} are running: launch one "
            "process per rank (README, 'Multi-GPU')")
    rank = process_index()
    layout = RankLayout(n_data, n_view, rank)
    if n_view > 1:
        for d in range(n_data):
            group = dist.new_group(list(range(d * n_view, (d + 1) * n_view)))
            if d == layout.data_row:
                layout.view_group = group
    return layout


def rank_seed(seed: int, data_row: int, view_col: int) -> int:
    """The seed of a rank's generator: the JAX step folds its key by the
    (data, view) index."""
    return int(np.random.SeedSequence([seed, data_row, view_col])
               .generate_state(1)[0])


# --- validation groups ------------------------------------------------------


def val_partition(world: int, n_scenes: int
                  ) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """The validation's (ranks, scenes) groups: g = min(world, n_scenes)
    groups of contiguous ranks, group k holding ranks [k·W // g,
    (k+1)·W // g) and scenes k, k + g, k + 2g, …. With at least as many
    scenes as ranks every group is one rank and rank r takes scenes r,
    r + W, …; with fewer, a scene's rays split over its group's ranks."""
    g = min(world, n_scenes)
    return [(tuple(range(k * world // g, (k + 1) * world // g)),
             tuple(range(k, n_scenes, g))) for k in range(g)]


@dataclass
class ValGroup:
    """This rank's validation group: its ranks (the first is the leader,
    which builds each scene, meshes it and scores it), its scenes, and the
    process group (None when the group is this rank alone)."""

    ranks: Tuple[int, ...]
    scenes: Tuple[int, ...]
    rank: int
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        return self.ranks.index(self.rank)

    @property
    def leader(self) -> int:
        return self.ranks[0]

    @property
    def is_leader(self) -> bool:
        return self.rank == self.leader


def val_groups(n_scenes: int) -> ValGroup:
    """This rank's group of :func:`val_partition` over the running world.
    Collective when a group has several ranks: every rank creates every
    such group in the same order (one group spanning the world is the
    world's own). With no scene, each rank is alone with none."""
    world, rank = process_count(), process_index()
    if n_scenes == 0:
        return ValGroup((rank,), (), rank)
    mine = None
    for ranks, scenes in val_partition(world, n_scenes):
        group = None
        if len(ranks) == world and world > 1:
            group = dist.group.WORLD
        elif len(ranks) > 1:
            group = dist.new_group(list(ranks))
        if rank in ranks:
            mine = ValGroup(ranks, scenes, rank, group)
    return mine


def broadcast_tensors(tensors: Optional[Sequence[torch.Tensor]], info,
                      group: ValGroup, device: torch.device
                      ) -> Tuple[List[torch.Tensor], object, int]:
    """The leader's ``tensors`` and picklable ``info`` on every member of
    ``group`` (collective; the others pass None for both). One object
    broadcast carries the shapes and dtypes, one byte buffer on ``device``
    the data: the members get views of it, bit for bit the leader's
    values, and the leader its own tensors. Returns (tensors, info, bytes
    of the buffer)."""
    align = 256  # every view starts on a 256-byte boundary of the buffer
    lead = group.is_leader
    meta = [None]
    if lead:
        meta = [([(tuple(t.shape), t.dtype) for t in tensors], info)]
    dist.broadcast_object_list(meta, src=group.leader, group=group.group)
    shapes, info = meta[0]
    offsets, total = [], 0
    for shape, dtype in shapes:
        offsets.append(total)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        total += -(-n // align) * align
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    if lead:
        for t, off in zip(tensors, offsets):
            flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
            buf[off:off + flat.numel()].copy_(flat)
    dist.broadcast(buf, group.leader, group=group.group)
    if lead:
        return list(tensors), info, total
    out = []
    for (shape, dtype), off in zip(shapes, offsets):
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out.append(buf[off:off + n].view(dtype).view(shape))
    return out, info, total


def gather_rows(x: torch.Tensor, group: ValGroup
                ) -> Optional[List[torch.Tensor]]:
    """Every member's ``x`` (equal shapes) in the group's rank order on the
    leader, on :func:`comm_device` (gloo gathers no CUDA tensor), and None
    on the others (collective)."""
    y = x.to(comm_device())
    parts = [torch.empty_like(y) for _ in range(group.size)]
    dist.all_gather(parts, y, group=group.group)
    return parts if group.is_leader else None


def broadcast_ints(values: Sequence[int], src: int = 0) -> List[int]:
    """Rank ``src``'s small integer vector on every rank (collective; the
    others pass a vector of the same length). A single process returns
    it."""
    if not dist.is_initialized():
        return list(values)
    t = torch.tensor(list(values), dtype=torch.int64, device=comm_device())
    dist.broadcast(t, src)
    return [int(v) for v in t.tolist()]
