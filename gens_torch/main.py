"""CLI entry point (counterpart of gens_tpu/main.py).

Usage:
    python -m gens_torch.main --conf confs/dtu.yaml [--mode train] \
        [--resume CKPT | --resume auto]
    python -m gens_torch.main --conf confs/dtu.yaml --mode val --resume CKPT \
        [--mesh_resolution N] [--clean_mesh]
    python -m gens_torch.main --conf confs/dtu_finetune.yaml --mode finetune \
        --resume CKPT [--scene scan24 --ref_view 23]
    python -m gens_torch.main ... --device cpu   # the CPU, on request only
    torchrun --nproc_per_node=N -m gens_torch.main --conf confs/dtu.yaml \
        --set parallel.data=D parallel.view=V    # N == D * V ranks

The port runs on the card: without a CUDA device and without
``--device cpu`` it raises. Several ranks (torchrun, RANK / WORLD_SIZE /
MASTER_ADDR / MASTER_PORT set by hand, or srun; see
``parallel/distributed.py``) join one process group before the runner
starts: rank r takes ``cuda:{LOCAL_RANK}``, and NCCL carries the
collectives (gloo for ``--device cpu``, or with ``--dist_backend gloo``
for ranks that share a card named by ``--device cuda:0``).
"""

from __future__ import annotations

import argparse

import torch

from gens_torch.config import Config, load_config
from gens_torch.parallel import distributed
from gens_torch.runner import Runner


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: gens_torch runs on the GPU; pass --device cpu "
            "to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def parse_args(argv=None) -> argparse.Namespace:
    """The command line, with the JAX CLI's modes, default and flags
    (gens_tpu/main.py) and the port's ``--device``."""
    parser = argparse.ArgumentParser("gens_torch")
    parser.add_argument("--conf", type=str, default=None,
                        help="JSON/YAML config file")
    parser.add_argument("--mode", type=str, default="train",
                        choices=["train", "val", "finetune"])
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--mesh_resolution", type=int, default=None)
    parser.add_argument("--clean_mesh", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (rank r: cuda:LOCAL_RANK), cuda:N or cpu")
    parser.add_argument("--dist_backend", type=str, default=None,
                        choices=["nccl", "gloo"],
                        help="several ranks: nccl for the card, gloo for "
                        "the CPU (the default follows --device); gloo "
                        "for ranks that share one card")
    parser.add_argument("--scene", type=str, default=None,
                        help="finetune: the scene (finetune_dataset.scene)")
    parser.add_argument("--ref_view", type=int, default=None,
                        help="finetune: the reference view")
    parser.add_argument("--set", dest="overrides", nargs="*", default=[],
                        help="dotted overrides, e.g. mesh_resolution=256")
    return parser.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> Config:
    """The config file with the ``--set`` overrides, then the mode and the
    flags on top, in the order gens_tpu/main.py applies them."""
    cfg = load_config(args.conf, args.overrides)
    cfg.mode = args.mode
    if args.mesh_resolution is not None:
        cfg.mesh_resolution = args.mesh_resolution
    if args.clean_mesh:
        cfg.clean_mesh = True
    if args.scene is not None:
        cfg.finetune_dataset.scene = (args.scene,)
    if args.ref_view is not None:
        cfg.finetune_dataset.ref_view = (args.ref_view,)
    return cfg


def main(argv=None) -> Runner:
    args = parse_args(argv)
    penv = distributed.detect_process_env()
    device = resolve_device(args.device)
    if penv.is_distributed and device.type == "cuda":
        device = distributed.rank_device(
            args.device, distributed.detect_local_rank(penv),
            torch.cuda.device_count())
        torch.cuda.set_device(device)
    if args.mode == "finetune" and not args.resume:
        raise ValueError("--mode finetune needs a checkpoint (--resume)")
    cfg = config_from_args(args)
    distributed.initialize(
        penv, args.dist_backend or distributed.default_backend(device))
    try:
        runner = Runner(cfg, device)
        try:
            runner.metrics = runner.run(resume=args.resume)
        finally:
            runner.close()
    finally:
        distributed.shutdown()
    print({k: round(v, 6) for k, v in runner.metrics.items()}, flush=True)
    return runner


if __name__ == "__main__":
    main()
