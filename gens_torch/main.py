"""CLI entry point (counterpart of gens_tpu/main.py).

Usage:
    python -m gens_torch.main --conf confs/dtu.yaml [--mode train] \
        [--resume CKPT | --resume auto]
    python -m gens_torch.main --conf confs/dtu.yaml --mode val --resume CKPT \
        [--mesh_resolution N] [--clean_mesh]
    python -m gens_torch.main --conf confs/dtu_finetune.yaml --mode finetune \
        --resume CKPT [--scene scan24 --ref_view 23]
    python -m gens_torch.main ... --device cpu   # the CPU, on request only

The port runs on the card: without a CUDA device and without
``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse

import torch

from gens_torch.config import Config, load_config
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
    parser.add_argument("--device", type=str, default="cuda")
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
    device = resolve_device(args.device)
    if args.mode == "finetune" and not args.resume:
        raise ValueError("--mode finetune needs a checkpoint (--resume)")
    cfg = config_from_args(args)
    runner = Runner(cfg, device)
    try:
        runner.metrics = runner.run(resume=args.resume)
    finally:
        runner.close()
    print({k: round(v, 6) for k, v in runner.metrics.items()}, flush=True)
    return runner


if __name__ == "__main__":
    main()
