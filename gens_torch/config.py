"""Typed configuration tree for gens_torch.

The port keeps its own copy of the JAX package's config tree
(``gens_tpu/config.py``) so that every ``confs/*.yaml`` loads unchanged:
plain dataclasses, a JSON/YAML loader and dotted-path ``--set`` overrides.
Defaults reproduce the published GenS DTU recipe.

Keys that only choose a TPU memory layout are accepted and change no math
in the port: ``volume.packed_bilerp`` (except its bf16 rounding and the
splat backward, below), ``volume.splat_window``,
``volume.agg_remat``, ``sdf_network.packed_trilerp``,
``sdf_network.fused_*``, ``color_network.packed_bilerp``,
``color_network.fused_pyramid`` and ``compilation_cache_dir``.

The dtype keys are honoured as casts at the places the JAX code casts:
``volume.dtype`` (the emitted raw volumes), ``reg_network.dtype`` (U-Net
activations), ``sdf_network.volume_dtype`` (the cascade inside the trilerp),
``sdf_network.mlp_dtype`` and ``color_network.mlp_dtype`` (MLP compute),
``color_network.packed_dtype`` (source-view maps when
``color_network.packed_bilerp`` is on), and ``volume.packed_bilerp`` in
{"table_bf16", "pallas"}, whose aggregation forward reads bf16-rounded
feature values and whose backward is the splat K1, in f32 or, under
"pallas" at scales whose dim is a multiple of 16, with the operand
rounding of ``volume.splat_mm_dtype``.

``volume.splat_impl`` is honoured at those scales, as the JAX function
resolves it: "auto" and "kernel2" sample the bf16-rounded map and take K1
in the shipped "fused_u" rounding (bf16(hat_v)·bf16(hat_u·ct)); "kernel"
the same forward and K1 in the r03 "per_channel" rounding
(bf16(hat_v·ct)·bf16(hat_u)); "kernel2f" the K2 forward
(``ops/window_fwd.py``: bf16(hat_v) against the bf16 map, or the exact
bilerp under ``splat_mm_dtype`` float32) and K1 in the fused_u rounding;
"adjoint" the bf16-rounded forward and the exact f32 adjoint whatever
``splat_mm_dtype`` says. "auto" resolves as the JAX function does on a
TPU (on its CPU, JAX resolves it to "adjoint").
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


@dataclass
class FeatureNetConfig:
    # per-scale output channels, fine-to-coarse (reference confs/gens.conf:64)
    d_out: Tuple[int, ...] = (4, 4, 4, 4, 4)
    # encoder channels per stride stage (strides 2, 4, 8, 16, 32)
    d_enc: Tuple[int, ...] = (16, 24, 40, 96, 160)
    norm: str = "instance"
    # "fpn" (self-contained, default) or "mnasnet" (reference backbone;
    # load ported ImageNet weights via scripts/convert_mnasnet_weights.py +
    # pretrained_path). MnasNet BN running stats are frozen during training.
    backbone: str = "fpn"
    pretrained_path: Optional[str] = None


@dataclass
class VolumeConfig:
    # cascade resolutions, fine-to-coarse (reference confs/gens.conf:67)
    volume_dims: Tuple[int, ...] = (256, 128, 64, 32, 16)
    # a voxel is valid if seen by strictly more than this many views
    # (reference models/modules/volume.py:58)
    min_vis_view: int = 1
    # dtype of the emitted raw volumes ("float32" | "bfloat16"); per-view
    # sums always accumulate in fp32. bf16 halves the 256³ mean/var cascade
    # and makes its autodiff cotangents half-width too.
    dtype: str = "float32"
    # the JAX aggregation's gather layout (False | True | "diff" | "table" |
    # "table_bf16" | "pallas"); in the port "table_bf16" and "pallas" read
    # bf16-rounded feature maps and take the splat K1 as their backward
    packed_bilerp: object = "table"
    # TPU layout key of the JAX splat kernels' window: accepted, unused
    # (the port's kernels need no window)
    splat_window: object = "auto"
    # the aggregation's sampling under packed_bilerp "pallas" ("auto" |
    # "kernel2": bf16 forward, K1 fused_u rounding; "kernel": K1 per_channel
    # rounding; "kernel2f": K2 forward; "adjoint": exact f32 backward)
    splat_impl: str = "auto"
    # K1's operand rounding under packed_bilerp "pallas" ("bfloat16" |
    # "float32", the exact adjoint)
    splat_mm_dtype: str = "bfloat16"
    # TPU remat policy of the JAX aggregation: accepted, unused
    agg_remat: str = "full"
    # cross-view aggregation: "mean_var" (reference live path) or "adaptive"
    # (learned softmax weighting — the reference's dead agg_adaptive made
    # functional; emits C channels/scale, so set reg_network.d_volume to
    # match)
    agg: str = "mean_var"


@dataclass
class RegNetConfig:
    # raw volume channels per scale = 2 * feature channels (mean+var)
    d_volume: Tuple[int, ...] = (8, 8, 8, 8, 8)
    d_out: Tuple[int, ...] = (4, 4, 4, 4, 4)
    d_base: int = 8
    # activation dtype for the U-Net ("float32" | "bfloat16"); params stay
    # fp32, norm statistics accumulate in fp32. bf16 halves the dominant
    # 256³ activation/residual buffers (HBM is the constraint on one chip).
    dtype: str = "float32"
    # bottleneck transformer over the coarsest encoder level (the
    # reference's commented-out GlobalAttn, reg_network.py:138,153)
    use_global_attn: bool = False


@dataclass
class SDFNetConfig:
    d_in: int = 3
    d_out: int = 129  # 1 sdf + 128 latent
    d_hidden: int = 128
    n_layers: int = 6
    skip_in: Tuple[int, ...] = (3,)
    multires: int = 4
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    inside_outside: bool = False
    feat_channels: int = 20  # 5 scales x 4 channels of volume features
    feat_multires: int = 2
    # dtype of the volume cascade inside the trilerp gather; bfloat16 halves
    # the gather traffic of the hottest op (lerp/MLP still run f32)
    volume_dtype: str = "float32"
    # TPU gather layouts of the cascade lookup (fused, supercell-packed,
    # single-gather): accepted, unused
    fused_cascade: bool = False
    packed_trilerp: bool = False
    fused_packed: bool = False
    fused_sampling_only: bool = False
    # compute dtype of the SDF MLP ("float32" | "bfloat16"); params stay
    # f32, outputs return f32
    mlp_dtype: str = "float32"


@dataclass
class BlendingNetConfig:
    d_feature: int = 20
    anti_alias_pooling: bool = True
    # color head: "blending" (IBRNet source-view blending, the reference's
    # live path) or "idr" (surface-light-field MLP on the SDF latent — the
    # reference's never-instantiated RenderingNetwork made functional; useful
    # when no source-view features exist to blend)
    head: str = "blending"
    # TPU gather layouts of the source-view warps: accepted; with
    # packed_bilerp on, packed_dtype bfloat16 rounds the maps to bf16
    packed_bilerp: bool = False
    fused_pyramid: bool = False
    packed_dtype: str = "float32"
    # compute dtype of the blending MLPs ("float32" | "bfloat16"); params
    # stay f32, outputs return f32 (same contract as sdf_network.mlp_dtype)
    mlp_dtype: str = "float32"
    # idr-head hyperparameters (reference rendering_network.py:90-151)
    idr_mode: str = "idr"  # idr | no_view_dir | no_normal
    idr_d_hidden: int = 256
    idr_n_layers: int = 4
    idr_multires_view: int = 4


@dataclass
class VarianceConfig:
    init_val: float = 0.3


@dataclass
class RenderConfig:
    n_samples: int = 64
    n_importance: int = 64
    up_sample_steps: int = 4
    perturb: float = 1.0
    # MFC patch warp
    patch_size: int = 11
    # number of feature scales stacked for the patch warp (scales 0..k-1)
    warp_scales: int = 3
    # number of random points for the sparse SDF regularizer
    n_sparse_pts: int = 1024


@dataclass
class ModelConfig:
    feature_network: FeatureNetConfig = field(default_factory=FeatureNetConfig)
    volume: VolumeConfig = field(default_factory=VolumeConfig)
    reg_network: RegNetConfig = field(default_factory=RegNetConfig)
    sdf_network: SDFNetConfig = field(default_factory=SDFNetConfig)
    color_network: BlendingNetConfig = field(default_factory=BlendingNetConfig)
    variance_network: VarianceConfig = field(default_factory=VarianceConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    # sync cadence (epochs) of the frozen matching feature net
    # (reference models/gens.py:133-138)
    match_sync_every: int = 5


@dataclass
class LossConfig:
    color_weight: float = 1.0
    sparse_weight: float = 0.02
    igr_weight: float = 0.1
    sparse_scale_factor: float = 100.0
    mfc_weight: float = 1.0
    smooth_weight: float = 1e-4
    tv_weight: float = 1e-4
    depth_weight: float = 0.0
    pseudo_sdf_weight: float = 1.0
    pseudo_depth_weight: float = 0.05


@dataclass
class DatasetConfig:
    dataset_name: str = "dtu"
    data_dir: str = ""
    split: Optional[str] = "train"
    scene: Optional[Tuple[str, ...]] = None
    light_idx: Optional[Tuple[int, ...]] = (3,)
    ref_view: Optional[Tuple[int, ...]] = None
    num_src_view: int = 4
    factor: float = 1.0
    interval_scale: float = 1.0
    num_interval: int = 192
    img_hw: Tuple[int, int] = (480, 640)
    n_rays: int = 512
    val_res_level: int = 4
    n_pseudo_pts: int = 2048
    # finetune-only
    num_views: int = 3


@dataclass
class TrainConfig:
    lr_feat: float = 1e-3
    lr_mlp: float = 5e-4
    # NeuS variance (inv_s) scalar LR = lr_mlp * this. 1.0 = reference
    # parity; >1 accelerates surface sharpening on short (chip-budget)
    # schedules — the held-out accuracy floor tracks ~1/inv_s (QUALITY.md)
    lr_variance_mult: float = 1.0
    # per-scale volume LRs for finetune mode (reference confs/gens_finetune.conf:22)
    lr_vol: Tuple[float, ...] = (1e-4, 1e-3, 1e-3, 1e-2, 1e-2)
    epochs: int = 50
    anneal_end: float = 2.0
    warmup: float = 1.0
    alpha: float = 0.02
    save_freq: float = 1.0
    log_freq: float = 0.2
    val_freq: float = 2.0
    seed: int = 0
    loss: LossConfig = field(default_factory=LossConfig)


@dataclass
class ParallelConfig:
    # named mesh axes sizes; 1 = disabled.
    data: int = 1
    view: int = 1


@dataclass
class Config:
    base_exp_dir: str = "./exp"
    mode: str = "train"  # train | val | finetune
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    train_dataset: DatasetConfig = field(default_factory=DatasetConfig)
    val_dataset: DatasetConfig = field(
        default_factory=lambda: DatasetConfig(split="test", num_src_view=2, ref_view=(23,))
    )
    finetune_dataset: DatasetConfig = field(
        default_factory=lambda: DatasetConfig(
            split=None, scene=("scan24",), ref_view=(23,), num_views=3,
            img_hw=(1152, 1600), factor=1.1
        )
    )
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    mesh_resolution: int = 512
    clean_mesh: bool = False
    # XLA compilation cache of the JAX package; accepted, unused here
    compilation_cache_dir: str = "auto"


# ---------------------------------------------------------------------------
# dict <-> dataclass plumbing


def _from_dict(cls, data: Any):
    if data is None:
        return None
    if dataclasses.is_dataclass(cls):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in data.items():
            if key not in fields:
                raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
            f = fields[key]
            ftype = f.type if not isinstance(f.type, str) else None
            default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default  # type: ignore[misc]
            if dataclasses.is_dataclass(default):
                kwargs[key] = _from_dict(type(default), value)
            elif isinstance(default, tuple) and isinstance(value, (list, tuple)):
                kwargs[key] = tuple(value)
            else:
                kwargs[key] = value
        return cls(**kwargs)
    return data


def config_from_dict(data: dict) -> Config:
    return _from_dict(Config, data)


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def load_config(path: Optional[str] = None, overrides: Sequence[str] = ()) -> Config:
    """Load a config from a JSON/YAML file plus dotted-path overrides.

    Overrides look like ``train.epochs=10`` or ``model.render.n_samples=32``;
    values are parsed as JSON when possible, else kept as strings.
    """
    data: dict = {}
    if path is not None:
        with open(path) as f:
            text = f.read()
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            import yaml

            data = yaml.safe_load(text)
    cfg = config_from_dict(data)
    for ov in overrides:
        key, _, raw = ov.partition("=")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = cfg
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = getattr(node, p)
        cur = getattr(node, parts[-1])
        if isinstance(cur, tuple) and isinstance(value, list):
            value = tuple(value)
        setattr(node, parts[-1], value)
    return cfg
