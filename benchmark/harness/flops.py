"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates, 700 W)
and the operations of GenS's layers counted from their shapes: 2 per
multiply-add of a convolution or a dense layer; elementwise work, the
gathers and the optimizer are not counted. Backward passes count twice
their forward (the input's and the weight's gradient)."""

from __future__ import annotations

from typing import Dict, Sequence

PEAK = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def feature_net_ops(cfg: Dict, n_views: int, hw: Sequence[int]) -> float:
    """One forward of the FPN over ``n_views`` images of ``hw``."""
    d_enc = list(cfg["d_enc"])
    d_dec = [8] + d_enc[:-1]
    H, W = hw
    ops, c, h, w = 0.0, 3, H, W
    enc_hw = []
    for ch in d_enc:
        h, w = -(-h // 2), -(-w // 2)
        ops += 2 * 9 * h * w * ch * (c + ch)
        enc_hw.append((h, w))
        c = ch
    # decoder: transposed convolutions, each input pixel × 9 taps
    for i in range(len(d_enc) - 2, -1, -1):
        h, w = enc_hw[i + 1]
        ops += 2 * 9 * h * w * c * d_dec[i + 1]
        c = d_dec[i + 1]
    h, w = enc_hw[0]
    ops += 2 * 9 * h * w * c * d_dec[0]
    # heads at strides 1 … 16
    for i, co in enumerate(cfg["d_out"]):
        ops += 2 * 9 * (H >> i) * (W >> i) * d_dec[i] * co
    return float(ops * n_views)


def reg_net_ops(cfg: Dict, volume_dims: Sequence[int]) -> float:
    """One forward of the 3D U-Net over the cascade."""
    dv, b, n = list(cfg["d_volume"]), cfg["d_base"], len(cfg["d_out"])
    vox = [d ** 3 for d in volume_dims] + [max(volume_dims[-1] // 2, 1) ** 3]
    ops = 2 * 27 * vox[0] * dv[0] * b
    c = b
    for i in range(n):
        m = b * 2 ** i
        ops += 2 * 27 * vox[i + 1] * (c * m + m * m)
        c = m + (dv[i + 1] if i < n - 1 else 0)
    d_ch = b * 2 ** (n - 1)
    for i in range(n - 1, -1, -1):
        out = b * 2 ** max(i - 1, 0)
        ops += 2 * 27 * vox[i] * d_ch * out
        d_ch = out
    for i in range(n):
        ops += 2 * 27 * vox[i] * b * 2 ** max(i - 1, 0) * cfg["d_out"][i]
    return float(ops)


def sdf_widths(cfg: Dict):
    """(x_pe width, feature-PE width, [(in, out)] of each layer)."""
    d_in = cfg["d_in"] * (1 + 2 * cfg["multires"])
    d_feat = cfg["feat_channels"] * (1 + 2 * cfg["feat_multires"])
    dims = [d_in] + [cfg["d_hidden"] + d_feat] * cfg["n_layers"] \
        + [cfg["d_out"]]
    layers = []
    for l in range(len(dims) - 1):
        out = dims[l + 1]
        if l + 1 in cfg["skip_in"]:
            out -= dims[0]
        if l < len(dims) - 2:
            out -= d_feat
        layers.append((dims[l], out))
    return d_in, d_feat, layers


def sdf_mlp_ops(cfg: Dict) -> float:
    """One SDF MLP forward, per point."""
    return float(sum(2 * i * o for i, o in sdf_widths(cfg)[2]))


def blending_ops(cfg: Dict) -> float:
    """One blending forward, per sample and source view."""
    f = cfg["d_feature"] + 3
    mlps = [(4, (16, f)), (3 * f, (64, 32)), (32, (32, 33)), (32, (32, 1)),
            (37, (16, 8, 1))]
    ops = 0
    for d_in, feats in mlps:
        for o in feats:
            ops += 2 * d_in * o
            d_in = o
    return float(ops)


def _precision(dtype: str) -> str:
    return "bfloat16" if dtype == "bfloat16" else "float32"


def train_step_min_seconds(model: Dict, n_views: int, hw, n_rays: int,
                           n_sparse: int, n_pseudo: int) -> float:
    """The least time of one training step's operations at the peaks of
    the precisions they run in. Per part: the feature net forward (and
    the frozen copy's) and backward; the U-Net forward and backward; the
    sampler's SDF forwards (n_samples + n_importance · (steps - 1) / steps
    points a ray); at the render's samples the SDF forward, its point
    gradient (one forward's worth), Hessian·1 (two) and the parameter
    gradient of all three (twice their sum), 12 forwards in all; the
    sparse and pseudo points' SDF forward and backward; the surface
    normal's forward and point gradient; the blending forward and
    backward at every sample and source view."""
    r = model["render"]
    S = r["n_samples"] + r["n_importance"]
    per_step = r["n_importance"] // r["up_sample_steps"]
    sampler_pts = r["n_samples"] + per_step * (r["up_sample_steps"] - 1)
    sdf = sdf_mlp_ops(model["sdf_network"])
    sdf_ops = sdf * (n_rays * sampler_pts + 12 * n_rays * S
                     + 3 * (n_sparse + n_pseudo) + 2 * n_rays)
    blend_ops = 3 * blending_ops(model["color_network"]) * n_rays * S \
        * (n_views - 1)
    feat = feature_net_ops(model["feature_network"], n_views, hw)
    reg = reg_net_ops(model["reg_network"], model["volume"]["volume_dims"])
    return (4 * feat / PEAK["float32"]
            + 3 * reg / PEAK[_precision(model["reg_network"]["dtype"])]
            + sdf_ops / PEAK[_precision(model["sdf_network"]["mlp_dtype"])]
            + blend_ops / PEAK[_precision(model["color_network"]["mlp_dtype"])])


def mesh_scene_min_seconds(model: Dict, n_views: int, hw,
                           resolution: int) -> float:
    """The least time of one reconstruction's operations: the scene build
    (both feature nets' forwards, the U-Net forward) and the SDF MLP at
    every grid point in 3xTF32 (three TF32 products for each)."""
    feat = feature_net_ops(model["feature_network"], n_views, hw)
    reg = reg_net_ops(model["reg_network"], model["volume"]["volume_dims"])
    grid = sdf_mlp_ops(model["sdf_network"]) * resolution ** 3
    return (2 * feat / PEAK["float32"]
            + reg / PEAK[_precision(model["reg_network"]["dtype"])]
            + 3 * grid / PEAK["tf32"])
