"""The plain reference of GenS: the generalizable scene build (FPN feature
net, cross-view mean/variance aggregation, 3D U-Net), the SDF network, the
IBRNet blending, the NeuS hierarchical sampler and render core with the
training outputs, the losses, and Adam under the warmup-cosine schedule.

Plain PyTorch in float32. It imports nothing of the measured program and
runs no hand-written kernel; see README.md for what it was copied from and
where it departs. The caller sets TF32 off (``precision(...)``).

``Precision`` says how the places that a configuration states in bfloat16
are computed: ``lo=None`` in float32 (the reference), ``lo="fp8"`` rounded
to fp8's 3 mantissa bits (the control), ``lo="bf16"`` to bfloat16's 7 (a
witness of what the configuration's own precision does), with float32
matrix products in TF32 under ``tf32=True``. Where the program casts, the gradient is rounded
too; where it rounds a copy and keeps a float32 gradient (the colour maps,
the aggregation's table), the gradient passes unchanged.

Modules hold parameters only; their values come from the caller
(``load_state_dict``), by the same names as the measured program's state
dict.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

SDF_SENTINEL = 100.0


# -- precision -----------------------------------------------------------


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` rounded to ``bits`` explicit mantissa bits, exponent kept."""
    m, e = torch.frexp(x)
    scale = float(2 ** (bits + 1))
    return torch.ldexp(torch.round(m * scale) / scale, e)


class Precision:
    """Where the configuration says bfloat16 (``bf16`` names those places
    from the model config), ``lo`` rounds: identity for ``lo=None``."""

    def __init__(self, model_cfg: Dict, lo: Optional[str] = None,
                 tf32: bool = False):
        if lo not in (None, "fp8", "bf16"):
            raise ValueError(f"unknown lower precision {lo!r}")
        self.lo_kind = lo
        self.bits = {"fp8": 3, "bf16": 7}.get(lo)
        self.tf32 = tf32
        v, r = model_cfg["volume"], model_cfg["reg_network"]
        s, c = model_cfg["sdf_network"], model_cfg["color_network"]
        bf = "bfloat16"
        self.bf16 = {
            "agg_table": v["packed_bilerp"] in ("table_bf16", "pallas"),
            "raw_volume": v["dtype"] == bf,
            "reg": r["dtype"] == bf,
            "sdf_volume": s["volume_dtype"] == bf,
            "sdf_mlp": s["mlp_dtype"] == bf,
            "color_maps": bool(c["packed_bilerp"]) and c["packed_dtype"] == bf,
            "color_mlp": c["mlp_dtype"] == bf,
        }

    def lo(self, where: str, x: torch.Tensor) -> torch.Tensor:
        if self.lo_kind is None or not self.bf16[where]:
            return x
        if where in FORWARD_ONLY:
            r = round_mantissa(x.detach().float(), self.bits).to(x.dtype)
            return x + (r - x).detach()
        return _RoundBoth.apply(x, self.bits)


# places where the program rounds the value and passes the gradient on in
# float32; elsewhere its casts round the gradient too
FORWARD_ONLY = ("agg_table", "color_maps")


class _RoundBoth(torch.autograd.Function):
    """The narrower mantissa for the value and for the gradient, as a cast
    to a narrower type does to both."""

    @staticmethod
    def forward(ctx, x, bits):
        ctx.bits = bits
        return round_mantissa(x, bits)

    @staticmethod
    def backward(ctx, g):
        return _RoundBoth.apply(g, ctx.bits), None


@contextlib.contextmanager
def precision(prec: Precision):
    """TF32 on for float32 products under ``prec.tf32``, off otherwise."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = prec.tf32
    torch.backends.cudnn.allow_tf32 = prec.tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# -- interpolation -------------------------------------------------------


def _unnormalize(coord, size):
    return (coord + 1.0) * 0.5 * (size - 1)


def bilerp(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """image (H, W, C) at pixel xy (N, 2); zero outside; (N, C)."""
    H, W, C = image.shape
    x, y = xy[..., 0], xy[..., 1]
    x0f, y0f = torch.floor(x.detach()), torch.floor(y.detach())
    x0, y0 = x0f.long(), y0f.long()
    wx1, wy1 = x - x0f, y - y0f
    flat = image.reshape(H * W, C)
    out = None
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ix, iy = x0 + dx, y0 + dy
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        vals = flat.index_select(0, idx.reshape(-1)).reshape(idx.shape + (C,))
        wx = wx1 if dx else 1.0 - wx1
        wy = wy1 if dy else 1.0 - wy1
        term = vals * ((wx * wy) * valid.to(wx.dtype))[..., None]
        out = term if out is None else out + term
    return out


def trilerp(volume: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """volume (X, Y, Z, C) over [-1, 1]³ (align corners) at pts (N, 3)."""
    X, Y, Z, C = volume.shape
    x = _unnormalize(pts[..., 0], X)
    y = _unnormalize(pts[..., 1], Y)
    z = _unnormalize(pts[..., 2], Z)
    x0f, y0f, z0f = (torch.floor(x.detach()), torch.floor(y.detach()),
                     torch.floor(z.detach()))
    x0, y0, z0 = x0f.long(), y0f.long(), z0f.long()
    wx1, wy1, wz1 = x - x0f, y - y0f, z - z0f
    flat = volume.reshape(X * Y * Z, C)
    out = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix, iy, iz = x0 + dx, y0 + dy, z0 + dz
                valid = ((ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y)
                         & (iz >= 0) & (iz < Z))
                idx = ((ix.clamp(0, X - 1) * Y + iy.clamp(0, Y - 1)) * Z
                       + iz.clamp(0, Z - 1))
                w = ((wx1 if dx else 1.0 - wx1) * (wy1 if dy else 1.0 - wy1)
                     * (wz1 if dz else 1.0 - wz1)) * valid.to(wx1.dtype)
                term = flat[idx] * w[..., None]
                out = term if out is None else out + term
    return out


def lookup_mask(mask_any: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Nearest lookup (half to even) of the finest mask; (N,) 0/1."""
    X, Y, Z = mask_any.shape
    ix = torch.round(_unnormalize(pts[..., 0], X)).long()
    iy = torch.round(_unnormalize(pts[..., 1], Y)).long()
    iz = torch.round(_unnormalize(pts[..., 2], Z)).long()
    valid = (ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
    idx = ((ix.clamp(0, X - 1) * Y + iy.clamp(0, Y - 1)) * Z
           + iz.clamp(0, Z - 1))
    vals = mask_any.reshape(-1)[idx] * valid.to(mask_any.dtype)
    return (vals > 0).float()


def combine_mask_cascade(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    fine = masks[0].float()
    X = fine.shape[0]
    for m in masks[1:]:
        f = X // m.shape[0]
        up = (m.float().repeat_interleave(f, 0).repeat_interleave(f, 1)
              .repeat_interleave(f, 2))
        fine = torch.maximum(fine, up)
    return fine


def safe_norm(x, dim=-1, keepdim=False, eps=1e-12):
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    if multires <= 0:
        return x
    outs = [x]
    for i in range(multires):
        outs += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(outs, dim=-1)


# -- cameras -------------------------------------------------------------


def apply_linear(pts, mat, offset=None):
    out = (pts[:, 0:1] * mat[:, 0] + pts[:, 1:2] * mat[:, 1]
           + pts[:, 2:3] * mat[:, 2])
    return out if offset is None else out + offset


def scale_intrinsics(intrs: torch.Tensor, i: int) -> torch.Tensor:
    out = intrs.clone()
    out[..., :2, :] = out[..., :2, :] * (0.5 ** i)
    return out


def voxel_grid(dim: int, device) -> torch.Tensor:
    r = torch.linspace(-1.0, 1.0, dim, device=device)
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def project_voxels(pts, intr, c2w, hw):
    """Voxel centres into one view: pixel xy and the in-image,
    in-front mask (normalized-coordinate test)."""
    H, W = hw
    with torch.no_grad():
        w2c = torch.linalg.inv(c2w)
        cam = apply_linear(pts, w2c[:3, :3], w2c[:3, 3])
        uvw = apply_linear(cam, intr)
        xy = uvw[:, :2] / (uvw[:, 2:] + 1e-8)
        nx = xy[:, 0] / ((W - 1) / 2.0) - 1.0
        ny = xy[:, 1] / ((H - 1) / 2.0) - 1.0
        return xy, (nx.abs() <= 1) & (ny.abs() <= 1) & (cam[:, 2] > 0)


def project_points(pts, intr, c2w, hw):
    h, w = hw
    w2c = torch.linalg.inv(c2w)
    cam = apply_linear(pts, w2c[:3, :3], w2c[:3, 3])
    uvw = apply_linear(cam, intr)
    z = uvw[..., 2:3]
    xy = uvw[..., :2] / torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8),
                                    z)
    mask = ((z[..., 0] > 0) & (xy[..., 0] >= 0) & (xy[..., 0] < w)
            & (xy[..., 1] >= 0) & (xy[..., 1] < h))
    return xy, mask


def compute_ray_diff(pts, ref_c2w, src_c2ws):
    to_ref = ref_c2w[:3, 3][None, :] - pts
    to_ref = to_ref / (safe_norm(to_ref, dim=-1, keepdim=True) + 1e-6)
    to_src = src_c2ws[:, None, :3, 3] - pts[None, :, :]
    to_src = to_src / (safe_norm(to_src, dim=-1, keepdim=True) + 1e-6)
    diff = to_ref[None] - to_src
    norm = safe_norm(diff, dim=-1, keepdim=True)
    dot = torch.sum(to_ref[None] * to_src, dim=-1, keepdim=True)
    direction = diff / torch.clamp(norm, min=1e-6)
    return torch.cat([direction, dot], dim=-1).permute(1, 0, 2)


def lookup_feature(pts, imgs, intrs, c2ws, features):
    src_intrs, src_c2ws = intrs[1:], c2ws[1:]
    ray_diff = compute_ray_diff(pts, c2ws[0], src_c2ws)
    warped, masks, rgb = [], [], []
    for i, feat in enumerate(features):
        hw = feat.shape[1], feat.shape[2]
        intrs_i = scale_intrinsics(src_intrs, i)
        vals_s, mask_s = [], []
        for s in range(src_c2ws.shape[0]):
            xy, mask = project_points(pts, intrs_i[s], src_c2ws[s], hw)
            vals_s.append(bilerp(feat[s + 1], xy))
            mask_s.append(mask)
            if i == 0:
                rgb.append(bilerp(imgs[s + 1], xy))
        warped.append(torch.stack(vals_s, dim=1))
        masks.append(torch.stack(mask_s, dim=1))
    rgb_feat = torch.cat([torch.stack(rgb, dim=1)] + warped, dim=-1)
    return rgb_feat, ray_diff, torch.stack(masks, dim=-1).all(dim=-1)


def _mm3(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def surface_patch_warp(pts, normals, images, intrs, c2ws, patch_size):
    """Plane-induced homography patches: ref (N, P², C), src (S, N, P², C)."""
    N, S = pts.shape[0], intrs.shape[0] - 1
    K_ref_inv = torch.linalg.inv(intrs[0])
    K_src = intrs[1:]
    R_ref, C_ref = c2ws[0, :3, :3], c2ws[0, :3, 3]
    R_src_w2c = c2ws[1:, :3, :3].transpose(1, 2)
    C_src = c2ws[1:, :3, 3]
    pts_ref = apply_linear(pts - C_ref, R_ref.t())
    proj = apply_linear(pts_ref, intrs[0])
    disp = torch.sum(normals * pts_ref, dim=-1)
    R_rel = _mm3(R_src_w2c, R_ref)
    t_rel = torch.sum(R_src_w2c * (C_ref[None] - C_src)[:, None, :], dim=-1)
    tnT = t_rel[None, :, :, None] * normals[:, None, None, :]
    M = R_rel[None] + tnT / (disp[:, None, None, None] + 1e-10)
    Hom = _mm3(_mm3(K_src[None], M), K_ref_inv)
    px = proj[:, 0] / (proj[:, 2] + 1e-8)
    py = proj[:, 1] / (proj[:, 2] + 1e-8)
    half = patch_size // 2
    offs = torch.arange(-half, half + 1, dtype=pts.dtype, device=pts.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    offsets = torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)
    pix = torch.stack([px, py], dim=-1)[:, None, :] + offsets[None]
    pix_h = torch.cat([pix, torch.ones_like(pix[..., :1])], dim=-1)
    warped = (Hom[:, :, None] * pix_h[:, None, :, None, :]).sum(dim=-1)
    grid = warped[..., :2] / (warped[..., 2:] + 1e-8)
    P2 = patch_size ** 2
    src = torch.stack([
        bilerp(images[s + 1], grid[:, s].reshape(-1, 2)).reshape(N, P2, -1)
        for s in range(S)])
    ref = bilerp(images[0], pix.detach().reshape(-1, 2)).reshape(N, P2, -1)
    return ref, src


# -- networks ------------------------------------------------------------


def same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def instance_norm(x):
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + 1e-5)


class SameConv2d(nn.Module):
    def __init__(self, c_in, c_out, stride=1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(c_out, c_in, 3, 3))

    def forward(self, x):
        ph = same_pad(x.shape[2], 3, self.stride)
        pw = same_pad(x.shape[3], 3, self.stride)
        return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), self.weight,
                        stride=self.stride)


class ConvBlock(nn.Module):
    def __init__(self, c_in, c_out, stride=1):
        super().__init__()
        self.conv = SameConv2d(c_in, c_out, stride)

    def forward(self, x):
        return F.relu(instance_norm(self.conv(x)))


class DeconvBlock(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_in, c_out, 3, 3))

    def forward(self, x):
        H, W = x.shape[2], x.shape[3]
        y = F.conv_transpose2d(x, self.weight, stride=2)[:, :, :2 * H, :2 * W]
        return F.relu(instance_norm(y))


class FeatureNetwork(nn.Module):
    """imgs (V, H, W, 3) -> maps (V, H_i, W_i, C_i), strides 1 … 16."""

    def __init__(self, cfg: Dict):
        super().__init__()
        d_enc, d_out = tuple(cfg["d_enc"]), tuple(cfg["d_out"])
        d_dec = (8,) + d_enc[:-1]
        enc, c = [], 3
        for ch in d_enc:
            enc += [ConvBlock(c, ch, 2), ConvBlock(ch, ch, 1)]
            c = ch
        self.enc = nn.ModuleList(enc)
        dec = []
        for i in range(len(d_enc) - 2, -1, -1):
            dec.append(DeconvBlock(c, d_dec[i + 1]))
            c = d_dec[i + 1]
        dec.append(DeconvBlock(c, d_dec[0]))
        self.dec = nn.ModuleList(dec)
        self.heads = nn.ModuleList(SameConv2d(d_dec[i], d_out[i])
                                   for i in range(len(d_out)))

    def forward(self, imgs):
        x = imgs.permute(0, 3, 1, 2)
        encs = []
        for j in range(0, len(self.enc), 2):
            x = self.enc[j + 1](self.enc[j](x))
            encs.append(x)
        d, decs = encs[-1], []
        for k, i in enumerate(range(len(encs) - 2, -1, -1)):
            d = self.dec[k](d) + encs[i]
            decs.append(d)
        decs.append(self.dec[-1](d))
        decs = decs[::-1]
        return [self.heads[i](decs[i]).permute(0, 2, 3, 1).contiguous()
                for i in range(len(self.heads))]


class Conv3dBlock(nn.Module):
    def __init__(self, c_in, c_out, stride=1, norm_relu=True):
        super().__init__()
        self.stride, self.norm_relu = stride, norm_relu
        self.weight = nn.Parameter(torch.empty(c_out, c_in, 3, 3, 3))
        self.bias = None if norm_relu else nn.Parameter(torch.empty(c_out))

    def forward(self, x, prec: Precision):
        _, X, Y, Z = x.shape
        if self.stride == 2:
            py, pz = same_pad(Y, 3, 2), same_pad(Z, 3, 2)
            pad = (pz[0], pz[1], py[0], py[1], 1, 1)
        else:
            pad = (1, 1, 1, 1, 1, 1)
        w = prec.lo("reg", self.weight)
        y = prec.lo("reg", F.conv3d(F.pad(x, pad)[None], w,
                                    stride=self.stride)[0])
        if not self.norm_relu:
            return prec.lo("reg", y + self.bias[:, None, None, None])
        mean = y.mean(dim=(1, 2, 3), keepdim=True)
        var = torch.clamp(y.square().mean(dim=(1, 2, 3), keepdim=True)
                          - mean.square(), min=0.0)
        return prec.lo("reg", F.relu((y - mean) * torch.rsqrt(var + 1e-5)))


class Upsample3dBlock(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.conv = Conv3dBlock(c_in, c_out)

    def forward(self, x, prec):
        x = (x.repeat_interleave(2, 1).repeat_interleave(2, 2)
             .repeat_interleave(2, 3))
        return self.conv(x, prec)


class RegNetwork(nn.Module):
    """The 3D U-Net over the raw cascade; one output head per scale."""

    def __init__(self, cfg: Dict):
        super().__init__()
        if cfg["use_global_attn"]:
            raise ValueError("the reference has no GlobalAttn")
        dv, d_base = list(cfg["d_volume"]), cfg["d_base"]
        n = len(cfg["d_out"])
        self.n = n
        blocks, c = [Conv3dBlock(dv[0], d_base)], d_base
        enc_ch = [c]
        for i in range(n):
            dim_m = d_base * 2 ** i
            blocks += [Conv3dBlock(c, dim_m, stride=2),
                       Conv3dBlock(dim_m, dim_m)]
            enc_ch.append(dim_m)
            c = dim_m + (dv[i + 1] if i < n - 1 else 0)
        ups, d_ch, dec_ch = [], enc_ch[-1], [None] * n
        for i in range(n - 1, -1, -1):
            out = d_base * 2 ** max(i - 1, 0)
            ups.append(Upsample3dBlock(d_ch, out))
            d_ch = dec_ch[i] = out
        for i in range(n):
            blocks.append(Conv3dBlock(dec_ch[i], cfg["d_out"][i],
                                      norm_relu=False))
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)

    def forward(self, volumes, prec: Precision):
        n = self.n
        vols = [prec.lo("reg", v.permute(3, 0, 1, 2)) for v in volumes]
        e = self.blocks[0](vols[0], prec)
        e_outs = [e]
        for i in range(n):
            e = self.blocks[2 + 2 * i](self.blocks[1 + 2 * i](e, prec), prec)
            e_outs.append(e)
            if i < n - 1:
                e = torch.cat([e, vols[i + 1]], dim=0)
        d_outs = [e_outs[-1]]
        for k, i in enumerate(range(n - 1, -1, -1)):
            d_outs.append(prec.lo("reg", self.ups[k](d_outs[-1], prec)
                                  + e_outs[i]))
        d_outs = d_outs[::-1]
        return [self.blocks[1 + 2 * n + i](d_outs[i], prec)
                .permute(1, 2, 3, 0).contiguous() for i in range(n)]


def softplus100(x):
    z = x * 100.0
    return (torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-z.abs()))) / 100.0


class WNLinear(nn.Module):
    def __init__(self, d_in, d_out):
        super().__init__()
        self.v = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.empty(d_out))
        self.g = nn.Parameter(torch.empty(d_out))

    def weight(self):
        return self.v * (self.g / (torch.linalg.norm(self.v, dim=0)
                                   + 1e-12))[None, :]


class SDFNetwork(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        if not cfg["weight_norm"]:
            raise ValueError("the reference has weight norm only")
        self.cfg = cfg
        d_in = cfg["d_in"] * (1 + 2 * cfg["multires"])
        d_feat = cfg["feat_channels"] * (1 + 2 * cfg["feat_multires"])
        dims = ([d_in] + [cfg["d_hidden"] + d_feat] * cfg["n_layers"]
                + [cfg["d_out"]])
        self.dims = dims
        self.n_lin = len(dims) - 1
        for l in range(self.n_lin):
            out = dims[l + 1]
            if l + 1 in cfg["skip_in"]:
                out -= dims[0]
            if l < len(dims) - 2:
                out -= d_feat
            self.add_module(f"lin{l}", WNLinear(dims[l], out))

    def encode(self, pts, volumes, prec: Precision):
        c = self.cfg
        vols = [prec.lo("sdf_volume", v) for v in volumes]
        feats = torch.cat([trilerp(v, pts) for v in vols], dim=-1)
        return (positional_encoding(pts * c["scale"], c["multires"]),
                positional_encoding(feats, c["feat_multires"]))

    def forward(self, pts, volumes, prec: Precision):
        """pts (N, 3) -> (N, d_out): [sdf, latent]."""
        c = self.cfg
        inputs, feats = self.encode(pts, volumes, prec)
        inputs, feats = prec.lo("sdf_mlp", inputs), prec.lo("sdf_mlp", feats)
        x, L = inputs, len(self.dims)
        for l in range(self.n_lin):
            lin = getattr(self, f"lin{l}")
            if l in c["skip_in"]:
                x = prec.lo("sdf_mlp", torch.cat([x, inputs], dim=-1)
                            / math.sqrt(2))
            if 0 < l < L - 1:
                x = torch.cat([x, feats], dim=-1)
            x = prec.lo("sdf_mlp", x @ prec.lo("sdf_mlp", lin.weight())
                        + prec.lo("sdf_mlp", lin.b))
            if l < L - 2:
                x = prec.lo("sdf_mlp", softplus100(x))
        return torch.cat([x[..., :1] / c["scale"], x[..., 1:]], dim=-1)

    def sdf(self, pts, volumes, prec):
        return self(pts, volumes, prec)[..., 0]


class MLP(nn.Module):
    def __init__(self, d_in, features, final_act="elu"):
        super().__init__()
        layers, c = [], d_in
        for f in features:
            layers.append(nn.Linear(c, f))
            c = f
        self.layers = nn.ModuleList(layers)
        self.final_act = final_act

    def forward(self, x, prec: Precision):
        for i, lin in enumerate(self.layers):
            x = prec.lo("color_mlp", F.linear(
                x, prec.lo("color_mlp", lin.weight),
                prec.lo("color_mlp", lin.bias)))
            if i < len(self.layers) - 1:
                x = F.elu(x)
        if self.final_act == "elu":
            x = F.elu(x)
        elif self.final_act == "sigmoid":
            x = torch.sigmoid(x)
        return prec.lo("color_mlp", x)


class BlendingNetwork(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        if cfg["head"] != "blending" or not cfg["anti_alias_pooling"]:
            raise ValueError("the reference has the IBRNet blending head "
                             "with anti-alias pooling only")
        F_ = cfg["d_feature"] + 3
        self.mlps = nn.ModuleList([
            MLP(4, (16, F_)), MLP(3 * F_, (64, 32)), MLP(32, (32, 33)),
            MLP(32, (32, 1), final_act="sigmoid"),
            MLP(32 + 1 + 4, (16, 8, 1), final_act="none")])
        self.s = nn.Parameter(torch.empty(()))

    def forward(self, rgb_feat, ray_diff, mask, prec: Precision):
        lo = prec.lo
        rgb_feat, ray_diff = lo("color_mlp", rgb_feat), lo("color_mlp",
                                                         ray_diff)
        mask = mask[..., None].to(rgb_feat.dtype)
        nv = rgb_feat.shape[1]
        direction_feat = self.mlps[0](ray_diff, prec)
        rgb_in = rgb_feat[..., :3]
        rgb_feat = lo("color_mlp", rgb_feat + direction_feat)
        exp_dot = torch.exp(self.s.abs() * (ray_diff[..., 3:4] - 1.0))
        weight = (exp_dot - torch.amin(exp_dot, dim=1, keepdim=True)) * mask
        weight = lo("color_mlp",
                    weight / (torch.sum(weight, dim=1, keepdim=True) + 1e-8))
        mean = torch.sum(rgb_feat * weight, dim=1, keepdim=True)
        var = torch.sum(weight * (rgb_feat - mean) ** 2, dim=1, keepdim=True)
        globalfeat = torch.cat([mean, var], dim=-1)
        x = torch.cat([globalfeat.expand(-1, nv, -1), rgb_feat], dim=-1)
        x = self.mlps[1](lo("color_mlp", x), prec)
        x_vis = self.mlps[2](x * weight, prec)
        x_res, vis = x_vis[..., :-1], x_vis[..., -1:]
        vis = torch.sigmoid(vis) * mask
        x = x + x_res
        vis = self.mlps[3](x * vis, prec) * mask
        x = self.mlps[4](torch.cat([x, vis, ray_diff], dim=-1), prec)
        x = torch.where(mask == 0, torch.full_like(x, -1e9), x)
        blend = torch.softmax(x, dim=1)
        return torch.sum(rgb_in * blend, dim=1)


class SingleVarianceNetwork(nn.Module):
    def __init__(self):
        super().__init__()
        self.variance = nn.Parameter(torch.empty(()))

    def forward(self):
        return torch.exp(self.variance * 10.0)


# -- the model -----------------------------------------------------------


class GenSPlain(nn.Module):
    """Top-level modules under the measured program's state-dict names:
    feature, match_feature (frozen), reg, sdf, blending, variance."""

    def __init__(self, model_cfg: Dict):
        super().__init__()
        fc = model_cfg["feature_network"]
        if fc["backbone"] != "fpn" or model_cfg["volume"]["agg"] != "mean_var":
            raise ValueError("the reference has the FPN backbone and the "
                             "mean/variance aggregation only")
        self.cfg = model_cfg
        self.feature = FeatureNetwork(fc)
        self.match_feature = FeatureNetwork(fc)
        self.match_feature.requires_grad_(False)
        self.reg = RegNetwork(model_cfg["reg_network"])
        self.sdf = SDFNetwork(model_cfg["sdf_network"])
        self.blending = BlendingNetwork(model_cfg["color_network"])
        self.variance = SingleVarianceNetwork()

    # scene build -----------------------------------------------------------

    def aggregate(self, features, intrs, c2ws, prec: Precision):
        v = self.cfg["volume"]
        volumes, masks = [], []
        for i, dim in enumerate(v["volume_dims"]):
            feat = features[i]
            V, H, W, C = feat.shape
            intrs_i = scale_intrinsics(intrs, i)
            pts = voxel_grid(dim, feat.device)
            s1 = torch.zeros((pts.shape[0], C), device=feat.device)
            s2 = torch.zeros_like(s1)
            sm = torch.zeros((pts.shape[0],), device=feat.device)
            for view in range(V):
                xy, mask = project_voxels(pts, intrs_i[view], c2ws[view],
                                          (H, W))
                mask = mask.float()
                vals = bilerp(prec.lo("agg_table", feat[view]), xy)
                vm = vals * mask[:, None]
                s1 = s1 + vm
                s2 = s2 + vm * vm
                sm = sm + mask
            denom = torch.where(sm <= 0, torch.full_like(sm, 1e-8), sm)[:, None]
            mean = s1 / denom
            var = s2 / denom - mean ** 2
            volumes.append(prec.lo("raw_volume", torch.cat(
                [mean, var], dim=-1)).reshape(dim, dim, dim, 2 * C))
            masks.append((sm > v["min_vis_view"]).float().reshape(dim, dim,
                                                                 dim))
        return volumes, masks

    def build_scene(self, imgs, intrs, c2ws, prec: Precision) -> Dict:
        features = self.feature(imgs)
        with torch.no_grad():
            match_features = self.match_feature(imgs)
        raw, masks = self.aggregate(features, intrs, c2ws, prec)
        return {"volumes": self.reg(raw, prec), "mask_volumes": masks,
                "features": features, "match_features": match_features,
                "imgs": imgs, "intrs": intrs, "c2ws": c2ws,
                "mask_any": combine_mask_cascade(masks)}

    # sampling --------------------------------------------------------------

    def hierarchical_sample(self, rays_o, rays_d, near, far, scene, prec,
                            perturb_noise=None):
        rc = self.cfg["render"]
        n_samples, n_imp, steps = (rc["n_samples"], rc["n_importance"],
                                   rc["up_sample_steps"])
        mask_any, vols = scene["mask_any"], scene["volumes"]
        with torch.no_grad():
            R = rays_o.shape[0]
            t = torch.linspace(0.0, 1.0, n_samples, device=rays_o.device)
            z_vals = (near + (far - near) * t[None, :]).expand(
                R, n_samples).contiguous()
            if perturb_noise is not None:
                z_vals = z_vals + perturb_noise * 2.0 / n_samples
            if n_imp <= 0:
                return z_vals

            def masked_sdf(p):
                m = lookup_mask(mask_any, p)
                s = self.sdf.sdf(p, vols, prec)
                return torch.where(m > 0, s, torch.full_like(s, SDF_SENTINEL)), m

            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
            sdf, vmask = masked_sdf(pts.reshape(-1, 3))
            sdf, vmask = sdf.reshape(R, n_samples), vmask.reshape(R, n_samples)
            n_per = n_imp // steps
            for i in range(steps):
                weights = up_sample_weights(pts, z_vals, sdf, vmask,
                                            64.0 * 2 ** i)
                new_z = sample_pdf(z_vals, weights, n_per)
                if i + 1 < steps:
                    new_pts = (rays_o[:, None, :]
                               + rays_d[:, None, :] * new_z[..., None])
                    new_sdf, new_mask = masked_sdf(new_pts.reshape(-1, 3))
                    new_sdf = new_sdf.reshape(R, n_per)
                    new_mask = new_mask.reshape(R, n_per)
                else:
                    new_sdf = torch.full((R, n_per), SDF_SENTINEL,
                                         device=z_vals.device)
                    new_mask = torch.zeros((R, n_per), device=z_vals.device)
                z = torch.cat([z_vals, new_z], dim=-1)
                z_vals, order = torch.sort(z, dim=-1, stable=True)
                sdf = torch.gather(torch.cat([sdf, new_sdf], -1), -1, order)
                vmask = torch.gather(torch.cat([vmask, new_mask], -1), -1,
                                     order)
                pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
            return z_vals

    # render ----------------------------------------------------------------

    def render_train(self, scene, inputs, cos_anneal_ratio: float,
                     use_match_features: bool, perturb_noise, sparse_pts,
                     prec: Precision) -> Dict:
        rc = self.cfg["render"]
        rays_o, rays_d = inputs["rays_o"], inputs["rays_d"]
        R = rays_o.shape[0]
        z_vals = self.hierarchical_sample(rays_o, rays_d, inputs["near"],
                                          inputs["far"], scene, prec,
                                          perturb_noise)
        S = z_vals.shape[1]
        sample_dist = 2.0 / rc["n_samples"]
        mask_any, vols = scene["mask_any"], scene["volumes"]
        dists = z_vals[:, 1:] - z_vals[:, :-1]
        dists = torch.cat([dists, torch.full_like(dists[:, :1], sample_dist)],
                          dim=-1)
        mid_z = z_vals + dists * 0.5
        pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]
        pts_flat = pts.reshape(-1, 3)
        dirs_flat = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)
        voxel_mask = lookup_mask(mask_any, pts_flat)

        p = pts_flat.detach().requires_grad_(True)
        sdf_out = self.sdf(p, vols, prec)
        (gradients,) = torch.autograd.grad(sdf_out[:, 0].sum(), p,
                                           create_graph=True)
        (smooth,) = torch.autograd.grad(gradients, p,
                                        torch.ones_like(gradients),
                                        create_graph=True)
        smooth = smooth * voxel_mask[:, None]
        sdf = torch.where(voxel_mask > 0, sdf_out[:, 0],
                          torch.full_like(sdf_out[:, 0], SDF_SENTINEL))
        gradients = gradients * voxel_mask[:, None]

        imgs, feats = scene["imgs"], scene["features"]
        imgs = prec.lo("color_maps", imgs)
        feats = [prec.lo("color_maps", f) for f in feats]
        rgb_feat, ray_diff, view_mask = lookup_feature(
            pts_flat, imgs, scene["intrs"], scene["c2ws"], feats)
        sampled = self.blending(rgb_feat, ray_diff, view_mask, prec)
        sampled = (sampled * voxel_mask[:, None]).reshape(R, S, 3)

        inv_s = torch.clamp(self.variance(), 1e-6, 1e6)
        true_cos = torch.sum(dirs_flat * gradients, dim=-1, keepdim=True)
        iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                     + torch.relu(-true_cos) * cos_anneal_ratio)
        iter_cos = iter_cos * voxel_mask[:, None]
        dists_flat = dists.reshape(-1, 1)
        ic = torch.clamp(iter_cos, -10.0, 10.0)
        prev_cdf = torch.sigmoid((sdf[:, None] - ic * dists_flat * 0.5) * inv_s)
        next_cdf = torch.sigmoid((sdf[:, None] + ic * dists_flat * 0.5) * inv_s)
        alpha = torch.clamp(((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5))
                            .reshape(R, S), 0.0, 1.0)
        vmask_rs = voxel_mask.reshape(R, S)
        alpha = alpha * vmask_rs
        pts_norm = torch.linalg.norm(pts_flat, dim=-1).reshape(R, S)
        inside_sphere = (pts_norm < 1.0).float() * vmask_rs
        trans = torch.cumprod(torch.cat(
            [torch.ones((R, 1), device=alpha.device), 1.0 - alpha + 1e-7],
            dim=-1), dim=-1)[:, :-1]
        weights = alpha * trans
        color = torch.sum(sampled * weights[..., None], dim=1)
        rot = torch.linalg.inv(scene["c2ws"][0, :3, :3])
        cam_rays_d = apply_linear(rays_d, rot)
        render_depth = torch.sum(mid_z * weights, dim=1) * cam_rays_d[:, 2]

        sdf_d = sdf.reshape(R, S)
        seg_valid = ((vmask_rs[:, :-1] * vmask_rs[:, 1:]) > 0).float()
        sign = (sdf_d[:, :-1] * sdf_d[:, 1:] <= 0).float()
        idx_w = torch.arange(S - 1, 0, -1, dtype=torch.float32,
                             device=z_vals.device)[None, :]
        tmp = sign * idx_w * seg_valid
        prev_idx = torch.argmax(tmp, dim=1, keepdim=True)
        next_idx = prev_idx + 1
        mid_inside = (0.5 * (torch.gather(inside_sphere, 1, prev_idx)
                             + torch.gather(inside_sphere, 1, next_idx))
                      > 0.5).float()
        mid_inside = mid_inside * (tmp.sum(dim=1, keepdim=True) > 0).float()
        grad_d = gradients.detach().reshape(R, S, 3)
        g1 = torch.gather(grad_d, 1, prev_idx[..., None].expand(R, 1, 3))[:, 0]
        g2 = torch.gather(grad_d, 1, next_idx[..., None].expand(R, 1, 3))[:, 0]
        cos_d = torch.sum(g1 * g2, dim=-1) / (
            torch.linalg.norm(g1, dim=-1) * torch.linalg.norm(g2, dim=-1)
            + 1e-8)
        mid_inside = mid_inside * (cos_d[:, None] > 0.5).float()
        sdf1, sdf2 = (torch.gather(sdf_d, 1, prev_idx),
                      torch.gather(sdf_d, 1, next_idx))
        z1, z2 = (torch.gather(mid_z, 1, prev_idx),
                  torch.gather(mid_z, 1, next_idx))
        z_sdf0 = (sdf1 * z2 - sdf2 * z1) / (sdf1 - sdf2 + 1e-10)

        vm = (view_mask & (voxel_mask[:, None] > 0)).float().reshape(R, S, -1)
        valid_mask = (vm.sum(dim=2) > 1).float().sum(dim=1, keepdim=True) > 8
        relax_inside = (pts_norm < 1.2).float() * vmask_rs
        grad_sq_err = (safe_norm(gradients.reshape(R, S, 3), dim=-1) - 1.0) ** 2
        smooth_sur = torch.sum(smooth.reshape(R, S, 3)
                               * weights.detach()[..., None]
                               * inside_sphere[..., None], dim=1)
        sdf_random = self.sdf.sdf(sparse_pts, vols, prec)
        sparse_sdf = torch.cat([sdf_random, sdf])

        z_sdf0 = torch.where(z_sdf0 < 0, torch.zeros_like(z_sdf0), z_sdf0)
        z_sdf0 = torch.where(z_sdf0 > z_vals.max(), torch.zeros_like(z_sdf0),
                             z_sdf0)
        pts_sdf0 = rays_o + rays_d * z_sdf0
        with torch.enable_grad():
            q = pts_sdf0.detach().requires_grad_(True)
            (grad_sdf0,) = torch.autograd.grad(
                self.sdf(q, vols, prec)[:, 0].sum(), q)
        normal_sdf0 = grad_sdf0 / safe_norm(grad_sdf0, dim=-1, keepdim=True,
                                            eps=1e-16)
        normal_sdf0 = apply_linear(normal_sdf0, rot).detach()
        src = scene["match_features"] if use_match_features \
            else scene["features"]
        hw = src[0].shape[1:3]
        stack = [src[0]]
        for f in src[1:rc["warp_scales"]]:
            stack.append(F.interpolate(f.permute(0, 3, 1, 2), size=tuple(hw),
                                       mode="bilinear", align_corners=False)
                         .permute(0, 2, 3, 1))
        warp = prec.lo("color_maps", torch.cat(stack, dim=-1).detach())
        ref_gray, sampled_gray = surface_patch_warp(
            pts_sdf0, normal_sdf0, warp, scene["intrs"], scene["c2ws"],
            rc["patch_size"])

        out = {
            "color_fine": color, "render_depth": render_depth,
            "valid_mask": valid_mask, "mid_inside_sphere": mid_inside,
            "grad_sq_err": grad_sq_err, "relax_inside_sphere": relax_inside,
            "smooth_sur": smooth_sur, "sparse_sdf": sparse_sdf,
            "tv_reg": tv_regularization(vols, scene["mask_volumes"]),
            "ref_gray_val": ref_gray, "sampled_gray_val": sampled_gray,
        }
        if "pseudo_pts" in inputs:
            pp = inputs["pseudo_pts"]
            m = lookup_mask(mask_any, pp)
            s = self.sdf.sdf(pp, vols, prec)
            out["pseudo_sdf"] = torch.where(m > 0, s, torch.zeros_like(s))[:, None]
        return out


def up_sample_weights(pts, z_vals, sdf, voxel_mask, inv_s):
    seg_mask = voxel_mask[:, :-1] * voxel_mask[:, 1:]
    radius = torch.linalg.norm(pts, dim=-1)
    inside = (((radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0))
              & (seg_mask > 0))
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = 0.5 * (prev_sdf + next_sdf)
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]],
                         dim=-1)
    cos_val = torch.clamp(torch.minimum(prev_cos, cos_val), -1e3, 0.0) \
        * inside.float()
    dist = next_z - prev_z
    prev_cdf = torch.sigmoid((mid_sdf - cos_val * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid_sdf + cos_val * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-7], dim=-1),
                          dim=-1)[:, :-1]
    return alpha * trans


def sample_pdf(bins, weights, n_samples):
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]),
                     torch.cumsum(pdf, dim=-1)], dim=-1)
    u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                       device=cdf.device)
    u = u.expand(cdf.shape[:-1] + (n_samples,)).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_lo, cdf_hi = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b_lo, b_hi = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b_lo + (u - cdf_lo) / denom * (b_hi - b_lo)


def tv_regularization(volumes, mask_volumes):
    total = 0.0
    for i, (vol, mask) in enumerate(zip(volumes, mask_volumes)):
        m = mask[..., None]
        terms = []
        for ax in range(3):
            n = vol.shape[ax]
            a, b = vol.narrow(ax, 1, n - 1), vol.narrow(ax, 0, n - 1)
            mm = (m.narrow(ax, 1, n - 1) * m.narrow(ax, 0, n - 1)) > 0
            terms.append(torch.sum((a - b) ** 2 * mm) / (mm.sum() + 1e-8))
        total = total + torch.sqrt(terms[0] + terms[1] + terms[2]
                                   + 1e-12) * 0.5 ** i
    return total


# -- losses --------------------------------------------------------------


def compute_lncc(ref_gray, src_grays):
    S, N, P2, C = src_grays.shape
    src = src_grays.permute(1, 0, 3, 2)
    ref = ref_gray.permute(0, 2, 1)[:, None]
    ref_sum, src_sum = ref.sum(-1), src.sum(-1)
    u_ref, u_src = ref_sum / P2, src_sum / P2
    cross = ((ref * src).sum(-1) - u_src * ref_sum - u_ref * src_sum
             + u_ref * u_src * P2)
    ref_var = (ref ** 2).sum(-1) - 2 * u_ref * ref_sum + u_ref * u_ref * P2
    src_var = (src ** 2).sum(-1) - 2 * u_src * src_sum + u_src * u_src * P2
    ncc = torch.clamp(1.0 - cross * cross / (ref_var * src_var + 1e-5),
                      0.0, 2.0).mean(dim=2)
    return torch.topk(ncc, min(2, S), dim=1, largest=False).values.mean(
        dim=1, keepdim=True)


def compute_losses(preds: Dict, targets: Dict, w: Dict) -> Dict:
    valid = preds["valid_mask"].float()
    color = torch.sum((preds["color_fine"] - targets["color"]).abs()
                      * valid) / (valid.sum() + 1e-5)
    relax = preds["relax_inside_sphere"]
    eikonal = torch.sum(relax * preds["grad_sq_err"]) / (relax.sum() + 1e-5)
    sparse = torch.exp(-preds["sparse_sdf"].abs()
                       * w["sparse_scale_factor"]).mean()
    smooth = safe_norm(preds["smooth_sur"], dim=-1).mean()
    tv = preds["tv_reg"]
    ncc_mask = valid * preds["mid_inside_sphere"]
    ncc = compute_lncc(preds["ref_gray_val"], preds["sampled_gray_val"])
    mfc = 0.5 * torch.sum(ncc * ncc_mask) / (ncc_mask.sum() + 1e-8)
    zero = torch.zeros((), device=color.device)
    pseudo_sdf = (preds["pseudo_sdf"].abs().mean() if "pseudo_sdf" in preds
                  else zero)
    pseudo_depth = zero
    if "pseudo_depth" in targets:
        pd = targets["pseudo_depth"]
        m = (pd > 0).float()
        pseudo_depth = (torch.sum((preds["render_depth"] - pd).abs() * m)
                        / (m.sum() + 1e-8))
    loss = (color * w["color_weight"] + eikonal * w["igr_weight"]
            + sparse * w["sparse_weight"] + mfc * w["mfc_weight"]
            + smooth * w["smooth_weight"] + tv * w["tv_weight"]
            + pseudo_sdf * w["pseudo_sdf_weight"]
            + pseudo_depth * w["pseudo_depth_weight"])
    return {"loss": loss, "color_loss": color, "eikonal_loss": eikonal,
            "sparse_loss": sparse, "mfc_loss": mfc, "smooth_loss": smooth,
            "tv_loss": tv, "pseudo_sdf_loss": pseudo_sdf,
            "pseudo_depth_loss": pseudo_depth}


# -- the optimizer -------------------------------------------------------

# top-level module -> learning-rate group
GROUPS = {"sdf": "mlp", "blending": "mlp", "variance": "variance",
          "feature": "feat", "reg": "feat"}


def warmup_cosine_factor(progress, total, warmup, alpha):
    if warmup > 0 and progress < warmup:
        return 0.1 + 0.9 * progress / max(warmup, 1e-8)
    if total <= warmup:
        return alpha
    return ((math.cos(math.pi * (progress - warmup) / (total - warmup)) + 1.0)
            * 0.5 * (1 - alpha) + alpha)


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root) with a
    learning rate per group under the warmup-cosine factor at
    ``(step + start_step) / steps_per_epoch`` epochs."""

    def __init__(self, model: GenSPlain, train_cfg: Dict,
                 steps_per_epoch: int, start_step: int):
        self.named = [(n, p) for n, p in model.named_parameters()
                      if n.split(".")[0] in GROUPS]
        self.lr = {"mlp": train_cfg["lr_mlp"],
                   "variance": train_cfg["lr_mlp"]
                   * train_cfg["lr_variance_mult"],
                   "feat": train_cfg["lr_feat"]}
        self.tc, self.spe, self.start = train_cfg, steps_per_epoch, start_step
        self.m = {n: torch.zeros_like(p) for n, p in self.named}
        self.v = {n: torch.zeros_like(p) for n, p in self.named}
        self.t = 0

    @torch.no_grad()
    def step(self):
        tc = self.tc
        factor = warmup_cosine_factor((self.t + self.start) / self.spe,
                                      tc["epochs"], tc["warmup"], tc["alpha"])
        self.t += 1
        b1, b2 = 0.9, 0.999
        for n, p in self.named:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            lr = self.lr[GROUPS[n.split(".")[0]]] * factor
            denom = (self.v[n].sqrt() / math.sqrt(1 - b2 ** self.t)).add_(1e-8)
            p.addcdiv_(self.m[n], denom, value=-lr / (1 - b1 ** self.t))
