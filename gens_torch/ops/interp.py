"""Interpolation primitives as explicit gather + lerp (counterpart of the
plain forms in gens_tpu/ops/interp.py).

Conventions, as in the JAX package:
  * images / feature maps ``(H, W, C)``;
  * volumes ``(X, Y, Z, C)`` spanning ``[-1, 1]^3`` on an align-corners grid
    (voxel ``i`` sits at ``-1 + 2 i / (N - 1)``), axis 0 is x;
  * sample points ``(N, 3)`` in normalized xyz;
  * out-of-range corners contribute zero ("zeros" padding).

The lerp weights are differentiable in the sample coordinates (the floor is
taken on a detached copy), so autograd gives point gradients of any order
through ``trilerp``: the val path needs the first (normals from ∇SDF), the
training loss the third (it differentiates the Hessian·1 term w.r.t. the
parameters and the volumes).
The supercell and packed tables of the JAX package are TPU gather layouts
and have no counterpart here.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Map [-1, 1] to continuous index space (align_corners=True)."""
    return (coord + 1.0) * 0.5 * (size - 1)


def bilerp(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``image (H, W, C)`` at ``xy (N, 2)``, (x, y) in
    pixel coordinates. Returns ``(N, C)``."""
    H, W, C = image.shape
    x, y = xy[..., 0], xy[..., 1]
    x0f = torch.floor(x.detach())
    y0f = torch.floor(y.detach())
    x0 = x0f.long()
    y0 = y0f.long()
    wx1 = x - x0f
    wy1 = y - y0f
    flat = image.reshape(H * W, C)

    out = None
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ix, iy = x0 + dx, y0 + dy
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        # index_select: its backward is index_add_ (atomics); advanced
        # indexing's sorts the indices and sums each run of equal ones in
        # one warp, and the clamped out-of-image samples make runs of
        # millions
        vals = flat.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (C,))
        wx = wx1 if dx else 1.0 - wx1
        wy = wy1 if dy else 1.0 - wy1
        w = (wx * wy) * valid.to(wx.dtype)
        term = vals * w[..., None]
        out = term if out is None else out + term
    return out


def trilerp(volume: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of ``volume (X, Y, Z, C)`` at normalized
    ``pts (N, 3)``. Returns ``(N, C)``, float32 when the volume is bf16
    (the weights are f32, as in the JAX function)."""
    X, Y, Z, C = volume.shape
    x = _unnormalize(pts[..., 0], X)
    y = _unnormalize(pts[..., 1], Y)
    z = _unnormalize(pts[..., 2], Z)
    x0f = torch.floor(x.detach())
    y0f = torch.floor(y.detach())
    z0f = torch.floor(z.detach())
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
                vals = flat[idx]
                wx = wx1 if dx else 1.0 - wx1
                wy = wy1 if dy else 1.0 - wy1
                wz = wz1 if dz else 1.0 - wz1
                w = (wx * wy * wz) * valid.to(wx.dtype)
                term = vals * w[..., None]
                out = term if out is None else out + term
    return out


def nearest3d(volume: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample of ``volume (X, Y, Z, C)`` at ``pts (N, 3)``;
    out-of-bounds points return zero. Rounds half to even, as jnp.round."""
    X, Y, Z, C = volume.shape
    ix = torch.round(_unnormalize(pts[..., 0], X)).long()
    iy = torch.round(_unnormalize(pts[..., 1], Y)).long()
    iz = torch.round(_unnormalize(pts[..., 2], Z)).long()
    valid = (ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
    idx = ((ix.clamp(0, X - 1) * Y + iy.clamp(0, Y - 1)) * Z
           + iz.clamp(0, Z - 1))
    vals = volume.reshape(X * Y * Z, C)[idx]
    return vals * valid.to(volume.dtype)[..., None]


def lookup_volume_cascade(volumes: Sequence[torch.Tensor],
                          pts: torch.Tensor) -> torch.Tensor:
    """Trilerp every scale of the cascade at ``pts`` and concatenate:
    ``(N, sum_i C_i)``."""
    return torch.cat([trilerp(v, pts) for v in volumes], dim=-1)


def combine_mask_cascade(mask_volumes: Sequence[torch.Tensor]) -> torch.Tensor:
    """OR the mask cascade into one finest-resolution float volume: each
    coarse mask is nearest-upsampled (repeated) to the finest grid."""
    fine = mask_volumes[0].float()
    X = fine.shape[0]
    for m in mask_volumes[1:]:
        f = X // m.shape[0]
        up = (m.float().repeat_interleave(f, 0).repeat_interleave(f, 1)
              .repeat_interleave(f, 2))
        fine = torch.maximum(fine, up)
    return fine


def lookup_mask(mask_any: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Single-volume mask lookup: (N,) float 0/1."""
    return (nearest3d(mask_any[..., None], pts)[..., 0] > 0).float()


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (held in f32), with the identity as gradient:
    the cotangent stays f32, where autograd of ``x.to(bf16).float()`` would
    round it to bf16. The value is exactly the rounded one (x + (r - x) = r,
    the difference being exact)."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def safe_norm(x: torch.Tensor, dim=-1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with a finite gradient at x == 0: sqrt(sum(x²) + eps)."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)
