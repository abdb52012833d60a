"""Camera projection and cross-view feature lookup (counterpart of the plain
branches of gens_tpu/ops/projection.py).

Conventions: intrinsics ``K (V, 3, 3)`` at the finest feature scale (scale
``i`` divides the first two rows by ``2**i``); ``c2w (V, 4, 4)``
camera-to-world; view 0 is the reference view, views 1..V-1 the sources;
feature maps ``(V, H_i, W_i, C)`` per scale, fine-to-coarse.

The camera-geometry products are written as broadcast multiply-adds
(:func:`apply_linear`), so they run in true float32 whatever the TF32
settings are: a TF32 pass shifts projected pixels visibly.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from gens_torch.ops.capture import inverse
from gens_torch.ops.interp import bilerp, safe_norm, trilerp


def apply_linear(pts: torch.Tensor, mat: torch.Tensor,
                 offset: torch.Tensor = None) -> torch.Tensor:
    """``pts @ mat.T (+ offset)`` for (N, 3) points and a (3, 3) matrix,
    as three f32 multiply-adds per output (no matmul unit)."""
    out = (pts[:, 0:1] * mat[:, 0] + pts[:, 1:2] * mat[:, 1]
           + pts[:, 2:3] * mat[:, 2])
    return out if offset is None else out + offset


def scale_intrinsics(intrs: torch.Tensor, scale_idx: int) -> torch.Tensor:
    """Adjust intrinsics for feature scale ``i`` (rows 0-1 *= 0.5**i)."""
    out = intrs.clone()
    out[..., :2, :] = out[..., :2, :] * (0.5 ** scale_idx)
    return out


def project_points(pts: torch.Tensor, intr: torch.Tensor, c2w: torch.Tensor,
                   hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project world points (N, 3) into one camera. Returns pixel xy (N, 2)
    and the in-frustum mask (N,) (z > 0 and inside the image)."""
    h, w = hw
    w2c = inverse(c2w)
    cam = apply_linear(pts, w2c[:3, :3], w2c[:3, 3])
    uvw = apply_linear(cam, intr)
    z = uvw[..., 2:3]
    xy = uvw[..., :2] / torch.where(z.abs() < 1e-8,
                                    torch.full_like(z, 1e-8), z)
    mask = ((z[..., 0] > 0)
            & (xy[..., 0] >= 0) & (xy[..., 0] < w)
            & (xy[..., 1] >= 0) & (xy[..., 1] < h))
    return xy, mask


def compute_ray_diff(pts: torch.Tensor, ref_c2w: torch.Tensor,
                     src_c2ws: torch.Tensor) -> torch.Tensor:
    """IBRNet ray-difference embedding, ``(N, S, 4)``: unit direction
    difference (3) and dot product (1) of the ref-camera->point and
    src-camera->point unit rays."""
    to_ref = ref_c2w[:3, 3][None, :] - pts
    to_ref = to_ref / (safe_norm(to_ref, dim=-1, keepdim=True) + 1e-6)
    to_src = src_c2ws[:, None, :3, 3] - pts[None, :, :]  # (S, N, 3)
    to_src = to_src / (safe_norm(to_src, dim=-1, keepdim=True) + 1e-6)
    diff = to_ref[None] - to_src
    norm = safe_norm(diff, dim=-1, keepdim=True)
    dot = torch.sum(to_ref[None] * to_src, dim=-1, keepdim=True)
    direction = diff / torch.clamp(norm, min=1e-6)
    return torch.cat([direction, dot], dim=-1).permute(1, 0, 2)


def lookup_feature(pts: torch.Tensor, imgs: torch.Tensor, intrs: torch.Tensor,
                   c2ws: torch.Tensor, features: Sequence[torch.Tensor]):
    """Warp source-view multi-scale features and RGB onto sample points.

    pts (N, 3); imgs (V, H, W, 3); intrs (V, 3, 3); c2ws (V, 4, 4);
    features: list of (V, H_i, W_i, C_i). Returns ``rgb_feat (N, S, 3 +
    sum C_i)``, ``ray_diff (N, S, 4)``, ``mask (N, S)`` with S = V - 1:
    the mask ANDs the per-scale in-image tests.
    """
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
        warped.append(torch.stack(vals_s, dim=1))  # (N, S, C)
        masks.append(torch.stack(mask_s, dim=1))   # (N, S)
    rgb_feat = torch.cat([torch.stack(rgb, dim=1)] + warped, dim=-1)
    mask = torch.stack(masks, dim=-1).all(dim=-1)
    return rgb_feat, ray_diff, mask


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3, 3) as broadcast multiply-sums, so it
    runs in true f32 whatever the TF32 settings are."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def surface_patch_warp(pts: torch.Tensor, normals: torch.Tensor,
                       images: torch.Tensor, intrs: torch.Tensor,
                       c2ws: torch.Tensor, patch_size: int = 11):
    """Plane-induced homography patch warp for the MFC loss (counterpart of
    ``surface_patch_warp`` in gens_tpu/ops/projection.py).

    For each surface point with its normal in the REF CAMERA frame, the
    tangent plane induces H_s = K_s (R_rel + t nᵀ / d) K_ref⁻¹ from the ref
    view to source view s; a ``patch_size``² pixel patch around the point's
    ref projection is sampled in every source view through H_s and in the
    ref view itself (at detached pixel positions).

    pts, normals (N, 3); images (V, H, W, C); intrs (V, 3, 3); c2ws
    (V, 4, 4). Returns ``ref_patches (N, P², C)`` and ``src_patches
    (S, N, P², C)``. Every product runs in true f32.
    """
    N = pts.shape[0]
    S = intrs.shape[0] - 1
    K_ref = intrs[0]
    K_ref_inv = inverse(K_ref)
    K_src = intrs[1:]
    R_ref = c2ws[0, :3, :3]
    C_ref = c2ws[0, :3, 3]
    R_src_w2c = c2ws[1:, :3, :3].transpose(1, 2)
    C_src = c2ws[1:, :3, 3]

    pts_ref = apply_linear(pts - C_ref, R_ref.t())  # R_refᵀ (p - C_ref)
    proj = apply_linear(pts_ref, K_ref)
    disp = torch.sum(normals * pts_ref, dim=-1)
    R_rel = _mm3(R_src_w2c, R_ref)  # (S, 3, 3)
    t_rel = torch.sum(R_src_w2c * (C_ref[None] - C_src)[:, None, :], dim=-1)
    tnT = t_rel[None, :, :, None] * normals[:, None, None, :]  # (N, S, 3, 3)
    M = R_rel[None] + tnT / (disp[:, None, None, None] + 1e-10)
    Hom = _mm3(_mm3(K_src[None], M), K_ref_inv)  # (N, S, 3, 3)

    px = proj[:, 0] / (proj[:, 2] + 1e-8)
    py = proj[:, 1] / (proj[:, 2] + 1e-8)
    half = patch_size // 2
    offs = torch.arange(-half, half + 1, dtype=pts.dtype, device=pts.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    offsets = torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)
    pix = torch.stack([px, py], dim=-1)[:, None, :] + offsets[None]
    pix_h = torch.cat([pix, torch.ones_like(pix[..., :1])], dim=-1)
    warped = (Hom[:, :, None] * pix_h[:, None, :, None, :]).sum(dim=-1)
    grid = warped[..., :2] / (warped[..., 2:] + 1e-8)  # (N, S, P², 2)

    P2 = patch_size ** 2
    src_patches = torch.stack([
        bilerp(images[s + 1], grid[:, s].reshape(-1, 2)).reshape(N, P2, -1)
        for s in range(S)])
    ref_patches = bilerp(images[0], pix.detach().reshape(-1, 2)).reshape(
        N, P2, -1)
    return ref_patches, src_patches


# -- background-sphere (equirectangular) volume lookups -----------------------


def equirect2sphere(pts: torch.Tensor) -> torch.Tensor:
    """World points (N, 3) -> (theta, phi, 1/r) (N, 3): theta = asin(z/r)
    in [-pi/2, pi/2], phi = atan2(y, x) in [-pi, pi], the radius clipped to
    at least 1 (points inside the unit sphere map to 1/r = 1)."""
    # jnp.clip's maximum / minimum: at r == 1 the gradient splits in half
    n = safe_norm(pts, dim=1, keepdim=True)
    r = torch.minimum(torch.maximum(n, torch.ones_like(n)),
                      torch.full_like(n, 1e10))
    x, y, z = pts[:, :1] / r, pts[:, 1:2] / r, pts[:, 2:3] / r
    theta = torch.asin(torch.clamp(z, -1.0, 1.0))
    phi = torch.atan2(y, x)
    return torch.cat([theta, phi, 1.0 / r], dim=1)


def lookup_sphe_volume(sphe_pts: torch.Tensor, volume: torch.Tensor
                       ) -> torch.Tensor:
    """Trilinear lookup of an equirectangular background volume (D, H, W, C)
    at the spherical coordinates of :func:`equirect2sphere`, each mapped to
    [-1, 1]. Returns (N, C)."""
    theta, phi, inv_r = sphe_pts[:, :1], sphe_pts[:, 1:2], sphe_pts[:, 2:3]
    theta = theta / (math.pi / 2.0)
    phi = phi / math.pi
    inv_r = ((inv_r - 1e-10) / (1.0 - 1e-10) - 0.5) * 2.0
    return trilerp(volume, torch.cat([theta, phi, inv_r], dim=1))
