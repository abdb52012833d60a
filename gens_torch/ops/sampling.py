"""Ray sampling: stratified init, inverse-CDF importance sampling and the
NeuS hierarchical up-sampling loop (counterpart of gens_tpu/ops/sampling.py).

Out-of-volume points are evaluated densely and overwritten with the
sentinel ``SDF_SENTINEL``, as in the JAX package, so every round keeps
static shapes. While spans record, the counters ``sampler.sdf_points`` and
``sampler.sdf_live`` count the points the sampler evaluates and those of
them inside the voxel mask.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from gens_torch.ops.interp import lookup_mask
from gens_torch.utils import profiling

# out-of-volume SDF sentinel
SDF_SENTINEL = 100.0


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               n_samples: int) -> torch.Tensor:
    """NeRF inverse-CDF sampling at deterministic midpoints (the val path;
    the JAX function's random draws serve training). bins (R, B);
    weights (R, B-1). Returns (R, n_samples)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                       device=cdf.device, dtype=cdf.dtype)
    u = u.expand(cdf.shape[:-1] + (n_samples,)).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_lo = torch.gather(cdf, -1, below)
    cdf_hi = torch.gather(cdf, -1, above)
    bins_lo = torch.gather(bins, -1, below)
    bins_hi = torch.gather(bins, -1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    return bins_lo + t * (bins_hi - bins_lo)


def up_sample_weights(pts: torch.Tensor, z_vals: torch.Tensor,
                      sdf: torch.Tensor, mask_any: torch.Tensor, inv_s: float,
                      voxel_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Section weights (R, S-1) for one NeuS up-sampling round at fixed
    ``inv_s``. pts (R, S, 3); z_vals, sdf (R, S); ``voxel_mask`` (R, S)
    skips the mask lookup when the caller carries it."""
    R, S = z_vals.shape
    if voxel_mask is None:
        voxel_mask = lookup_mask(mask_any, pts.reshape(-1, 3)).reshape(R, S)
    seg_mask = voxel_mask[:, :-1] * voxel_mask[:, 1:]
    radius = torch.linalg.norm(pts, dim=-1)
    inside_sphere = (((radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0))
                     & (seg_mask > 0))

    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = 0.5 * (prev_sdf + next_sdf)
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]],
                         dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere.to(cos_val.dtype)

    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7],
                  dim=-1), dim=-1)[:, :-1]
    return alpha * trans


def merge_z_vals(z_vals: torch.Tensor, sdf: torch.Tensor,
                 new_z: torch.Tensor, new_sdf: torch.Tensor,
                 *extra_pairs) -> Tuple[torch.Tensor, ...]:
    """Stable sorted merge of existing and new samples by z, carrying the
    SDF values and any further (old, new) pairs through the same order."""
    assert len(extra_pairs) % 2 == 0
    z = torch.cat([z_vals, new_z], dim=-1)
    z_sorted, order = torch.sort(z, dim=-1, stable=True)
    cols = [torch.cat([sdf, new_sdf], dim=-1)]
    for old, new in zip(extra_pairs[::2], extra_pairs[1::2]):
        cols.append(torch.cat([old, new], dim=-1))
    return (z_sorted,) + tuple(torch.gather(c, -1, order) for c in cols)


def hierarchical_sample(rays_o: torch.Tensor, rays_d: torch.Tensor,
                        near: torch.Tensor, far: torch.Tensor,
                        sdf_fn: Callable[[torch.Tensor], torch.Tensor],
                        mask_any: torch.Tensor, n_samples: int,
                        n_importance: int, up_sample_steps: int,
                        perturb_noise: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """NeuS sampling: uniform init plus ``up_sample_steps`` rounds of
    importance sampling at inv_s = 64·2^i. ``perturb_noise`` (R, 1), drawn
    uniform in [-0.5, 0.5) by the caller (training), shifts each ray's
    uniform samples by noise·2/n_samples; None leaves them in place (the val
    path). ``sdf_fn`` maps (N, 3) points to (N,) SDF. Runs without
    autograd. Returns z_vals (R, n_samples + n_importance)."""
    with torch.no_grad():
        R = rays_o.shape[0]
        t = torch.linspace(0.0, 1.0, n_samples, device=rays_o.device,
                           dtype=rays_o.dtype)
        z_vals = (near + (far - near) * t[None, :]).expand(
            R, n_samples).contiguous()
        if perturb_noise is not None:
            z_vals = z_vals + perturb_noise * 2.0 / n_samples
        if n_importance <= 0:
            return z_vals

        def masked_sdf(p):
            m = lookup_mask(mask_any, p)
            if profiling.enabled():
                # the waste ratio: every point outside the mask is thrown away
                profiling.count("sampler.sdf_points", p.shape[0])
                profiling.count("sampler.sdf_live", (m > 0).sum())
            s = sdf_fn(p).float()
            return torch.where(m > 0, s, torch.full_like(s, SDF_SENTINEL)), m

        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        sdf, vmask = masked_sdf(pts.reshape(-1, 3))
        sdf = sdf.reshape(R, n_samples)
        vmask = vmask.reshape(R, n_samples)

        n_per_step = n_importance // up_sample_steps
        for i in range(up_sample_steps):
            weights = up_sample_weights(pts, z_vals, sdf, mask_any,
                                        64.0 * 2 ** i, voxel_mask=vmask)
            new_z = sample_pdf(z_vals, weights, n_per_step)
            if i + 1 < up_sample_steps:
                new_pts = (rays_o[:, None, :]
                           + rays_d[:, None, :] * new_z[..., None])
                new_sdf, new_mask = masked_sdf(new_pts.reshape(-1, 3))
                new_sdf = new_sdf.reshape(R, n_per_step)
                new_mask = new_mask.reshape(R, n_per_step)
            else:
                # last round: the SDF of the new samples is not needed
                new_sdf = torch.full((R, n_per_step), SDF_SENTINEL,
                                     dtype=z_vals.dtype, device=z_vals.device)
                new_mask = torch.zeros((R, n_per_step), dtype=vmask.dtype,
                                       device=vmask.device)
            z_vals, sdf, vmask = merge_z_vals(z_vals, sdf, new_z, new_sdf,
                                              vmask, new_mask)
            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        return z_vals
