"""Cascaded feature-volume construction by cross-view mean/variance
aggregation (counterpart of ``voxel_grid``, ``aggregate_scale`` and
``agg_mean_var`` in gens_tpu/models/volume.py).

For each cascade scale, voxel centres of a [-1, 1]^3 grid are projected
into every view with scale-adjusted intrinsics, the view features are
bilinearly sampled, and the per-voxel masked mean and variance across views
form the raw volume. A voxel is valid when seen by strictly more than
``min_vis_view`` views.

The JAX function walks the grid in x-slabs under a scan to fit a 16 GB
chip; the whole 256³ grid fits an 80 GB card, so there is no slab loop
here and no recomputation in the backward (the JAX remat policies). The
projection runs in true f32 (``apply_linear``), the in-image test in
normalized coordinates, and Σf·m, Σf²·m, Σm accumulate in f32.

Under ``packed_bilerp`` "table_bf16" and "pallas" the JAX forward reads a
bf16 copy of the feature map while its backward stays f32 (the mixed-table
tangents, the Pallas splat). Here :class:`~gens_torch.ops.splat.BilerpAggSplat`
does both: bilerp of the bf16-rounded map forward, K1 backward. Autograd of
a plain ``.to(bf16)`` round trip would round the cotangent to bf16. Under
"pallas", ``volume.splat_impl`` chooses the forward (K2 under "kernel2f")
and K1's rounding at the scales where the JAX kernels run (dim a multiple
of 16); the other scales take the "table_bf16" path, as in JAX.

Under the ``view`` axis a rank holds some of the views: ``view_valid``
zeroes the masks of the padded ones, and Σf·m, Σf²·m and Σm are summed
over the view group before the divide, which reproduces the one-device
mean and variance (a padded view's K1 launch still runs, on a zero
cotangent).

:class:`AdaptiveAgg` (``volume.agg: adaptive``) weights the views instead:
a score MLP per scale, a softmax over the views that see the voxel, C
channels out. Its backward is the autograd of the plain ``bilerp``, as in
JAX (no K1), and it has no view axis: the JAX function takes no
``axis_name``, so the port refuses it under ``parallel.view`` > 1.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from gens_torch.models.init import dense
from gens_torch.ops.interp import bilerp
from gens_torch.parallel.collectives import all_reduce_sum
from gens_torch.ops.projection import apply_linear, scale_intrinsics
from gens_torch.ops.splat import bilerp_agg_splat, resolve_splat_impl

# volume.packed_bilerp modes whose aggregation forward reads a bf16 copy of
# the feature map
BF16_FEATURE_MODES = ("table_bf16", "pallas")


def voxel_grid(dim: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """(dim³, 3) voxel-centre xyz of an align-corners grid over [-1, 1]³,
    x-major (meshgrid 'ij')."""
    r = torch.linspace(-1.0, 1.0, dim, device=device, dtype=dtype)
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def aggregate_scale(feat: torch.Tensor, intrs: torch.Tensor,
                    c2ws: torch.Tensor, dim: int, scale_idx: int,
                    min_vis_view: int = 1, out_dtype=None,
                    splat_mm_dtype: Optional[str] = None,
                    splat_impl: str = "kernel2",
                    view_valid: Optional[torch.Tensor] = None, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cascade scale. feat (V, H_i, W_i, C); intrs (V, 3, 3) at the
    finest scale; c2ws (V, 4, 4). ``splat_mm_dtype`` None samples with the
    plain ``bilerp`` (autograd gives the f32 adjoint); a dtype samples
    through :class:`BilerpAggSplat` under ``splat_impl``, whose backward is
    K1 with that operand dtype. ``view_valid`` (V,) multiplies each view's
    mask; with a ``group`` the three sums are summed over it. Returns
    ``volume (dim, dim, dim, 2C)`` (mean ‖ var) and ``mask (dim, dim, dim)``
    float."""
    V, H, W, C = feat.shape
    intrs_i = scale_intrinsics(intrs, scale_idx)
    out_dtype = out_dtype or feat.dtype
    pts = voxel_grid(dim, feat.device, feat.dtype)
    warp_sum = torch.zeros((pts.shape[0], C), dtype=torch.float32,
                           device=feat.device)
    warp_sq_sum = torch.zeros_like(warp_sum)
    mask_sum = torch.zeros((pts.shape[0],), dtype=torch.float32,
                           device=feat.device)
    for v in range(V):
        xy, mask = project_voxels(pts, intrs_i[v], c2ws[v], (H, W))
        mask = mask.to(feat.dtype)
        if view_valid is not None:
            mask = mask * view_valid[v]
        if splat_mm_dtype is None:
            vals = bilerp(feat[v], xy)
        else:
            # xy is the dim³ voxel grid: K1 walks it in bricks
            vals = bilerp_agg_splat(feat[v], xy, splat_mm_dtype, splat_impl,
                                    dim)
        vm = vals * mask[:, None]
        # in place: the sums' backward keeps nothing, so per view only xy,
        # the mask and vm (for vm²) stay alive for the backward
        warp_sum += vm.float()
        warp_sq_sum += (vm * vm).float()
        mask_sum += mask.float()
        del xy, vals, vm
    if group is not None:
        # one collective for the triplet
        sums = all_reduce_sum(torch.cat(
            [warp_sum, warp_sq_sum, mask_sum[:, None]], dim=1), group)
        warp_sum, warp_sq_sum, mask_sum = sums[:, :C], sums[:, C:2 * C], \
            sums[:, 2 * C]
    denom = torch.where(mask_sum <= 0, torch.full_like(mask_sum, 1e-8),
                        mask_sum)[:, None]
    mean = warp_sum / denom
    var = warp_sq_sum / denom - mean ** 2
    volume = torch.cat([mean, var], dim=-1).to(out_dtype).reshape(
        dim, dim, dim, 2 * C)
    mask_volume = (mask_sum > min_vis_view).float().reshape(dim, dim, dim)
    return volume, mask_volume


def project_voxels(pts: torch.Tensor, intr: torch.Tensor, c2w: torch.Tensor,
                   hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel centres (N, 3) into one view: pixel xy (N, 2) and the bool
    mask of the points in front of the camera whose normalized coordinates
    lie within [-1, 1]. True f32 (no graph)."""
    H, W = hw
    with torch.no_grad():
        w2c = torch.linalg.inv(c2w)
        cam = apply_linear(pts, w2c[:3, :3], w2c[:3, 3])
        uvw = apply_linear(cam, intr)
        xy = uvw[:, :2] / (uvw[:, 2:] + 1e-8)
        nx = xy[:, 0] / ((W - 1) / 2.0) - 1.0
        ny = xy[:, 1] / ((H - 1) / 2.0) - 1.0
        return xy, (nx.abs() <= 1) & (ny.abs() <= 1) & (cam[:, 2] > 0)


class AdaptiveAgg(nn.Module):
    """Learned softmax-weighted cross-view aggregation (the JAX
    ``AdaptiveAgg``). ``agg_mlp_{i}_hidden`` (C_i -> d_hidden, ReLU) and
    ``agg_mlp_{i}_out`` (d_hidden -> 1) score each view's sample at scale
    i; scores of views that miss the voxel are -1e9, so a voxel that no
    view sees averages the views' out-of-image samples uniformly. Returns
    (volumes (dim, dim, dim, C_i) f32, masks (dim, dim, dim)); a voxel is
    valid when strictly more than ``min_vis_view`` views see it."""

    def __init__(self, channels: Sequence[int], d_hidden: int = 16):
        super().__init__()
        for i, c in enumerate(channels):
            self.add_module(f"agg_mlp_{i}_hidden", dense(c, d_hidden))
            self.add_module(f"agg_mlp_{i}_out", dense(d_hidden, 1))

    def forward(self, features: Sequence[torch.Tensor], intrs: torch.Tensor,
                c2ws: torch.Tensor, volume_dims: Sequence[int],
                min_vis_view: int = 1
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        volumes, masks = [], []
        for i, dim in enumerate(volume_dims):
            feat = features[i]
            V, H, W, C = feat.shape
            intrs_i = scale_intrinsics(intrs, i)
            pts = voxel_grid(dim, feat.device, feat.dtype)
            vals, vmask = [], []
            for v in range(V):
                xy, m = project_voxels(pts, intrs_i[v], c2ws[v], (H, W))
                vals.append(bilerp(feat[v], xy))
                vmask.append(m)
                del xy
            feats = torch.stack(vals)  # (V, N, C)
            vmask = torch.stack(vmask)  # (V, N)
            del vals
            hidden = getattr(self, f"agg_mlp_{i}_hidden")
            out = getattr(self, f"agg_mlp_{i}_out")
            score = out(torch.relu(hidden(feats)))
            score = torch.where(vmask[..., None], score,
                                torch.full_like(score, -1e9))
            w = torch.softmax(score, dim=0)
            volumes.append(torch.sum(feats * w, dim=0).reshape(
                dim, dim, dim, C))
            masks.append((vmask.sum(dim=0) > min_vis_view).float().reshape(
                dim, dim, dim))
        return volumes, masks


def _pallas_scale(packed_bilerp, dim: int) -> bool:
    """Whether the JAX Pallas kernels run at a scale of this dim."""
    return packed_bilerp == "pallas" and dim % 16 == 0 and dim >= 16


def splat_dtype(packed_bilerp, dim: int, splat_mm_dtype: str
                ) -> Optional[str]:
    """K1's operand dtype at one cascade scale, or None for the plain
    ``bilerp``. "table_bf16" has the exact f32 adjoint; "pallas" takes
    ``splat_mm_dtype`` where the JAX kernel runs (dim a multiple of 16) and
    falls back to "table_bf16" elsewhere, as the JAX function does."""
    if packed_bilerp not in BF16_FEATURE_MODES:
        return None
    if _pallas_scale(packed_bilerp, dim):
        return "bfloat16" if splat_mm_dtype == "bfloat16" else "float32"
    return "float32"


def splat_impl_at(packed_bilerp, dim: int, splat_impl: str) -> str:
    """The resolved ``splat_impl`` at one cascade scale: the configured
    one where the JAX kernels run, "adjoint" (the "table_bf16" path)
    elsewhere."""
    impl = resolve_splat_impl(splat_impl)
    return impl if _pallas_scale(packed_bilerp, dim) else "adjoint"


def agg_mean_var(features: Sequence[torch.Tensor], intrs: torch.Tensor,
                 c2ws: torch.Tensor, volume_dims: Sequence[int],
                 min_vis_view: int = 1, out_dtype=None,
                 packed_bilerp=False, splat_mm_dtype: str = "bfloat16",
                 splat_impl: str = "auto",
                 view_valid: Optional[torch.Tensor] = None, group=None
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Build the full cascade from ``features[i]`` (V, H_i, W_i, C),
    fine-to-coarse. ``packed_bilerp`` in :data:`BF16_FEATURE_MODES` samples
    bf16-rounded feature maps, as the JAX forward reads a bf16 table there,
    and keeps the backward f32 through K1 (:func:`splat_dtype`); under
    "pallas", ``splat_impl`` chooses the forward and K1's rounding
    (:func:`splat_impl_at`). ``view_valid`` and ``group`` go to
    :func:`aggregate_scale`. Returns (volumes, mask_volumes)."""
    volumes, masks = [], []
    for i, dim in enumerate(volume_dims):
        vol, m = aggregate_scale(
            features[i], intrs, c2ws, dim, i, min_vis_view=min_vis_view,
            out_dtype=out_dtype,
            splat_mm_dtype=splat_dtype(packed_bilerp, dim, splat_mm_dtype),
            splat_impl=splat_impl_at(packed_bilerp, dim, splat_impl),
            view_valid=view_valid, group=group)
        volumes.append(vol)
        masks.append(m)
    return volumes, masks
