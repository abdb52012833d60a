"""Training losses (counterpart of gens_tpu/losses.py).

Every reduction is a (numerator, denominator) pair divided once, as in the
JAX function. With a view ``group`` (the ray and point shards of one scene)
both are summed over it before the divide, so every rank's value is the
one-device loss; the numerator's gradient stays this rank's own share
(``share_sum``), and the shares' parameter gradients are summed after the
backward. TV, computed from the volumes every rank holds, counts once per
group: each rank carries 1/V of it.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from gens_torch.config import LossConfig
from gens_torch.ops.interp import safe_norm
from gens_torch.parallel.collectives import share_sum


def compute_lncc(ref_gray: torch.Tensor, src_grays: torch.Tensor
                 ) -> torch.Tensor:
    """Patchwise normalized cross-correlation, best two source views.

    ref_gray (N, P², C); src_grays (S, N, P², C). Returns ncc (N, 1) in
    [0, 2] (0 = perfect correlation)."""
    S, N, P2, C = src_grays.shape
    src = src_grays.permute(1, 0, 3, 2)               # (N, S, C, P²)
    ref = ref_gray.permute(0, 2, 1)[:, None]          # (N, 1, C, P²)

    ref_sum = ref.sum(-1)
    src_sum = src.sum(-1)
    ref_sq_sum = (ref ** 2).sum(-1)
    src_sq_sum = (src ** 2).sum(-1)
    ref_src_sum = (ref * src).sum(-1)

    n = P2
    u_ref = ref_sum / n
    u_src = src_sum / n
    cross = ref_src_sum - u_src * ref_sum - u_ref * src_sum + u_ref * u_src * n
    ref_var = ref_sq_sum - 2 * u_ref * ref_sum + u_ref * u_ref * n
    src_var = src_sq_sum - 2 * u_src * src_sum + u_src * u_src * n

    cc = cross * cross / (ref_var * src_var + 1e-5)   # (N, S, C)
    ncc = torch.clamp(1.0 - cc, 0.0, 2.0).mean(dim=2)  # (N, S)
    best = torch.topk(ncc, min(2, S), dim=1, largest=False).values
    return best.mean(dim=1, keepdim=True)


def _ratio(num: torch.Tensor, den, eps: float, group=None) -> torch.Tensor:
    if group is not None:
        num = share_sum(num, group)
        den = share_sum(torch.as_tensor(den, dtype=num.dtype,
                                        device=num.device), group)
    return num / (den + eps)


def compute_losses(preds: Dict, targets: Dict, cfg: LossConfig,
                   group=None) -> Dict:
    """Weighted loss aggregation. ``preds`` from the renderer, ``targets``
    the batch, both this rank's shard under a view ``group``. Returns every
    term and their weighted sum ``loss``."""
    valid_mask = preds["valid_mask"].float()  # (R, 1)

    # masked L1; the normalizer counts valid rays, the rgb channel sum stays
    # in the numerator
    color_err = (preds["color_fine"] - targets["color"]).abs()
    color_loss = _ratio(torch.sum(color_err * valid_mask), valid_mask.sum(),
                        1e-5, group)

    relax = preds["relax_inside_sphere"]
    eikonal_loss = _ratio(torch.sum(relax * preds["grad_sq_err"]),
                          relax.sum(), 1e-5, group)

    sp = torch.exp(-preds["sparse_sdf"].abs() * cfg.sparse_scale_factor)
    sparse_loss = _ratio(sp.sum(), sp.numel(), 0.0, group)

    sm = safe_norm(preds["smooth_sur"], dim=-1)
    smooth_loss = _ratio(sm.sum(), sm.numel(), 0.0, group)

    tv_loss = preds["tv_reg"]
    if group is not None:
        tv_loss = share_sum(tv_loss / dist.get_world_size(group), group)

    ncc = compute_lncc(preds["ref_gray_val"], preds["sampled_gray_val"])
    ncc_mask = valid_mask * preds["mid_inside_sphere"]
    mfc_loss = 0.5 * _ratio(torch.sum(ncc * ncc_mask), ncc_mask.sum(), 1e-8,
                            group)

    zero = torch.zeros((), dtype=color_loss.dtype, device=color_loss.device)
    pseudo_sdf_loss = pseudo_depth_loss = depth_loss = zero
    if "pseudo_sdf" in preds:
        ps = preds["pseudo_sdf"].abs()
        pseudo_sdf_loss = _ratio(ps.sum(), ps.numel(), 0.0, group)
    if "pseudo_depth" in targets:
        pd = targets["pseudo_depth"]
        pd_mask = (pd > 0).float()
        pseudo_depth_loss = _ratio(
            torch.sum((preds["render_depth"] - pd).abs() * pd_mask),
            pd_mask.sum(), 1e-8, group)
    if "depth" in targets:
        d = targets["depth"]
        d_mask = (d > 0).float()
        depth_loss = _ratio(
            torch.sum((preds["render_depth"] - d).abs() * d_mask),
            d_mask.sum(), 1e-8, group)

    loss = (color_loss * cfg.color_weight
            + eikonal_loss * cfg.igr_weight
            + sparse_loss * cfg.sparse_weight
            + mfc_loss * cfg.mfc_weight
            + smooth_loss * cfg.smooth_weight
            + tv_loss * cfg.tv_weight
            + pseudo_sdf_loss * cfg.pseudo_sdf_weight
            + pseudo_depth_loss * cfg.pseudo_depth_weight
            + depth_loss * cfg.depth_weight)
    return {
        "loss": loss,
        "color_loss": color_loss,
        "eikonal_loss": eikonal_loss,
        "sparse_loss": sparse_loss,
        "mfc_loss": mfc_loss,
        "smooth_loss": smooth_loss,
        "tv_loss": tv_loss,
        "depth_loss": depth_loss,
        "pseudo_sdf_loss": pseudo_sdf_loss,
        "pseudo_depth_loss": pseudo_depth_loss,
    }
