"""The least time of one per-scene finetune step, counted as ``flops.py``
counts a training step's: the render forward and backward at the peaks of
the precisions they run in, with no scene build (the volumes are trained
leaves and the features frozen), and the bytes of the finetune's Adam."""

from __future__ import annotations

from typing import Dict

from harness.flops import (HBM_BYTES_PER_S, PEAK, _precision, blending_ops,
                           sdf_mlp_ops)

# Adam on a float32 element: read the parameter, its gradient and both
# moments, write the parameter and both moments
ADAM_BYTES = 7 * 4


def finetune_step_min_seconds(model: Dict, n_views: int, n_rays: int,
                              n_sparse: int, n_pseudo: int) -> float:
    """The render's part of ``flops.train_step_min_seconds``: the
    sampler's SDF forwards, the twelve forwards' worth of the SDF at the
    render's samples, the sparse and pseudo points' SDF forward and
    backward, the surface normal's forward and point gradient, the
    blending forward and backward at every sample and source view."""
    r = model["render"]
    S = r["n_samples"] + r["n_importance"]
    per_step = r["n_importance"] // r["up_sample_steps"]
    sampler_pts = r["n_samples"] + per_step * (r["up_sample_steps"] - 1)
    sdf = sdf_mlp_ops(model["sdf_network"])
    sdf_ops = sdf * (n_rays * sampler_pts + 12 * n_rays * S
                     + 3 * (n_sparse + n_pseudo) + 2 * n_rays)
    blend_ops = 3 * blending_ops(model["color_network"]) * n_rays * S \
        * (n_views - 1)
    sdf_peak = PEAK[_precision(model["sdf_network"]["mlp_dtype"])]
    blend_peak = PEAK[_precision(model["color_network"]["mlp_dtype"])]
    return sdf_ops / sdf_peak + blend_ops / blend_peak


def adam_min_seconds(elements: float) -> float:
    """Adam over ``elements`` float32 elements at the card's memory
    bandwidth."""
    return ADAM_BYTES * elements / HBM_BYTES_PER_S
