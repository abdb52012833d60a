"""Warmup-cosine learning-rate factor and the NeuS cosine-anneal ratio
(counterpart of gens_tpu/train/schedule.py), in plain Python floats."""

from __future__ import annotations

import math


def warmup_cosine_factor(progress: float, total: float, warmup: float,
                         alpha: float) -> float:
    """``progress``, ``total`` and ``warmup`` in one unit (epochs or steps):
    linear warmup from 0.1 to 1, then a cosine decay to ``alpha``. When the
    warmup spans the whole run (``total <= warmup``), the factor after it is
    ``alpha`` (the JAX function divides by zero there; no update uses it)."""
    if warmup > 0 and progress < warmup:
        return 0.1 + 0.9 * progress / max(warmup, 1e-8)
    if total <= warmup:
        return alpha
    return ((math.cos(math.pi * (progress - warmup) / (total - warmup)) + 1.0)
            * 0.5 * (1 - alpha) + alpha)


def cos_anneal_ratio(progress: float, anneal_end: float) -> float:
    if anneal_end <= 0:
        return 1.0
    return min(1.0, float(progress) / anneal_end)
