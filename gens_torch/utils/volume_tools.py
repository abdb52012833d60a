"""Host-side mask-volume utilities (counterpart of
gens_tpu/utils/volume_tools.py): keep the largest 26-connected component of
a mask volume, with scipy.ndimage, on the host at mesh-extraction time."""

from __future__ import annotations

import numpy as np


def clean_volume(mask_volume: np.ndarray) -> np.ndarray:
    """Largest 26-connected component of a (X, Y, Z) boolean or 0/1 mask
    volume, as float32 in {0, 1}; an empty mask is returned unchanged (as
    float32)."""
    from scipy import ndimage

    mask = np.asarray(mask_volume) > 0
    labels, num = ndimage.label(mask, structure=np.ones((3, 3, 3), bool))
    if num < 1:
        return np.asarray(mask_volume, np.float32)
    counts = np.bincount(labels.ravel())
    counts[0] = 0  # background
    return (labels == int(counts.argmax())).astype(np.float32)
