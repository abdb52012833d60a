"""The operations of the MnasNet-1.0 FPN feature net counted from its
shapes, as ``flops.py`` counts the FPN's: 2 per multiply-add of every
convolution (the depthwise ones too), a transposed convolution's input
pixels × 9 taps, backward twice the forward. ``train_step_min_seconds`` is
``flops.train_step_min_seconds`` with the FPN's feature ops replaced by
these."""

from __future__ import annotations

from typing import Dict, Sequence

from harness.flops import PEAK, feature_net_ops, train_step_min_seconds \
    as _fpn_step_min_seconds

STEM = ((32, 3, 2, 1), (32, 3, 1, 32), (16, 1, 1, 1))  # (out, k, s, groups)
# (out channels, kernel, stride, expansion, repeats) of stacks 1 … 6
STACKS = ((24, 3, 2, 3, 3), (40, 5, 2, 3, 3), (80, 5, 2, 6, 3),
          (96, 3, 1, 6, 2), (192, 5, 2, 6, 4), (320, 3, 1, 6, 1))
DECODER = ((320, 96), (96, 40), (40, 24), (24, 16), (16, 8))
HEAD_IN = (8, 16, 24, 40, 96)


def mnasnet_feature_macs(d_out: Sequence[int], hw) -> int:
    """Multiply-adds of one forward of one view of ``hw``."""
    h, w = hw
    c, macs = 3, 0

    def conv(c_in, c_out, k, s, groups):
        nonlocal h, w, macs
        h, w = -(-h // s), -(-w // s)   # padding k // 2, odd k
        macs += h * w * c_out * (c_in // groups) * k * k

    for c_out, k, s, g in STEM:
        conv(c, c_out, k, s, g)
        c = c_out
    sizes = []
    for c_out, k, s, e, n in STACKS:
        for b in range(n):
            mid = c * e
            conv(c, mid, 1, 1, 1)
            conv(mid, mid, k, s if b == 0 else 1, mid)
            conv(mid, c_out, 1, 1, 1)
            c = c_out
        sizes.append((h, w))
    # the decoder from stride 32 (stack 6's output) up
    h, w = sizes[-1]
    for c_in, c_out in DECODER:
        macs += h * w * 9 * c_in * c_out
        h, w = 2 * h, 2 * w
    H, W = hw
    for i, c_in in enumerate(HEAD_IN):
        macs += -(-H // 2 ** i) * -(-W // 2 ** i) * 9 * c_in * d_out[i]
    return macs


def mnasnet_feature_ops(d_out: Sequence[int], n_views: int, hw) -> float:
    """One forward of the feature net over ``n_views`` images of ``hw``."""
    return 2.0 * mnasnet_feature_macs(d_out, hw) * n_views


def train_step_min_seconds(model: Dict, n_views: int, hw, n_rays: int,
                           n_sparse: int, n_pseudo: int) -> float:
    """``flops.train_step_min_seconds`` with the feature nets' four
    forwards' worth (the trained copy's forward and backward, the frozen
    copy's forward) counted for MnasNet in place of the FPN, at the
    float32 peak."""
    fc = model["feature_network"]
    fpn = feature_net_ops(fc, n_views, hw)
    mnas = mnasnet_feature_ops(fc["d_out"], n_views, hw)
    return (_fpn_step_min_seconds(model, n_views, hw, n_rays, n_sparse,
                                  n_pseudo)
            + 4 * (mnas - fpn) / PEAK["float32"])
