"""Multi-scale FPN feature extractor (counterpart of
gens_tpu/models/feature_net.py).

The public call keeps the JAX layout, (V, H, W, 3) in and (V, H_i, W_i, C)
out; inside, the convolutions run NCHW. Two padding conventions of flax
need care:

* ``nn.Conv`` with 'SAME' padding at stride 2 pads (0, 1) on an even size
  (the extra row goes last), where torch's ``padding=1`` pads (1, 1):
  :func:`same_pad` computes flax's split and pads explicitly.
* ``nn.ConvTranspose`` 'SAME' at stride 2, kernel 3, is the input dilated
  by 2, padded (2, 1), and correlated with the UNflipped kernel. That is
  ``conv_transpose2d`` with the spatially flipped kernel, padding 0, and the
  last output row and column dropped (:class:`DeconvBlock`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gens_torch.config import FeatureNetConfig
from gens_torch.models.init import lecun_normal_
from gens_torch.utils.profiling import span


def same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/lax 'SAME' padding (lo, hi) of one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm without affine parameters over the spatial axes of an
    N, C, *spatial tensor: (x - mean) / sqrt(var + 1e-5), biased var."""
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + 1e-5)


class SameConv2d(nn.Conv2d):
    """3x3 bias-free conv with flax 'SAME' padding."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1):
        super().__init__(c_in, c_out, 3, stride=stride, padding=0, bias=False)
        lecun_normal_(self.weight, 9 * c_in)

    def forward(self, x):
        s = self.stride[0]
        ph = same_pad(x.shape[2], 3, s)
        pw = same_pad(x.shape[3], 3, s)
        return super().forward(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int = 1):
        super().__init__()
        self.conv = SameConv2d(c_in, c_out, stride)

    def forward(self, x):
        return F.relu(instance_norm(self.conv(x)))


class DeconvBlock(nn.Module):
    """flax ConvTranspose(3x3, stride 2, 'SAME') + InstanceNorm + ReLU.

    ``weight`` is stored as torch's (in, out, kh, kw), already flipped
    (``convert.py`` flips flax's HWIO kernel)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_in, c_out, 3, 3))
        lecun_normal_(self.weight, 9 * c_in)

    def forward(self, x):
        H, W = x.shape[2], x.shape[3]
        y = F.conv_transpose2d(x, self.weight, stride=2)[:, :, :2 * H, :2 * W]
        return F.relu(instance_norm(y))


class FeatureNetwork(nn.Module):
    """imgs (V, H, W, 3) -> 5 maps (V, H_i, W_i, d_out[i]) at strides
    1, 2, 4, 8, 16 (fine-to-coarse); H, W multiples of 32.

    Submodules in flax creation order: ``enc[2j]`` / ``enc[2j+1]`` are
    ConvBlock_{2j} (stride 2) / ConvBlock_{2j+1}; ``dec[k]`` is
    DeconvBlock_k; ``heads[i]`` is Conv_i."""

    def __init__(self, cfg: FeatureNetConfig):
        super().__init__()
        d_enc, d_out = tuple(cfg.d_enc), tuple(cfg.d_out)
        self.d_dec = (8,) + d_enc[:-1]  # decoder channels at strides 1..16
        enc, c = [], 3
        for ch in d_enc:
            enc += [ConvBlock(c, ch, 2), ConvBlock(ch, ch, 1)]
            c = ch
        self.enc = nn.ModuleList(enc)
        dec = []
        for i in range(len(d_enc) - 2, -1, -1):
            dec.append(DeconvBlock(c, self.d_dec[i + 1]))
            c = self.d_dec[i + 1]
        dec.append(DeconvBlock(c, self.d_dec[0]))
        self.dec = nn.ModuleList(dec)
        self.heads = nn.ModuleList(
            SameConv2d(self.d_dec[i], d_out[i]) for i in range(len(d_out)))

    @property
    def first_weight(self) -> torch.Tensor:
        return self.enc[0].conv.weight

    def forward(self, imgs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = imgs.permute(0, 3, 1, 2)
        encs = []
        with span("gens/features/encoder"):
            for j in range(0, len(self.enc), 2):
                x = self.enc[j + 1](self.enc[j](x))
                encs.append(x)
        decs = []
        d = encs[-1]
        n = len(encs)
        for k, i in enumerate(range(n - 2, -1, -1)):
            d = self.dec[k](d) + encs[i]
            decs.append(d)
        decs.append(self.dec[-1](d))
        decs = decs[::-1]
        return tuple(self.heads[i](decs[i]).permute(0, 2, 3, 1).contiguous()
                     for i in range(len(self.heads)))
