"""The plain reference of GenS as published: the MnasNet-1.0 FPN feature
net (torchvision's ``mnasnet1_0`` trunk cut into five stages, a
deconvolution decoder with additive skips, a 3x3 head a scale) in place
of the FPN; everything else is ``gens_plain``'s, unchanged.

Plain PyTorch in float32, as ``gens_plain``; see MNASNET.md for what it was
copied from and where it departs. The trunk as torchvision lays out
MnasNet-B1 at depth multiplier 1.0: a 3x3 stride-2 stem to 32 channels, a
depthwise 3x3 and a pointwise conv to 16, then the inverted-residual
stacks of ``STACKS``; every conv pads ``k // 2`` on both sides, strided
or not, and is followed by BatchNorm (eps 1e-5) on its running
statistics. The five stages end after the stem (stride 2, 16 channels),
stacks 1, 2, 4 and 6 (strides 4, 8, 16, 32; 24, 40, 96, 320 channels).

Modules hold parameters and buffers only; their values come from the
caller by the measured program's state-dict names.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .gens_plain import (Adam, BlendingNetwork, DeconvBlock,  # noqa: F401
                         GenSPlain as _GenSPlainFPN, Precision, RegNetwork,
                         SameConv2d, SDFNetwork, SingleVarianceNetwork,
                         compute_losses, precision)

BN_EPS = 1e-5
# (out channels, kernel, stride, expansion, repeats) of stacks 1 … 6
STACKS = ((24, 3, 2, 3, 3), (40, 5, 2, 3, 3), (80, 5, 2, 6, 3),
          (96, 3, 1, 6, 2), (192, 5, 2, 6, 4), (320, 3, 1, 6, 1))
# decoder (in, out) from stride 32 up, and the heads' input channels
DECODER = ((320, 96), (96, 40), (40, 24), (24, 16), (16, 8))
HEAD_IN = (8, 16, 24, 40, 96)


class BatchNorm(nn.Module):
    """BatchNorm2d on its running statistics."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))

    def forward(self, x):
        def per_channel(v):
            return v[:, None, None]

        return ((x - per_channel(self.running_mean))
                / per_channel(torch.sqrt(self.running_var + BN_EPS))
                * per_channel(self.weight) + per_channel(self.bias))


class Conv(nn.Module):
    """A bias-free conv's weight (O, I / groups, k, k)."""

    def __init__(self, c_in, c_out, kernel, groups):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in // groups,
                                               kernel, kernel))


class ConvBN(nn.Module):
    def __init__(self, c_in, c_out, kernel=1, stride=1, groups=1, relu=True):
        super().__init__()
        self.stride, self.groups, self.relu = stride, groups, relu
        self.conv = Conv(c_in, c_out, kernel, groups)
        self.bn = BatchNorm(c_out)

    def forward(self, x):
        k = self.conv.weight.shape[-1]
        x = self.bn(F.conv2d(x, self.conv.weight, stride=self.stride,
                             padding=k // 2, groups=self.groups))
        return F.relu(x) if self.relu else x


class InvertedResidual(nn.Module):
    """1x1 expansion, depthwise k x k (the stride), 1x1 projection without
    ReLU; the input added where the shape is kept."""

    def __init__(self, c_in, c_out, kernel, stride, expand):
        super().__init__()
        mid = c_in * expand
        self.residual = stride == 1 and c_in == c_out
        self.expand = ConvBN(c_in, mid)
        self.depthwise = ConvBN(mid, mid, kernel, stride, groups=mid)
        self.project = ConvBN(mid, c_out, relu=False)

    def forward(self, x):
        y = self.project(self.depthwise(self.expand(x)))
        return y + x if self.residual else y


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem_conv = ConvBN(3, 32, 3, 2)
        self.stem_dw = ConvBN(32, 32, 3, 1, groups=32)
        self.stem_pw = ConvBN(32, 16, relu=False)
        c = 16
        for s, (c_out, k, stride, expand, n) in enumerate(STACKS, 1):
            stack = nn.Module()
            for b in range(n):
                stack.add_module(f"block{b}", InvertedResidual(
                    c if b == 0 else c_out, c_out, k,
                    stride if b == 0 else 1, expand))
            self.add_module(f"stack{s}", stack)
            c = c_out

    def forward(self, x):
        x = self.stem_pw(self.stem_dw(self.stem_conv(x)))
        stages = [x]
        for s in range(1, len(STACKS) + 1):
            for block in getattr(self, f"stack{s}").children():
                x = block(x)
            if s in (1, 2, 4, 6):
                stages.append(x)
        return stages


class MnasNetFeatureNetwork(nn.Module):
    """imgs (V, H, W, 3) -> maps (V, H_i, W_i, d_out[i]), strides 1 … 16."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.encoder = Encoder()
        for i, (c_in, c_out) in enumerate(DECODER):
            self.add_module(f"decod_layer{5 - i}", DeconvBlock(c_in, c_out))
        for i, c in enumerate(HEAD_IN):
            self.add_module(f"out_layer{i + 1}",
                            SameConv2d(c, cfg["d_out"][i]))

    def forward(self, imgs):
        encs = self.encoder(imgs.permute(0, 3, 1, 2))
        d = encs[4]
        decs = []
        for i in range(4, 0, -1):
            d = getattr(self, f"decod_layer{i + 1}")(d) + encs[i - 1]
            decs.append(d)
        decs.append(self.decod_layer1(d))
        decs = decs[::-1]
        return [getattr(self, f"out_layer{i + 1}")(decs[i])
                .permute(0, 2, 3, 1).contiguous() for i in range(5)]


class GenSPlain(_GenSPlainFPN):
    """``gens_plain.GenSPlain`` with the MnasNet feature nets."""

    def __init__(self, model_cfg: Dict):
        nn.Module.__init__(self)
        fc = model_cfg["feature_network"]
        if fc["backbone"] != "mnasnet" \
                or model_cfg["volume"]["agg"] != "mean_var":
            raise ValueError("this reference has the MnasNet backbone and "
                             "the mean/variance aggregation only")
        self.cfg = model_cfg
        self.feature = MnasNetFeatureNetwork(fc)
        self.match_feature = MnasNetFeatureNetwork(fc)
        self.match_feature.requires_grad_(False)
        self.reg = RegNetwork(model_cfg["reg_network"])
        self.sdf = SDFNetwork(model_cfg["sdf_network"])
        self.blending = BlendingNetwork(model_cfg["color_network"])
        self.variance = SingleVarianceNetwork()
