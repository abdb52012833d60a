"""MnasNet-1.0 FPN feature extractor (counterpart of
gens_tpu/models/mnasnet.py), the converter of torchvision's MnasNet state
dict and the loader of its ``pretrained_path`` pickle.

The encoder is torchvision's ``mnasnet1_0().layers`` cut into the five
stages the reference slices (strides 2, 4, 8, 16, 32; 16, 24, 40, 96 and
320 channels); the decoder is the port's ``DeconvBlock`` with additive
skips and a 3x3 ``out_layer{i}`` head per scale.

* Strided convs pad ``k // 2`` on both sides, as torch does (not flax
  'SAME').
* BatchNorm always normalizes with its running statistics, eps 1e-5, in
  ``train()`` mode too, as the JAX module's ``use_running_average=True``:
  the statistics are buffers, so no optimizer sees them, and they load
  from the ``batch_stats`` collection.

``scripts/convert_mnasnet_weights.py`` writes the pretrained pickle,
``{"params": ..., "batch_stats": ...}`` of the encoder in the flax layout
(``stem_conv/conv/kernel`` (kh, kw, in, out), depthwise (kh, kw, 1, C),
``.../bn/{scale,bias}`` and ``{mean,var}``); :func:`convert_torch_mnasnet`
is the port's own copy of the JAX converter that produces it, and
:func:`load_pretrained_encoder` reads it into an encoder.
"""

from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gens_torch.config import FeatureNetConfig
from gens_torch.models.feature_net import DeconvBlock, SameConv2d
from gens_torch.models.init import lecun_normal_
from gens_torch.utils.profiling import span

BN_EPS = 1e-5


class FrozenBatchNorm2d(nn.Module):
    """Inference-mode BatchNorm: affine ``weight`` / ``bias`` parameters
    (flax ``scale`` / ``bias``), running statistics as buffers."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)


class ConvBN(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride,
                              padding=kernel // 2, groups=groups, bias=False)
        lecun_normal_(self.conv.weight, kernel * kernel * c_in // groups)
        self.bn = FrozenBatchNorm2d(c_out)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class InvertedResidual(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 expand: int):
        super().__init__()
        mid = c_in * expand
        self.residual = stride == 1 and c_in == c_out
        self.expand = ConvBN(c_in, mid, kernel=1)
        self.depthwise = ConvBN(mid, mid, kernel=kernel, stride=stride,
                                groups=mid)
        self.project = ConvBN(mid, c_out, kernel=1, relu=False)

    def forward(self, x):
        y = self.project(self.depthwise(self.expand(x)))
        return y + x if self.residual else y


class Stack(nn.Module):
    """``block0`` … ``block{repeats-1}``; the first takes the stride."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 expand: int, repeats: int):
        super().__init__()
        self.n = repeats
        for i in range(repeats):
            self.add_module(f"block{i}", InvertedResidual(
                c_in if i == 0 else c_out, c_out, kernel,
                stride if i == 0 else 1, expand))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"block{i}")(x)
        return x


class MnasNetEncoder(nn.Module):
    """The MnasNet-B1 (depth multiplier 1.0) trunk: NCHW in, the five
    stages out."""

    def __init__(self):
        super().__init__()
        self.stem_conv = ConvBN(3, 32, kernel=3, stride=2)
        self.stem_dw = ConvBN(32, 32, kernel=3, groups=32)
        self.stem_pw = ConvBN(32, 16, kernel=1, relu=False)
        self.stack1 = Stack(16, 24, 3, 2, 3, 3)
        self.stack2 = Stack(24, 40, 5, 2, 3, 3)
        self.stack3 = Stack(40, 80, 5, 2, 6, 3)
        self.stack4 = Stack(80, 96, 3, 1, 6, 2)
        self.stack5 = Stack(96, 192, 5, 2, 6, 4)
        self.stack6 = Stack(192, 320, 3, 1, 6, 1)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        enc1 = self.stem_pw(self.stem_dw(self.stem_conv(x)))  # 1/2
        enc2 = self.stack1(enc1)                              # 1/4
        enc3 = self.stack2(enc2)                              # 1/8
        enc4 = self.stack4(self.stack3(enc3))                 # 1/16
        enc5 = self.stack6(self.stack5(enc4))                 # 1/32
        return enc1, enc2, enc3, enc4, enc5


class MnasNetFeatureNetwork(nn.Module):
    """imgs (V, H, W, 3) -> 5 maps (V, H_i, W_i, d_out[i]) at strides 1, 2,
    4, 8, 16; H, W multiples of 32."""

    def __init__(self, cfg: FeatureNetConfig):
        super().__init__()
        d_out = tuple(cfg.d_out)
        self.encoder = MnasNetEncoder()
        self.decod_layer5 = DeconvBlock(320, 96)
        self.decod_layer4 = DeconvBlock(96, 40)
        self.decod_layer3 = DeconvBlock(40, 24)
        self.decod_layer2 = DeconvBlock(24, 16)
        self.decod_layer1 = DeconvBlock(16, 8)
        for i, c in enumerate((8, 16, 24, 40, 96)):
            self.add_module(f"out_layer{i + 1}", SameConv2d(c, d_out[i]))

    @property
    def first_weight(self) -> torch.Tensor:
        return self.encoder.stem_conv.conv.weight

    def forward(self, imgs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        with span("gens/features/encoder"):
            enc1, enc2, enc3, enc4, enc5 = self.encoder(
                imgs.permute(0, 3, 1, 2))
        dec5 = self.decod_layer5(enc5) + enc4
        dec4 = self.decod_layer4(dec5) + enc3
        dec3 = self.decod_layer3(dec4) + enc2
        dec2 = self.decod_layer2(dec3) + enc1
        dec1 = self.decod_layer1(dec2)
        decs = (dec1, dec2, dec3, dec4, dec5)
        return tuple(getattr(self, f"out_layer{i + 1}")(decs[i])
                     .permute(0, 2, 3, 1).contiguous() for i in range(5))


# -- torchvision state dict -> the flax encoder tree -> the port --------------

# flax stack name -> torchvision ``layers`` index, and its block count
_STACKS = {"stack1": (8, 3), "stack2": (9, 3), "stack3": (10, 3),
           "stack4": (11, 2), "stack5": (12, 4), "stack6": (13, 1)}


def convert_torch_mnasnet(state_dict) -> Dict:
    """torchvision ``mnasnet1_0().state_dict()`` (numpy arrays or tensors)
    -> the encoder's ``{"params", "batch_stats"}`` tree in the flax layout:
    conv weights (O, I, kh, kw) become (kh, kw, I, O), depthwise (C, 1, kh,
    kw) become (kh, kw, 1, C)."""
    params: Dict = {}
    stats: Dict = {}

    def arr(name):
        return np.asarray(state_dict[name])

    def put(tree, path, leaf):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = leaf

    def convbn(path, conv, bn):
        put(params, path + ("conv", "kernel"),
            np.transpose(arr(conv), (2, 3, 1, 0)))
        put(params, path + ("bn",), {"scale": arr(bn + ".weight"),
                                     "bias": arr(bn + ".bias")})
        put(stats, path + ("bn",), {"mean": arr(bn + ".running_mean"),
                                    "var": arr(bn + ".running_var")})

    convbn(("stem_conv",), "layers.0.weight", "layers.1")
    convbn(("stem_dw",), "layers.3.weight", "layers.4")
    convbn(("stem_pw",), "layers.6.weight", "layers.7")
    for stack, (t, n_blocks) in _STACKS.items():
        for b in range(n_blocks):
            base = f"layers.{t}.{b}.layers"
            path = (stack, f"block{b}")
            convbn(path + ("expand",), f"{base}.0.weight", f"{base}.1")
            convbn(path + ("depthwise",), f"{base}.3.weight", f"{base}.4")
            convbn(path + ("project",), f"{base}.6.weight", f"{base}.7")
    return {"params": params, "batch_stats": stats}


def load_pretrained_encoder(encoder: MnasNetEncoder, path: str) -> None:
    """Load the ``pretrained_path`` pickle (the flax encoder tree that
    ``scripts/convert_mnasnet_weights.py`` writes) into ``encoder``; every
    parameter and buffer must be matched. Only load files this project
    wrote: unpickling runs code."""
    from gens_torch.convert import mnasnet_state

    with open(path, "rb") as f:
        tree = pickle.load(f)
    encoder.load_state_dict(mnasnet_state(tree), strict=True)
