"""3D U-Net volume regularizer (counterpart of ``RegNetwork``,
``Conv3dBlock`` and ``Upsample3dBlock`` in gens_tpu/models/reg_net.py).

The JAX block computes its 3x3x3 conv as three x-shifted 2D convs over
(Y, Z) -- a TPU layout workaround -- with a stored (3, 3, 3C, out) kernel
laid out [w_up | w_mid | w_dn] and applied to x[i+1], x[i], x[i-1]. Here it
is one ``Conv3d`` over (D, H, W) = (X, Y, Z) whose kx = 0, 1, 2 taps hold
w_dn, w_mid, w_up (``convert.py`` does the reordering).

Stride 2 is asymmetric in the JAX block: X is padded (1, 1) and the even
outputs are kept, while Y and Z use 2D 'SAME' padding, which is (0, 1) on
an even size. :class:`Conv3dBlock` pads exactly that and convolves with
padding 0. InstanceNorm is E[y²] − E[y]² in f32, as in the JAX block.

Public call: a list of (X_i, Y_i, Z_i, C) volumes in, a list of
(X_i, Y_i, Z_i, d_out[i]) volumes out (no batch axis).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gens_torch.config import RegNetConfig
from gens_torch.models.feature_net import same_pad
from gens_torch.models.init import lecun_normal_


class Conv3dBlock(nn.Module):
    """3x3x3 conv (+ InstanceNorm + ReLU, or + bias when ``norm_relu`` is
    off) on an unbatched (C, X, Y, Z) tensor."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 norm_relu: bool = True):
        super().__init__()
        self.stride = stride
        self.norm_relu = norm_relu
        self.weight = nn.Parameter(torch.empty(c_out, c_in, 3, 3, 3))
        lecun_normal_(self.weight, 27 * c_in)
        self.bias = None if norm_relu else nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, X, Y, Z = x.shape
        if self.stride == 2:
            py, pz = same_pad(Y, 3, 2), same_pad(Z, 3, 2)
            pad = (pz[0], pz[1], py[0], py[1], 1, 1)
        else:
            pad = (1, 1, 1, 1, 1, 1)
        w = self.weight.to(x.dtype)
        y = F.conv3d(F.pad(x, pad)[None], w, stride=self.stride)[0]
        if not self.norm_relu:
            return y + self.bias.to(y.dtype)[:, None, None, None]
        mean = y.mean(dim=(1, 2, 3), keepdim=True, dtype=torch.float32)
        meansq = y.square().mean(dim=(1, 2, 3), keepdim=True,
                                 dtype=torch.float32)
        var = torch.clamp(meansq - mean.square(), min=0.0)
        scale = torch.rsqrt(var + 1e-5)
        y = (y - mean.to(y.dtype)) * scale.to(y.dtype)
        return F.relu(y)


class Upsample3dBlock(nn.Module):
    """x2 nearest upsample + 3x3x3 conv + InstanceNorm + ReLU."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = Conv3dBlock(c_in, c_out)

    def forward(self, x):
        x = (x.repeat_interleave(2, 1).repeat_interleave(2, 2)
             .repeat_interleave(2, 3))
        return self.conv(x)


class RegNetwork(nn.Module):
    """``blocks[k]`` is flax's (Checkpoint)Conv3dBlock_k, ``ups[k]`` its
    (Checkpoint)Upsample3dBlock_k, in creation order."""

    def __init__(self, cfg: RegNetConfig):
        super().__init__()
        self.cfg = cfg
        n = len(cfg.d_out)
        dv = list(cfg.d_volume)
        blocks = [Conv3dBlock(dv[0], cfg.d_base)]
        c = cfg.d_base
        enc_ch = [c]
        for i in range(n):
            dim_m = cfg.d_base * 2 ** i
            blocks.append(Conv3dBlock(c, dim_m, stride=2))
            blocks.append(Conv3dBlock(dim_m, dim_m))
            enc_ch.append(dim_m)
            c = dim_m + (dv[i + 1] if i < n - 1 else 0)
        ups = []
        d_ch = enc_ch[-1]
        dec_ch = [None] * n
        for i in range(n - 1, -1, -1):
            out = cfg.d_base * 2 ** max(i - 1, 0)
            ups.append(Upsample3dBlock(d_ch, out))
            d_ch = out
            dec_ch[i] = out
        for i in range(n):
            blocks.append(Conv3dBlock(dec_ch[i], cfg.d_out[i],
                                      norm_relu=False))
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)

    def forward(self, volumes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        n = len(self.cfg.d_out)
        assert len(volumes) == n
        dt = torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32
        vols = [v.permute(3, 0, 1, 2).to(dt) for v in volumes]
        e = self.blocks[0](vols[0])
        e_outs = [e]
        for i in range(n):
            e = self.blocks[1 + 2 * i](e)
            e = self.blocks[2 + 2 * i](e)
            e_outs.append(e)
            if i < n - 1:
                e = torch.cat([e, vols[i + 1]], dim=0)
        d_outs = [e_outs[-1]]
        for k, i in enumerate(range(n - 1, -1, -1)):
            d_outs.append(self.ups[k](d_outs[-1]) + e_outs[i])
        d_outs = d_outs[::-1]
        return [self.blocks[1 + 2 * n + i](d_outs[i]).permute(1, 2, 3, 0)
                .contiguous() for i in range(n)]
