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

``reg_network.use_global_attn`` puts :class:`GlobalAttn`, a post-norm
transformer block over the flattened voxels, at the bottleneck (the
coarsest encoder output). As flax's ``Dense`` promotes a bf16 input
against its f32 params, the block computes in f32 under ``reg_network.dtype:
bfloat16`` and its output is cast back to the bottleneck's dtype; the score
divisor is √d_keys rounded to the input's dtype (5.65625 in bf16 for
d_keys = 32). :class:`RegNetworkLite` is the single-output variant.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gens_torch.config import RegNetConfig
from gens_torch.models.feature_net import same_pad
from gens_torch.models.init import lecun_normal_, dense


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


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics E[x], E[x²] − E[x]² in f32 over the
    last axis, epsilon 1e-6, then scale and bias."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def score_divisor(d_keys: int, dtype: torch.dtype) -> float:
    """√d_keys computed in ``dtype``, as the JAX block's
    ``sqrt(asarray(d_keys, h.dtype))``: 5.65625 in bf16 for 32."""
    return float(torch.sqrt(torch.tensor(float(d_keys), dtype=dtype)))


class GlobalAttn(nn.Module):
    """Transformer block over the flattened voxels of an unbatched (C, X,
    Y, Z) volume: multi-head attention, x + relu(attn), LayerNorm, a ReLU
    feed-forward residual, LayerNorm. Returns f32 (C, X, Y, Z)."""

    def __init__(self, c: int, d_ff: int, d_keys: int, d_values: int,
                 n_heads: int):
        super().__init__()
        self.d_keys, self.n_heads = d_keys, n_heads
        self.query = dense(c, d_keys * n_heads)
        self.key = dense(c, d_keys * n_heads)
        self.value = dense(c, d_values * n_heads)
        self.out = dense(d_values * n_heads, c)
        self.norm1 = LayerNorm(c)
        self.linear1 = dense(c, d_ff)
        self.linear2 = dense(d_ff, c)
        self.norm2 = LayerNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[0]
        div = score_divisor(self.d_keys, x.dtype)
        h = x.reshape(C, -1).t().float()  # (L, C)
        L, H = h.shape[0], self.n_heads
        q = self.query(h).reshape(L, H, -1)
        k = self.key(h).reshape(L, H, -1)
        v = self.value(h).reshape(L, H, -1)
        attn = torch.softmax(torch.einsum("lhd,mhd->hlm", q, k) / div,
                             dim=-1)
        out = self.out(torch.einsum("hlm,mhd->lhd", attn, v).reshape(L, -1))
        out2 = self.norm1(h + torch.relu(out))
        ff = self.linear2(torch.relu(self.linear1(out2)))
        out = self.norm2(ff + out2)
        return out.t().reshape(x.shape)


class RegNetwork(nn.Module):
    """``blocks[k]`` is flax's (Checkpoint)Conv3dBlock_k, ``ups[k]`` its
    (Checkpoint)Upsample3dBlock_k, in creation order; ``global_attn`` is
    GlobalAttn_0 under ``use_global_attn``."""

    # one output head per scale; RegNetworkLite emits the finest alone
    single_output = False

    def __init__(self, cfg: RegNetConfig):
        super().__init__()
        self.cfg = cfg
        dv = list(cfg.d_volume)
        n = len(dv) if self.single_output else len(cfg.d_out)
        self.n = n
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
        for i in range(1 if self.single_output else n):
            blocks.append(Conv3dBlock(dec_ch[i], cfg.d_out[i],
                                      norm_relu=False))
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        ch = enc_ch[-1]
        self.global_attn = (
            GlobalAttn(ch, d_ff=2 * ch, d_keys=max(ch // 4, 8),
                       d_values=max(ch // 4, 8), n_heads=4)
            if cfg.use_global_attn and not self.single_output else None)

    def decoded(self, vols: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The decoder's volumes (C, X_i, Y_i, Z_i), fine-to-coarse, from
        the raw cascade (C, X_i, Y_i, Z_i)."""
        n = self.n
        assert len(vols) == n
        e = self.blocks[0](vols[0])
        e_outs = [e]
        for i in range(n):
            e = self.blocks[1 + 2 * i](e)
            e = self.blocks[2 + 2 * i](e)
            e_outs.append(e)
            if i < n - 1:
                e = torch.cat([e, vols[i + 1]], dim=0)
        if self.global_attn is not None:
            e_outs[-1] = self.global_attn(e_outs[-1]).to(e_outs[-1].dtype)
        d_outs = [e_outs[-1]]
        for k, i in enumerate(range(n - 1, -1, -1)):
            d_outs.append(self.ups[k](d_outs[-1]) + e_outs[i])
        return d_outs[::-1]

    def forward(self, volumes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        dt = torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32
        d_outs = self.decoded([v.permute(3, 0, 1, 2).to(dt) for v in volumes])
        return [self.blocks[1 + 2 * self.n + i](d_outs[i]).permute(1, 2, 3, 0)
                .contiguous() for i in range(self.n)]


class RegNetworkLite(RegNetwork):
    """Single-output variant (the JAX ``RegNetworkLite``): the same encoder
    and additive-skip decoder over ``len(d_volume)`` scales in f32, and only
    the finest volume (X_0, Y_0, Z_0, d_out[0]) emitted."""

    single_output = True

    def forward(self, volumes: Sequence[torch.Tensor]) -> torch.Tensor:
        d_outs = self.decoded([v.permute(3, 0, 1, 2).float() for v in volumes])
        return self.blocks[1 + 2 * self.n](d_outs[0]).permute(1, 2, 3, 0) \
            .contiguous()
