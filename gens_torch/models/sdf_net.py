"""SDF network conditioned on multi-scale volume features (counterpart of
``SDFNetwork`` and ``WNLinear`` in gens_tpu/models/sdf_net.py).

The cascade features are trilinearly sampled at the query point,
positionally encoded and concatenated into every hidden layer; the encoded
point is concatenated again at the ``skip_in`` layers and scaled by 1/√2.
Hidden layers use Softplus(β=100) in the form of ``jax.nn.softplus``:
``(max(z, 0) + log1p(exp(-|z|))) / 100`` with z = 100·h, without torch's
``threshold=20`` shortcut.

Parameters keep the JAX layout: ``lin{l}.v`` is (in, out), ``g`` and ``b``
are (out,); weight norm is taken over axis 0 (w = g·v/‖v‖). A new network
takes the NeuS geometric initialization of the JAX module (feature columns
zeroed, the output a sphere of radius ``bias``), or lecun-normal kernels
and zero biases when ``geometric_init`` is off; ``g`` starts at ‖v‖.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from gens_torch.config import SDFNetConfig
from gens_torch.models.embedder import (positional_encoding,
                                        positional_encoding_dim)
from gens_torch.models.init import lecun_normal_
from gens_torch.ops.interp import lookup_volume_cascade


def softplus100(x: torch.Tensor) -> torch.Tensor:
    z = x * 100.0
    return (torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-z.abs()))) / 100.0


class WNLinear(nn.Module):
    """Dense layer with weight normalization, (in, out) kernel ``v``."""

    def __init__(self, d_in: int, d_out: int, weight_norm: bool = True):
        super().__init__()
        self.v = nn.Parameter(torch.randn(d_in, d_out) / math.sqrt(d_in))
        self.b = nn.Parameter(torch.zeros(d_out))
        self.g = (nn.Parameter(torch.linalg.norm(self.v.detach(), dim=0))
                  if weight_norm else None)

    def effective_weight(self) -> torch.Tensor:
        if self.g is None:
            return self.v
        return self.v * (self.g / (torch.linalg.norm(self.v, dim=0)
                                   + 1e-12))[None, :]

    def forward(self, x):
        w = self.effective_weight()
        return x @ w.to(x.dtype) + self.b.to(x.dtype)


class SDFNetwork(nn.Module):
    def __init__(self, cfg: SDFNetConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        d_in = positional_encoding_dim(c.multires, c.d_in)
        d_feat = positional_encoding_dim(c.feat_multires, c.feat_channels)
        dims = [d_in] + [c.d_hidden + d_feat] * c.n_layers + [c.d_out]
        self.dims = dims
        self.d_in_embedded = d_in
        self.d_feat_embedded = d_feat
        layers = []
        for l in range(len(dims) - 1):
            out_dim = dims[l + 1]
            if l + 1 in c.skip_in:
                out_dim -= dims[0]
            if l < len(dims) - 2:
                out_dim -= d_feat
            if out_dim <= 0:
                raise ValueError(f"layer {l}: non-positive width {out_dim}")
            layers.append(WNLinear(dims[l], out_dim, c.weight_norm))
        # named lin0..lin{L} like the flax modules
        for l, layer in enumerate(layers):
            self.add_module(f"lin{l}", layer)
        self.n_lin = len(layers)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The JAX module's initialization (``_geo_w_init`` / ``_geo_b_init``
        of gens_tpu/models/sdf_net.py), drawn from torch's generator."""
        c = self.cfg
        dims, d_feat = self.dims, self.d_feat_embedded
        num_layers = len(dims)
        for l, layer in enumerate(self.layers()):
            v, b = layer.v, layer.b
            d_in_l, d_out_l = v.shape
            std = math.sqrt(2) / math.sqrt(d_out_l)
            b.zero_()
            if not c.geometric_init:
                lecun_normal_(v, d_in_l)
            elif l == num_layers - 2:
                mean = math.sqrt(math.pi) / math.sqrt(d_in_l)
                v.normal_(0.0, 1e-4).add_(-mean if c.inside_outside else mean)
                v[-d_feat:, :] = 0.0
                b.fill_(c.bias if c.inside_outside else -c.bias)
                b[-d_feat:] = 0.0
            elif c.multires > 0 and l == 0:
                v.zero_()
                v[:3, :].normal_(0.0, std)
            elif c.multires > 0 and l in c.skip_in:
                v.normal_(0.0, std)
                v[-(dims[0] - 3 + d_feat):, :] = 0.0
            else:
                v.normal_(0.0, std)
                v[-d_feat:, :] = 0.0
            if layer.g is not None:
                layer.g.copy_(torch.linalg.norm(v, dim=0))

    def layers(self) -> List[WNLinear]:
        return [getattr(self, f"lin{l}") for l in range(self.n_lin)]

    def effective_weights(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Weight norm folded into dense (W (in, out), b) pairs."""
        return [(layer.effective_weight(), layer.b) for layer in self.layers()]

    def encode(self, pts: torch.Tensor, volumes: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(PE(pts·scale) (N, d_in), PE(cascade features) (N, d_feat)), f32.
        ``sdf_network.volume_dtype`` bf16 rounds the cascade before the
        lookup."""
        c = self.cfg
        if c.volume_dtype == "bfloat16":
            volumes = [v.to(torch.bfloat16) for v in volumes]
        feats = lookup_volume_cascade(volumes, pts).float()
        feats_pe = positional_encoding(feats, c.feat_multires)
        x_pe = positional_encoding(pts * c.scale, c.multires)
        return x_pe, feats_pe

    def forward(self, pts: torch.Tensor, volumes: Sequence[torch.Tensor]
                ) -> torch.Tensor:
        """pts (N, 3) -> (N, d_out): [sdf, latent...], f32."""
        c = self.cfg
        inputs, feats = self.encode(pts, volumes)
        cdt = torch.bfloat16 if c.mlp_dtype == "bfloat16" else torch.float32
        inputs, feats = inputs.to(cdt), feats.to(cdt)
        x = inputs
        num_layers = len(self.dims)
        for l, layer in enumerate(self.layers()):
            if l in c.skip_in:
                x = torch.cat([x, inputs], dim=-1) / math.sqrt(2)
            if 0 < l < num_layers - 1:
                x = torch.cat([x, feats], dim=-1)
            x = layer(x)
            if l < num_layers - 2:
                x = softplus100(x)
        x = x.float()
        return torch.cat([x[..., :1] / c.scale, x[..., 1:]], dim=-1)

    def sdf(self, pts: torch.Tensor, volumes) -> torch.Tensor:
        return self(pts, volumes)[..., 0]
