"""IDR-style colour head (counterpart of ``RenderingNetwork`` and
``rendering_input_dim`` in gens_tpu/models/rendering_net.py): RGB from the
point, the SDF normal, the view direction and the SDF latent, through
weight-normalized linear layers, an optional 1/√2-scaled input skip and a
sigmoid squeeze (the JAX module's defaults, which the model uses: 3
outputs, weight norm and the squeeze always on). ``color_network.head: idr`` puts it in place of the
blending network.

The call is ``(points, normals, view_dirs, features)``; mode "idr"
concatenates ``[points, view_dirs, normals, features]``. It computes in
f32 whatever ``color_network.mlp_dtype`` says, as the JAX module is not
given that dtype. ``lin{k}`` are the flax layers of the same names.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from gens_torch.models.embedder import (positional_encoding,
                                        positional_encoding_dim)
from gens_torch.models.init import lecun_normal_
from gens_torch.models.sdf_net import WNLinear


def rendering_input_dim(mode: str, d_feature: int, multires_view: int) -> int:
    d_view = positional_encoding_dim(multires_view, 3)
    if mode == "idr":
        return 3 + d_view + 3 + d_feature
    if mode == "no_view_dir":
        return 3 + 3 + d_feature
    if mode == "no_normal":
        return 3 + d_view + d_feature
    raise ValueError(f"unknown rendering mode {mode!r}")


class RenderingNetwork(nn.Module):
    def __init__(self, d_feature: int = 128, mode: str = "idr",
                 d_hidden: int = 256, n_layers: int = 4,
                 skip_in: Sequence[int] = (), multires_view: int = 0):
        super().__init__()
        self.mode = mode
        self.skip_in = tuple(skip_in)
        self.multires_view = multires_view
        d_in = rendering_input_dim(mode, d_feature, multires_view)
        dims = [d_in] + [d_hidden] * n_layers + [3]
        self.n_lin = len(dims) - 1
        prev = d_in
        for layer in range(self.n_lin):
            out_dim = dims[layer + 1]
            if layer + 1 in self.skip_in:
                out_dim -= d_in
            in_dim = prev + (d_in if layer in self.skip_in else 0)
            lin = WNLinear(in_dim, out_dim)
            with torch.no_grad():
                lecun_normal_(lin.v, in_dim)
                lin.g.copy_(torch.linalg.norm(lin.v, dim=0))
            prev = out_dim
            self.add_module(f"lin{layer}", lin)

    def forward(self, points: torch.Tensor, normals: torch.Tensor,
                view_dirs: torch.Tensor, features: torch.Tensor
                ) -> torch.Tensor:
        if self.multires_view > 0:
            view_dirs = positional_encoding(view_dirs, self.multires_view)
        if self.mode == "idr":
            parts = [points, view_dirs, normals, features]
        elif self.mode == "no_view_dir":
            parts = [points, normals, features]
        else:
            parts = [points, view_dirs, features]
        x = inp = torch.cat([p.float() for p in parts], dim=-1)
        for layer in range(self.n_lin):
            if layer in self.skip_in:
                x = torch.cat([x, inp], dim=-1) / math.sqrt(2.0)
            x = getattr(self, f"lin{layer}")(x)
            if layer < self.n_lin - 1:
                x = torch.relu(x)
        return torch.sigmoid(x)
