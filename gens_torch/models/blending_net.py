"""IBRNet-style source-view colour blending and the NeuS variance scalar
(counterpart of ``BlendingNetwork`` and ``SingleVarianceNetwork`` in
gens_tpu/models/blending_net.py).

Per sample and source view, warped RGB + features and a ray-difference
embedding are fused by a weighted cross-view mean/variance, refined by
visibility MLPs, and softmax-blended over the source views into an RGB.
``mlps[i].layers[j]`` is flax's MLP_i/Dense_j.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gens_torch.config import BlendingNetConfig
from gens_torch.models.init import he_normal_


def _fused_mean_variance(x, weight):
    mean = torch.sum(x * weight, dim=1, keepdim=True)
    var = torch.sum(weight * (x - mean) ** 2, dim=1, keepdim=True)
    return mean, var


class MLP(nn.Module):
    def __init__(self, d_in: int, features, final_act: str = "elu"):
        super().__init__()
        layers, c = [], d_in
        for f in features:
            lin = nn.Linear(c, f)
            he_normal_(lin.weight, c)
            nn.init.zeros_(lin.bias)
            layers.append(lin)
            c = f
        self.layers = nn.ModuleList(layers)
        self.final_act = final_act

    def forward(self, x, dtype=None):
        for i, lin in enumerate(self.layers):
            w, b = lin.weight, lin.bias
            if dtype is not None:
                w, b = w.to(dtype), b.to(dtype)
            x = F.linear(x, w, b)
            if i < len(self.layers) - 1:
                x = F.elu(x)
        if self.final_act == "elu":
            x = F.elu(x)
        elif self.final_act == "sigmoid":
            x = torch.sigmoid(x)
        return x


class BlendingNetwork(nn.Module):
    def __init__(self, cfg: BlendingNetConfig):
        super().__init__()
        self.cfg = cfg
        F_ = cfg.d_feature + 3
        self.mlps = nn.ModuleList([
            MLP(4, (16, F_)),
            MLP(3 * F_, (64, 32)),
            MLP(32, (32, 33)),
            MLP(32, (32, 1), final_act="sigmoid"),
            MLP(32 + 1 + 4, (16, 8, 1), final_act="none"),
        ])
        self.s = (nn.Parameter(torch.tensor(0.2))
                  if cfg.anti_alias_pooling else None)

    def forward(self, rgb_feat: torch.Tensor, ray_diff: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """rgb_feat (N, S, 3+C); ray_diff (N, S, 4); mask (N, S) -> (N, 3)."""
        cdt = torch.bfloat16 if self.cfg.mlp_dtype == "bfloat16" else None
        if cdt is not None:
            rgb_feat, ray_diff = rgb_feat.to(cdt), ray_diff.to(cdt)
        mask = mask[..., None].to(rgb_feat.dtype)
        num_views = rgb_feat.shape[1]

        direction_feat = self.mlps[0](ray_diff, cdt)
        rgb_in = rgb_feat[..., :3]
        rgb_feat = rgb_feat + direction_feat

        if self.s is not None:
            dot_prod = ray_diff[..., 3:4]
            exp_dot = torch.exp(self.s.abs().to(rgb_feat.dtype)
                                * (dot_prod - 1.0))
            weight = (exp_dot - torch.amin(exp_dot, dim=1, keepdim=True)
                      ) * mask
            weight = weight / (torch.sum(weight, dim=1, keepdim=True) + 1e-8)
        else:
            weight = mask / (torch.sum(mask, dim=1, keepdim=True) + 1e-8)

        mean, var = _fused_mean_variance(rgb_feat, weight)
        globalfeat = torch.cat([mean, var], dim=-1)
        x = torch.cat([globalfeat.expand(-1, num_views, -1), rgb_feat], dim=-1)
        x = self.mlps[1](x, cdt)

        x_vis = self.mlps[2](x * weight, cdt)
        x_res, vis = x_vis[..., :-1], x_vis[..., -1:]
        vis = torch.sigmoid(vis) * mask
        x = x + x_res
        vis = self.mlps[3](x * vis, cdt) * mask

        x = torch.cat([x, vis, ray_diff], dim=-1)
        x = self.mlps[4](x, cdt)
        x = torch.where(mask == 0, torch.full_like(x.float(), -1e9), x.float())
        blend = torch.softmax(x, dim=1)
        return torch.sum(rgb_in.float() * blend, dim=1)


class SingleVarianceNetwork(nn.Module):
    """NeuS single learnable inverse variance: exp(10·variance)."""

    def __init__(self, init_val: float = 0.3):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(float(init_val)))

    def forward(self):
        return torch.exp(self.variance * 10.0)
