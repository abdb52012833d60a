"""GenS model facade (counterpart of gens_tpu/models/gens.py): owns the
modules, builds a ``Scene`` for the generalizable regime -- feature net ->
cross-view volume aggregation -> 3D U-Net -- and runs the training forward
(build the scene under autograd, render the ray batch, pseudo-point SDF).

The JAX parameter tree's top-level keys map to submodules: ``feature``,
``match_feature`` (the frozen matching copy), ``reg``, ``sdf``,
``blending`` and ``variance`` (``convert.py`` does the mapping).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from gens_torch.config import ModelConfig
from gens_torch.models.blending_net import (BlendingNetwork,
                                            SingleVarianceNetwork)
from gens_torch.models.feature_net import FeatureNetwork
from gens_torch.models.reg_net import RegNetwork
from gens_torch.models.renderer import Renderer, Scene
from gens_torch.models.sdf_net import SDFNetwork
from gens_torch.models.volume import agg_mean_var
from gens_torch.ops.interp import combine_mask_cascade


class GenSModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.feature_network.backbone != "fpn":
            raise NotImplementedError(
                "only the fpn backbone is ported; see ROADMAP.md")
        if cfg.volume.agg != "mean_var":
            raise NotImplementedError(
                "only mean_var aggregation is ported; see ROADMAP.md")
        if cfg.color_network.head != "blending":
            raise NotImplementedError(
                "only the blending color head is ported; see ROADMAP.md")
        self.cfg = cfg
        self.feature = FeatureNetwork(cfg.feature_network)
        self.match_feature = FeatureNetwork(cfg.feature_network)
        # the frozen matching copy (resynced from ``feature`` by the trainer)
        self.match_feature.load_state_dict(self.feature.state_dict())
        self.match_feature.requires_grad_(False)
        self.reg = RegNetwork(cfg.reg_network)
        self.sdf = SDFNetwork(cfg.sdf_network)
        self.blending = BlendingNetwork(cfg.color_network)
        self.variance = SingleVarianceNetwork(cfg.variance_network.init_val)
        cn = cfg.color_network
        self.renderer = Renderer(
            self.sdf, self.blending, self.variance, cfg.render,
            bf16_color_maps=bool(cn.packed_bilerp)
            and cn.packed_dtype == "bfloat16")

    def extract_features(self, imgs: torch.Tensor, match: bool = False
                         ) -> Tuple[torch.Tensor, ...]:
        """The matching copy is frozen: its features carry no graph."""
        if match:
            with torch.no_grad():
                return self.match_feature(imgs)
        return self.feature(imgs)

    def build_volumes(self, features: Sequence[torch.Tensor],
                      intrs: torch.Tensor, c2ws: torch.Tensor
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        v = self.cfg.volume
        raw_vols, mask_vols = agg_mean_var(
            features, intrs, c2ws, v.volume_dims,
            min_vis_view=v.min_vis_view,
            out_dtype=torch.bfloat16 if v.dtype == "bfloat16" else None,
            packed_bilerp=v.packed_bilerp, splat_mm_dtype=v.splat_mm_dtype)
        return self.reg(raw_vols), mask_vols

    def build_scene(self, imgs: torch.Tensor, intrs: torch.Tensor,
                    c2ws: torch.Tensor) -> Scene:
        """imgs (V, H, W, 3), intrs (V, 3, 3), c2ws (V, 4, 4) -> Scene."""
        features = self.extract_features(imgs)
        match_features = self.extract_features(imgs, match=True)
        volumes, mask_vols = self.build_volumes(features, intrs, c2ws)
        return Scene(volumes=volumes, mask_volumes=mask_vols,
                     features=features, match_features=match_features,
                     imgs=imgs, intrs=intrs, c2ws=c2ws,
                     mask_any=combine_mask_cascade(mask_vols))

    def forward_train(self, inputs: Dict[str, torch.Tensor],
                      cos_anneal_ratio: float, use_match_features: bool,
                      generator: Optional[torch.Generator] = None,
                      perturb_noise: Optional[torch.Tensor] = None,
                      sparse_pts: Optional[torch.Tensor] = None) -> Dict:
        """One training forward (the JAX ``forward_train``): build the
        scene, then :meth:`render_train`. ``inputs``: imgs (V,H,W,3), intrs
        (V,3,3), c2ws (V,4,4), rays_o/rays_d (R,3), near/far (1,1) or (R,1),
        optional pseudo_pts (P,3)."""
        scene = self.build_scene(inputs["imgs"], inputs["intrs"],
                                 inputs["c2ws"])
        return self.render_train(scene, inputs, cos_anneal_ratio,
                                 use_match_features, generator,
                                 perturb_noise, sparse_pts)

    def render_train(self, scene: Scene, inputs: Dict[str, torch.Tensor],
                     cos_anneal_ratio: float, use_match_features: bool,
                     generator: Optional[torch.Generator] = None,
                     perturb_noise: Optional[torch.Tensor] = None,
                     sparse_pts: Optional[torch.Tensor] = None) -> Dict:
        """Render the ray batch with the training outputs, and the SDF at
        ``pseudo_pts`` when the batch has them."""
        outputs = self.renderer.render(
            inputs["rays_o"], inputs["rays_d"], inputs["near"],
            inputs["far"], scene, cos_anneal_ratio=cos_anneal_ratio,
            train=True, use_match_features=use_match_features,
            generator=generator, perturb_noise=perturb_noise,
            sparse_pts=sparse_pts)
        if "pseudo_pts" in inputs:
            outputs["pseudo_sdf"] = self.renderer.pseudo_sdf(
                scene, inputs["pseudo_pts"])
        return outputs
