"""GenS model facade (counterpart of gens_tpu/models/gens.py): owns the
modules, builds a ``Scene`` for the generalizable regime -- feature net ->
cross-view volume aggregation -> 3D U-Net -- and runs the training forward
(build the scene under autograd, render the ray batch, pseudo-point SDF).

Under the ``view`` axis (``parallel/sharded.py``) a rank builds the scene
from its own views: their features feed the aggregation, whose sums are
summed over the view group, and the features, images and cameras of all
ranks are gathered for the blending and the MFC warp, cut to the real
views.

In the finetune regime the volumes are built once from all views
(:meth:`GenSModel.init_volumes`) and become parameters of their own; the
masks and features stay frozen, and :meth:`GenSModel.forward_finetune`
renders from them.

The JAX parameter tree's top-level keys map to submodules: ``feature``,
``match_feature`` (the frozen matching copy), ``reg``, ``sdf``,
``blending`` and ``variance`` (``convert.py`` does the mapping).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gens_torch.config import ModelConfig
from gens_torch.models.blending_net import (BlendingNetwork,
                                            SingleVarianceNetwork)
from gens_torch.models.feature_net import FeatureNetwork
from gens_torch.models.reg_net import RegNetwork
from gens_torch.models.renderer import Renderer, Scene
from gens_torch.models.sdf_net import SDFNetwork
from gens_torch.models.volume import agg_mean_var, voxel_grid
from gens_torch.ops.interp import combine_mask_cascade
from gens_torch.parallel.collectives import all_gather_views


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
        if cfg.reg_network.use_global_attn:
            raise NotImplementedError(
                "reg_network.use_global_attn (GlobalAttn at the U-Net "
                "bottleneck) is not ported; see ROADMAP.md A4")
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
                      intrs: torch.Tensor, c2ws: torch.Tensor,
                      view_valid: Optional[torch.Tensor] = None, group=None
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """The raw cascade through ``agg_mean_var`` (``view_valid`` and the
        view ``group`` passed on), then the U-Net."""
        v = self.cfg.volume
        raw_vols, mask_vols = agg_mean_var(
            features, intrs, c2ws, v.volume_dims,
            min_vis_view=v.min_vis_view,
            out_dtype=torch.bfloat16 if v.dtype == "bfloat16" else None,
            packed_bilerp=v.packed_bilerp, splat_mm_dtype=v.splat_mm_dtype,
            splat_impl=v.splat_impl, view_valid=view_valid, group=group)
        return self.reg(raw_vols), mask_vols

    def build_scene(self, imgs: torch.Tensor, intrs: torch.Tensor,
                    c2ws: torch.Tensor,
                    view_valid: Optional[torch.Tensor] = None, group=None,
                    n_views: Optional[int] = None) -> Scene:
        """imgs (V, H, W, 3), intrs (V, 3, 3), c2ws (V, 4, 4) -> Scene.
        With a view ``group`` these are this rank's views (``view_valid``
        zero on padding): the volumes come from the group's sums, and the
        scene holds the group's features, images and cameras gathered in
        rank order and cut to the first ``n_views``."""
        features = self.extract_features(imgs)
        match_features = self.extract_features(imgs, match=True)
        volumes, mask_vols = self.build_volumes(features, intrs, c2ws,
                                                view_valid, group)
        if group is not None:
            def gather(xs):
                # one collective for the list: flattened per view, split back
                flat = all_gather_views(torch.cat(
                    [x.reshape(x.shape[0], -1) for x in xs], dim=1),
                    group)[:n_views]
                sizes = [x[0].numel() for x in xs]
                return [f.reshape((n_views,) + x.shape[1:]) for f, x in
                        zip(torch.split(flat, sizes, dim=1), xs)]

            features = gather(features)
            match_features = gather(match_features)
            imgs, intrs, c2ws = gather([imgs, intrs, c2ws])
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

    # -- finetune regime (volumes as parameters) ------------------------------

    @torch.no_grad()
    def init_volumes(self, imgs: torch.Tensor, intrs: torch.Tensor,
                     c2ws: torch.Tensor
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                List[torch.Tensor]]:
        """The one-shot volume build from all views of a scene: (volumes,
        mask volumes, features), with no graph. The volumes become the
        finetune's parameters; the masks and features stay frozen."""
        features = self.extract_features(imgs)
        volumes, mask_vols = self.build_volumes(features, intrs, c2ws)
        return ([v.detach() for v in volumes], list(mask_vols),
                [f.detach() for f in features])

    @torch.no_grad()
    def filter_volume(self, volumes: Sequence[torch.Tensor],
                      mask_volumes: Sequence[torch.Tensor],
                      thresh: float = 0.1) -> List[torch.Tensor]:
        """Narrow-band mask pruning (the reference implemented it and left
        its call disabled; so does the runner): keep the voxels of the
        finest grid whose |SDF| is below ``thresh`` and that lie inside the
        unit sphere, dilated by one voxel, and AND that into every cascade
        mask with a nearest 2x downsampling between scales."""
        dim = mask_volumes[0].shape[0]
        pts = voxel_grid(dim, mask_volumes[0].device)
        chunk = min(pts.shape[0], 128 ** 3 // 8)
        band = torch.cat([
            (self.sdf.sdf(pts[i:i + chunk], volumes).abs() < thresh).float()
            for i in range(0, pts.shape[0], chunk)])
        inside = (torch.linalg.norm(pts, dim=-1) < 1.0).float()
        mask = (band * inside).reshape(1, 1, dim, dim, dim)
        mask = F.max_pool3d(mask, 3, stride=1, padding=1)[0, 0]
        out = []
        for m in mask_volumes:
            out.append(m * mask)
            mask = mask[::2, ::2, ::2]
        return out

    def forward_finetune(self, volumes: Sequence[torch.Tensor],
                         mask_volumes: Sequence[torch.Tensor],
                         features: Sequence[torch.Tensor],
                         inputs: Dict[str, torch.Tensor],
                         cos_anneal_ratio: float,
                         generator: Optional[torch.Generator] = None,
                         perturb_noise: Optional[torch.Tensor] = None,
                         sparse_pts: Optional[torch.Tensor] = None) -> Dict:
        """One finetune forward (the JAX ``forward_finetune``): the frozen
        features gathered by ``inputs["view_ids"]`` serve as the features
        and the matching features of a scene on the trainable ``volumes``;
        render with the training outputs."""
        view_ids = inputs["view_ids"]
        feats = [f.index_select(0, view_ids) for f in features]
        scene = Scene(volumes=list(volumes), mask_volumes=list(mask_volumes),
                      features=feats, match_features=feats,
                      imgs=inputs["imgs"], intrs=inputs["intrs"],
                      c2ws=inputs["c2ws"])
        return self.render_train(scene, inputs, cos_anneal_ratio, True,
                                 generator, perturb_noise, sparse_pts)
