"""NeuS-style SDF volume renderer with IBRNet blending and the MFC patch
warp (counterpart of gens_tpu/models/renderer.py).

Every sample is evaluated densely and out-of-volume points take the SDF
sentinel, as in the JAX renderer. ``render_core(train=False)`` returns the
keys validation reads; ``train=True`` adds the training outputs: the
Hessian·1 ``smooth`` term, Eikonal residuals, sparse random-point SDF, the
TV regularizer and the patch warp of the multi-view feature consistency
(MFC) loss, all differentiable w.r.t. the parameters and the volumes.

Under ``color_network.head: idr`` the colour head takes (points, masked SDF
gradients, view directions, SDF latent) instead of the source views'
warped features, and every ray counts as valid; in training the colour
loss then differentiates through the normals as well.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from gens_torch.config import RenderConfig
from gens_torch.ops.capture import cumprod_no_zero, inverse
from gens_torch.ops.fused_mlp import sdf_fused_fn
from gens_torch.ops.interp import (combine_mask_cascade, lookup_mask,
                                   round_bf16, safe_norm)
from gens_torch.ops.projection import (apply_linear, lookup_feature,
                                       surface_patch_warp)
from gens_torch.ops.sampling import SDF_SENTINEL, hierarchical_sample
from gens_torch.utils.profiling import span


@dataclass
class Scene:
    """Per-scene conditioning inputs (tensors on one device).

    volumes / mask_volumes: cascade lists (X,Y,Z,C) / (X,Y,Z); features /
    match_features: per-scale (V, H_i, W_i, C); imgs (V, H, W, 3);
    intrs (V, 3, 3); c2ws (V, 4, 4); mask_any: the OR'd finest mask."""

    volumes: List[torch.Tensor]
    mask_volumes: List[torch.Tensor]
    features: Any
    match_features: Any
    imgs: torch.Tensor
    intrs: torch.Tensor
    c2ws: torch.Tensor
    mask_any: Optional[torch.Tensor] = None

    def mask(self) -> torch.Tensor:
        if self.mask_any is None:
            self.mask_any = combine_mask_cascade(self.mask_volumes)
        return self.mask_any


def tv_regularization(volumes: Sequence[torch.Tensor],
                      mask_volumes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Masked anisotropic total variation over the cascade, weighted 0.5^i,
    each axis divided by its own mask count. The differences are taken in
    the volume's dtype and summed in f32, as in the JAX function."""
    total = 0.0
    for i, (vol, mask) in enumerate(zip(volumes, mask_volumes)):
        m = mask[..., None]
        terms = []
        for ax in range(3):
            n = vol.shape[ax]
            a, b = vol.narrow(ax, 1, n - 1), vol.narrow(ax, 0, n - 1)
            mm = (m.narrow(ax, 1, n - 1) * m.narrow(ax, 0, n - 1)) > 0
            num = torch.sum((a - b) ** 2 * mm, dtype=torch.float32)
            terms.append(num / (mm.sum() + 1e-8))
        total = total + torch.sqrt(terms[0] + terms[1] + terms[2]
                                   + 1e-12) * 0.5 ** i
    return total


def make_warp_feature_stack(features: Sequence[torch.Tensor],
                            n_scales: int = 3) -> torch.Tensor:
    """The finest ``n_scales`` feature maps (V, H_i, W_i, C) bilinearly
    resized to the finest resolution and concatenated on channels.
    ``F.interpolate(align_corners=False)`` is ``jax.image.resize`` bilinear
    for these integer upsamplings, edges included."""
    hw = features[0].shape[1:3]
    stack = [features[0]]
    for f in features[1:n_scales]:
        up = F.interpolate(f.permute(0, 3, 1, 2), size=tuple(hw),
                           mode="bilinear", align_corners=False)
        stack.append(up.permute(0, 2, 3, 1))
    return torch.cat(stack, dim=-1)


class Renderer:
    """Binds the SDF, blending and variance modules to the render math."""

    def __init__(self, sdf_net, blending_net, variance_net,
                 cfg: RenderConfig, bf16_color_maps: bool = False,
                 color_head: str = "blending"):
        self.sdf = sdf_net
        self.blending = blending_net
        self.variance = variance_net
        self.cfg = cfg
        # color_network.packed_bilerp with packed_dtype bf16: the JAX path
        # reads bf16 copies of the source-view maps and the warp stack, and
        # its gradients reach the f32 maps (round_bf16)
        self.bf16_color_maps = bf16_color_maps
        self.color_head = color_head

    # -- SDF helpers -------------------------------------------------------

    def sdf_fn(self, volumes) -> Callable[[torch.Tensor], torch.Tensor]:
        def f(pts):
            return self.sdf.sdf(pts, volumes)
        return f

    def sdf_value_grad(self, volumes, pts: torch.Tensor):
        """(full output (N, C), ∇SDF (N, 3)) via one backward pass w.r.t.
        the points; no graph is kept."""
        with torch.enable_grad():
            p = pts.detach().requires_grad_(True)
            out = self.sdf(p, volumes)
            (grad,) = torch.autograd.grad(out[:, 0].sum(), p)
        return out.detach(), grad

    def sdf_gradient(self, volumes, pts: torch.Tensor) -> torch.Tensor:
        """First-order ∇SDF only."""
        return self.sdf_value_grad(volumes, pts)[1]

    def sdf_value_grad_smooth(self, volumes, pts: torch.Tensor):
        """(full output (N, C), ∇SDF (N, 3), Hessian·1 (N, 3)), all with
        their graphs kept, so a loss on any of them differentiates w.r.t.
        the SDF parameters and the volumes (third order through trilerp).
        Hessian·1 is the gradient of Σ_i ∂sdf/∂x_i, the reference's
        grad(grad(sdf) @ ones); the JAX function takes it as a jvp."""
        p = pts.detach().requires_grad_(True)
        out = self.sdf(p, volumes)
        (grad,) = torch.autograd.grad(out[:, 0].sum(), p, create_graph=True)
        (smooth,) = torch.autograd.grad(grad, p, torch.ones_like(grad),
                                        create_graph=True)
        return out, grad, smooth

    def sdf_fn_for_extraction(self, volumes):
        """Gradient-free SDF for dense grid evaluation through K4 (lookup +
        PE) and K3 (MLP): the CUDA kernels for volumes on the card, their
        plain versions on the CPU."""
        return sdf_fused_fn(self.sdf, volumes)

    # -- core --------------------------------------------------------------

    def render_core(self, rays_o, rays_d, z_vals, sample_dist, scene: Scene,
                    cos_anneal_ratio: float = 1.0, train: bool = False,
                    use_match_features: bool = False,
                    sparse_pts: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        """The JAX ``render_core``. ``sparse_pts`` (P, 3) are the random
        points of the sparse SDF term (training)."""
        cfg = self.cfg
        R, S = z_vals.shape
        mask_any = scene.mask()

        dists = z_vals[:, 1:] - z_vals[:, :-1]
        dists = torch.cat([dists, torch.full_like(dists[:, :1], sample_dist)],
                          dim=-1)
        mid_z = z_vals + dists * 0.5
        pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]
        dirs = rays_d[:, None, :].expand(pts.shape)
        pts_flat = pts.reshape(-1, 3)
        dirs_flat = dirs.reshape(-1, 3)

        voxel_mask = lookup_mask(mask_any, pts_flat)
        if train:
            sdf_out, gradients, smooth = self.sdf_value_grad_smooth(
                scene.volumes, pts_flat)
            smooth = smooth * voxel_mask[:, None]
        else:
            sdf_out, gradients = self.sdf_value_grad(scene.volumes, pts_flat)
        sdf = torch.where(voxel_mask > 0, sdf_out[:, 0],
                          torch.full_like(sdf_out[:, 0], SDF_SENTINEL))
        gradients = gradients * voxel_mask[:, None]

        view_mask = None
        if self.color_head == "idr":
            sampled_color = self.blending(pts_flat, gradients, dirs_flat,
                                          sdf_out[:, 1:])
        else:
            imgs, feats = scene.imgs, scene.features
            if self.bf16_color_maps:
                imgs = round_bf16(imgs)
                feats = [round_bf16(f) for f in feats]
            rgb_feat, ray_diff, view_mask = lookup_feature(
                pts_flat, imgs, scene.intrs, scene.c2ws, feats)
            sampled_color = self.blending(rgb_feat, ray_diff, view_mask)
        sampled_color = (sampled_color * voxel_mask[:, None]).reshape(R, S, 3)

        inv_s = torch.clamp(self.variance(), 1e-6, 1e6)
        true_cos = torch.sum(dirs_flat * gradients, dim=-1, keepdim=True)
        iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5)
                     * (1.0 - cos_anneal_ratio)
                     + torch.relu(-true_cos) * cos_anneal_ratio)
        iter_cos = iter_cos * voxel_mask[:, None]
        dists_flat = dists.reshape(-1, 1)
        ic = torch.clamp(iter_cos, -10.0, 10.0)
        est_next = sdf[:, None] + ic * dists_flat * 0.5
        est_prev = sdf[:, None] - ic * dists_flat * 0.5
        prev_cdf = torch.sigmoid(est_prev * inv_s)
        next_cdf = torch.sigmoid(est_next * inv_s)
        alpha = torch.clamp(((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
                             ).reshape(R, S), 0.0, 1.0)
        vmask_rs = voxel_mask.reshape(R, S)
        alpha = alpha * vmask_rs

        pts_norm = torch.linalg.norm(pts_flat, dim=-1).reshape(R, S)
        inside_sphere = (pts_norm < 1.0).float() * vmask_rs

        # every factor is at least 1e-7
        trans = cumprod_no_zero(torch.cat(
            [torch.ones((R, 1), dtype=alpha.dtype, device=alpha.device),
             1.0 - alpha + 1e-7], dim=-1), dim=-1)[:, :-1]
        weights = alpha * trans
        color = torch.sum(sampled_color * weights[..., None], dim=1)

        rot = inverse(scene.c2ws[0, :3, :3])
        normal = apply_linear(
            torch.sum(gradients.reshape(R, S, 3) * weights[..., None], dim=1),
            rot)
        cam_rays_d = apply_linear(rays_d, rot)
        render_depth = torch.sum(mid_z * weights, dim=1) * cam_rays_d[:, 2]

        # zero-crossing surface localization (corrected Eq. 7 root)
        sdf_d = sdf.reshape(R, S)
        prev_sdf, next_sdf = sdf_d[:, :-1], sdf_d[:, 1:]
        seg_valid = ((vmask_rs[:, :-1] * vmask_rs[:, 1:]) > 0).float()
        sign = (prev_sdf * next_sdf <= 0).float()
        idx_w = torch.arange(S - 1, 0, -1, dtype=torch.float32,
                             device=z_vals.device)[None, :]
        tmp = sign * idx_w * seg_valid
        prev_idx = torch.argmax(tmp, dim=1, keepdim=True)  # first change
        next_idx = prev_idx + 1

        def gather(a, idx):
            return torch.gather(a, 1, idx)

        mid_inside = (0.5 * (gather(inside_sphere, prev_idx)
                             + gather(inside_sphere, next_idx)) > 0.5).float()
        mid_inside = mid_inside * (tmp.sum(dim=1, keepdim=True) > 0).float()
        grad_d = gradients.detach().reshape(R, S, 3)
        g1 = torch.gather(grad_d, 1, prev_idx[..., None].expand(R, 1, 3))[:, 0]
        g2 = torch.gather(grad_d, 1, next_idx[..., None].expand(R, 1, 3))[:, 0]
        cos_d = torch.sum(g1 * g2, dim=-1) / (
            torch.linalg.norm(g1, dim=-1) * torch.linalg.norm(g2, dim=-1)
            + 1e-8)
        mid_inside = mid_inside * (cos_d[:, None] > 0.5).float()
        sdf1, sdf2 = gather(sdf_d, prev_idx), gather(sdf_d, next_idx)
        z1, z2 = gather(mid_z, prev_idx), gather(mid_z, next_idx)
        z_sdf0 = (sdf1 * z2 - sdf2 * z1) / (sdf1 - sdf2 + 1e-10)
        sdf_depth = z_sdf0 * cam_rays_d[:, 2:3] * mid_inside

        out = {
            "color_fine": color,
            "render_depth": render_depth,
            "sdf_depth": sdf_depth,
            "normal": normal,
            "gradients": gradients.reshape(R, S, 3),
            "weights": weights,
            "inside_sphere": inside_sphere,
        }
        if not train:
            return out

        # -- training outputs ----------------------------------------------
        if view_mask is None:  # the idr head: every ray is valid
            valid_mask = torch.ones((R, 1), dtype=torch.bool,
                                    device=rays_o.device)
        else:
            # ray validity: > 8 samples seen by > 1 source view
            vm = (view_mask & (voxel_mask[:, None] > 0)).float().reshape(
                R, S, -1)
            valid_mask = (vm.sum(dim=2) > 1).float().sum(
                dim=1, keepdim=True) > 8
        relax_inside = (pts_norm < 1.2).float() * vmask_rs
        grad_sq_err = (safe_norm(gradients.reshape(R, S, 3), dim=-1)
                       - 1.0) ** 2
        smooth_sur = torch.sum(
            smooth.reshape(R, S, 3) * weights.detach()[..., None]
            * inside_sphere[..., None], dim=1)
        if sparse_pts is not None:
            sdf_random = self.sdf.sdf(sparse_pts, scene.volumes)
            sparse_sdf = torch.cat([sdf_random, sdf])
        else:
            sparse_sdf = sdf

        # patch warp at the surface root, along a detached normal
        z_sdf0 = torch.where(z_sdf0 < 0, torch.zeros_like(z_sdf0), z_sdf0)
        z_sdf0 = torch.where(z_sdf0 > z_vals.max(), torch.zeros_like(z_sdf0),
                             z_sdf0)
        pts_sdf0 = rays_o + rays_d * z_sdf0
        grad_sdf0 = self.sdf_gradient(scene.volumes, pts_sdf0)
        normal_sdf0 = grad_sdf0 / safe_norm(grad_sdf0, dim=-1, keepdim=True,
                                            eps=1e-16)
        normal_sdf0 = apply_linear(normal_sdf0, rot).detach()
        feats_src = (scene.match_features if use_match_features
                     else scene.features)
        warp = make_warp_feature_stack(feats_src, cfg.warp_scales).detach()
        if self.bf16_color_maps:
            warp = round_bf16(warp)
        ref_gray, sampled_gray = surface_patch_warp(
            pts_sdf0, normal_sdf0, warp, scene.intrs, scene.c2ws,
            patch_size=cfg.patch_size)

        with span("gens/render/tv"):
            tv_reg = tv_regularization(scene.volumes, scene.mask_volumes)

        out.update({
            "weight_sum": weights.sum(dim=-1, keepdim=True),
            "weight_max": weights.max(dim=-1, keepdim=True).values,
            "s_val": 1.0 / inv_s,
            "valid_mask": valid_mask,
            "mid_inside_sphere": mid_inside,
            "grad_sq_err": grad_sq_err,
            "relax_inside_sphere": relax_inside,
            "smooth_sur": smooth_sur,
            "sparse_sdf": sparse_sdf,
            "tv_reg": tv_reg,
            "ref_gray_val": ref_gray,
            "sampled_gray_val": sampled_gray,
        })
        return out

    # -- full render -------------------------------------------------------

    def render(self, rays_o, rays_d, near, far, scene: Scene,
               cos_anneal_ratio: float = 1.0, train: bool = False,
               use_match_features: bool = False,
               generator: Optional[torch.Generator] = None,
               perturb_noise: Optional[torch.Tensor] = None,
               sparse_pts: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """Hierarchical sampling, then :meth:`render_core` (the JAX
        ``render``). In training (``train=True``) the per-ray perturbation
        (when ``render.perturb`` > 0) and then the sparse random points are
        drawn from ``generator``, a CPU generator, unless passed in."""
        cfg = self.cfg
        R = rays_o.shape[0]
        sample_dist = 2.0 / cfg.n_samples
        if train:
            if perturb_noise is None and cfg.perturb > 0:
                perturb_noise = torch.rand((R, 1), generator=generator) - 0.5
            if sparse_pts is None:
                sparse_pts = (torch.rand((cfg.n_sparse_pts, 3),
                                         generator=generator) * 2.0 - 1.0)
            sparse_pts = sparse_pts.to(rays_o.device)
        if perturb_noise is not None:
            perturb_noise = perturb_noise.to(rays_o.device)
        with span("gens/render/sampler"):
            z_vals = hierarchical_sample(
                rays_o, rays_d, near, far, self.sdf_fn(scene.volumes),
                scene.mask(), cfg.n_samples, cfg.n_importance,
                cfg.up_sample_steps, perturb_noise=perturb_noise)
        with span("gens/render/core"):
            return self.render_core(rays_o, rays_d, z_vals, sample_dist,
                                    scene, cos_anneal_ratio, train=train,
                                    use_match_features=use_match_features,
                                    sparse_pts=sparse_pts)

    def pseudo_sdf(self, scene: Scene, pseudo_pts: torch.Tensor
                   ) -> torch.Tensor:
        """SDF at back-projected pseudo points, zero outside the voxel mask;
        (P, 1)."""
        m = lookup_mask(scene.mask(), pseudo_pts)
        sdf = self.sdf.sdf(pseudo_pts, scene.volumes)
        return torch.where(m > 0, sdf, torch.zeros_like(sdf))[:, None]
