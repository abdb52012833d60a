"""The JAX package's training gradient under ``sdf_network.packed_trilerp:
true``, reproduced in the port for diagnostics. Nothing in ``gens_torch``
changes: the port computes the plain trilerp's gradient under every value
of the key, and this module, which imports torch alone, swaps the lookup of
the port's training render core while it is installed:

    from _reference_packed_grad import reference_packed_grad
    with reference_packed_grad():
        step(batch, ...)  # the reference's gradient in every render core

What it reproduces (ROADMAP §C; ``tests/_packed_site_map.py`` measures it
site by site in the JAX package). The JAX render core evaluates the SDF
inside ``jax.jvp`` of ``jax.vjp`` w.r.t. the points
(gens_tpu/models/renderer.py:202-220, 278-279), and the training step
differentiates that w.r.t. the volumes. Through the packed-diff chain
(gens_tpu/ops/interp.py:786-833) the trilerp's value and its point
gradient reach that outer level with no volume in them: the custom JVP
rules compute them from the stop-gradient table. Only the point Hessian,
a tangent of the custom ``_pd_hess``, carries the volume gradient. So the
render core's SDF value, latent and ∇SDF pass the volumes nothing, and its
Hessian·1 passes them only what flows through the trilerp's own Hessian.
The lookups nested one level deep (the sparse random points, the pseudo
points, the 2D bilinear chains) keep the plain gradient, and the
installed lookup leaves them alone.

``detach_form_trilerp`` builds that lookup: the trilerp of the detached
volume, plus ``dpx·dpy·Hxy + dpx·dpz·Hxz + dpy·dpz·Hyz`` where dp is the
points minus their detached copy (zero, with zero point gradient) and H
are the trilerp's mixed point derivatives taken from the volume minus its
detached copy (zero, with the volume's gradient).
"""

import contextlib

import torch

from gens_torch.models.embedder import positional_encoding
from gens_torch.models.renderer import Renderer
from gens_torch.models.sdf_net import SDFNetwork
from gens_torch.ops.interp import lookup_volume_cascade, trilerp

CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
PAIRS = ((0, 1), (0, 2), (1, 2))


def trilerp_mixed_partials(volume: torch.Tensor, pts: torch.Tensor
                           ) -> torch.Tensor:
    """The trilerp's mixed second point derivatives (xy, xz, yz) at ``pts``
    in normalized coordinates, ``(N, C, 3)``, zeros-padded as
    ``gens_torch.ops.interp.trilerp`` and f32: the JAX
    ``trilerp_spatial_hess`` off its zero diagonal. Linear in ``volume``;
    ``pts`` are taken as constants."""
    X, Y, Z, C = volume.shape
    size = torch.tensor([X, Y, Z], device=pts.device)
    p = pts.detach().float()
    u = (p + 1.0) * 0.5 * (size - 1).float()
    u0 = torch.floor(u)
    w1 = u - u0
    scale = 0.5 * (size - 1).float()
    offs = torch.tensor(CORNERS, device=pts.device)  # (8, 3)
    ijk = u0.long()[:, None, :] + offs[None]  # (N, 8, 3)
    valid = ((ijk >= 0) & (ijk < size)).all(dim=-1)
    ijk = torch.minimum(ijk.clamp(min=0), size - 1)
    idx = (ijk[..., 0] * Y + ijk[..., 1]) * Z + ijk[..., 2]
    vals = volume.reshape(X * Y * Z, C)[idx.reshape(-1)].reshape(
        idx.shape + (C,)).float() * valid[..., None]  # (N, 8, C)
    on = offs[None].bool()
    lerp = torch.where(on, w1[:, None, :], 1.0 - w1[:, None, :])
    deriv = torch.where(on, scale, -scale).expand_as(lerp)
    ws = []
    for a, b in PAIRS:
        (c,) = {0, 1, 2} - {a, b}
        ws.append(deriv[..., a] * deriv[..., b] * lerp[..., c])
    return torch.einsum("nkc,nkj->ncj", vals, torch.stack(ws, dim=-1))


def hessian_term(volume: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Zero, with zero value and point gradient w.r.t. the volume, whose
    second point derivative is the trilerp's Hessian of the volume's
    tangent: the only part of the packed-diff lookup's derivatives that
    reaches the volumes in the render core. ``(N, C)``."""
    h = trilerp_mixed_partials(volume, pts)
    h = h - h.detach()
    dp = pts - pts.detach()
    return sum(dp[:, a, None] * dp[:, b, None] * h[..., k]
               for k, (a, b) in enumerate(PAIRS))


def detach_form_trilerp(volume: torch.Tensor, pts: torch.Tensor
                        ) -> torch.Tensor:
    """The packed-diff trilerp's value and derivatives as the render core's
    nesting sees them, for one volume (f32, ``(N, C)``)."""
    return trilerp(volume.detach(), pts).float() + hessian_term(volume, pts)


def _reference_encode(self, pts, volumes):
    """``SDFNetwork.encode`` with the render core's reference lookup: the
    value from the detached cascade (rounded to bf16 under
    ``sdf_network.volume_dtype``, as the port rounds it), the Hessian term
    from the cascade as given (the JAX tangent is the raw volume's)."""
    c = self.cfg
    vals = [v.detach() for v in volumes]
    if c.volume_dtype == "bfloat16":
        vals = [v.to(torch.bfloat16) for v in vals]
    feats = lookup_volume_cascade(vals, pts).float()
    feats = feats + torch.cat([hessian_term(v, pts) for v in volumes],
                              dim=-1)
    return (positional_encoding(pts * c.scale, c.multires),
            positional_encoding(feats, c.feat_multires))


@contextlib.contextmanager
def reference_packed_grad():
    """While installed, every ``Renderer.sdf_value_grad_smooth`` (the
    training render core of train, finetune and the quality phases) reads
    the cascade through the reference's lookup; every other SDF call keeps
    the plain one."""
    plain_core = Renderer.sdf_value_grad_smooth
    plain_encode = SDFNetwork.encode

    def core(self, volumes, pts):
        SDFNetwork.encode = _reference_encode
        try:
            return plain_core(self, volumes, pts)
        finally:
            SDFNetwork.encode = plain_encode

    Renderer.sdf_value_grad_smooth = core
    try:
        yield
    finally:
        Renderer.sdf_value_grad_smooth = plain_core
