"""A cell at a size the CPU runs in seconds: the configuration's widths
cut as the repository's CPU tests cut them, 64×64 images, 64 rays, a 32³
grid, with seeded weights; ``f32`` turns every bfloat16 place of the
configuration to float32, where the program and the reference agree to
rounding on the CPU."""

import math
from typing import Dict

import torch

from control import f32_cell
from harness import core

torch.set_num_threads(2)


def tiny_cell(name: str, f32: bool = False) -> core.Cell:
    cell = core.Cell(name)
    c = cell.config["config"]
    m = c["model"]
    m["feature_network"]["d_enc"] = [8, 8, 8, 8, 8]
    m["volume"]["volume_dims"] = [32, 16, 8, 4, 2]
    m["sdf_network"].update(d_hidden=48, n_layers=4, skip_in=[2], d_out=17)
    m["render"].update(n_samples=16, n_importance=16, up_sample_steps=2,
                       patch_size=5, n_sparse_pts=64)
    for ds in ("train_dataset", "val_dataset"):
        c[ds].update(img_hw=[64, 64], n_rays=64, n_pseudo_pts=32)
    c["mesh_resolution"] = 32
    cell.traffic.update(pool=4, block=16, grid_sample=4096)
    return f32_cell(cell) if f32 else cell


def tiny_weights(cell: core.Cell, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded weights for the names and shapes of the cell's reference
    model: one normal draw cut into the leaves and scaled by fan-in, zero
    biases, the anti-alias ``s`` at 0.2, the variance at 0.3; the SDF
    network's NeuS geometric initialization (a sphere of radius ``bias``)
    with the columns that read the volume features at a tenth of their
    layer's scale instead of zero, so that the colours vary and the
    volumes get a gradient; ``match_feature`` equals ``feature``."""
    ref_model = cell.reference.GenSPlain(cell.config["config"]["model"])
    shapes = {n: tuple(p.shape) for n, p in ref_model.named_parameters()
              if not n.startswith("match_feature.")}
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator().manual_seed(seed)
    flat = torch.randn(total, generator=gen)
    state, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        state[name] = flat[off:off + n].view(shape)
        off += n
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] == "feature":
            fan_in = (t.shape[1] if name.endswith("conv.weight")
                      or parts[1] == "heads" else t.shape[0]) * 9
            t.mul_(1.0 / math.sqrt(fan_in))
        elif parts[0] == "reg":
            if parts[-1] == "bias":
                t.zero_()
            else:
                t.mul_(1.0 / math.sqrt(27 * t.shape[1]))
        elif parts[0] == "blending":
            if parts[-1] == "s":
                t.fill_(0.2)
            elif parts[-1] == "bias":
                t.zero_()
            else:
                t.mul_(math.sqrt(2.0 / t.shape[1]))
        elif name == "variance.variance":
            t.fill_(0.3)
    _sdf_geometric(state, ref_model.sdf)
    state.update({"match_" + n: t.clone() for n, t in state.items()
                  if n.startswith("feature.")})
    return state


@torch.no_grad()
def _sdf_geometric(state: Dict[str, torch.Tensor], sdf) -> None:
    c, dims = sdf.cfg, sdf.dims
    d_feat = c["feat_channels"] * (1 + 2 * c["feat_multires"])
    last = len(dims) - 2
    for l in range(sdf.n_lin):
        v, b = state[f"sdf.lin{l}.v"], state[f"sdf.lin{l}.b"]
        d_in, d_out = v.shape
        std = math.sqrt(2) / math.sqrt(d_out)
        b.zero_()
        noise = v.clone()
        if l == last:
            v.mul_(1e-4).add_(math.sqrt(math.pi) / math.sqrt(d_in))
            b.fill_(-c["bias"])
            b[-d_feat:] = 0.0
        elif l == 0:
            v.mul_(std)
            v[3:, :] = 0.0
        elif l in c["skip_in"]:
            v.mul_(std)
            v[-(dims[0] - 3 + d_feat):-d_feat, :] = 0.0
        else:
            v.mul_(std)
        if l > 0:
            v[-d_feat:, :] = noise[-d_feat:, :] * (0.1 * std)
        state[f"sdf.lin{l}.g"].copy_(torch.linalg.norm(v, dim=0))
