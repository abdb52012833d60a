"""The numbers that decide ``correct``: the program's outputs held against
the plain reference's, each reduced to one number whose limit is in
``limits/<workload>.json``."""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

# a leaf whose first reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam: left out of the change
STILL_LEAF = 1e-3


def _norms(tensors: Dict[str, torch.Tensor], names: List[str]) -> np.ndarray:
    return np.array([float(torch.linalg.norm(tensors[n].double()))
                     for n in names])


def _gaps(prog: np.ndarray, ref: np.ndarray, names: List[str], what: str
          ) -> np.ndarray:
    """Each leaf's gap of norms, against the larger of its reference norm
    and the median leaf's; the worst leaf printed."""
    scale = np.maximum(ref, np.median(ref))
    gap = np.abs(prog - ref) / np.where(scale > 0, scale, 1.0)
    i = int(np.argmax(gap))
    print(f"{what}: worst leaf {names[i]} program {prog[i]!r} reference "
          f"{ref[i]!r} gap {gap[i]!r}; median leaf gap "
          f"{float(np.median(gap))!r} (median leaf norm "
          f"{np.median(ref)!r})", file=sys.stderr)
    return gap


def ray_weight_gap(prog: Dict, ref: Dict) -> float:
    """The relative L2 gap of each ray's weight in the loss, |∂loss/∂colour|
    summed over the channels: rays that one side did not render, or whose
    colour got no gradient, weigh 0 there."""
    def weights(rays):
        g = rays.get("grad")
        return (torch.zeros(0, dtype=torch.float64) if g is None
                else g.double().abs().sum(-1))

    wp, wr = weights(prog), weights(ref)
    n = max(len(wp), len(wr))
    wp = torch.nn.functional.pad(wp, (0, n - len(wp)))
    wr = torch.nn.functional.pad(wr, (0, n - len(wr)))
    gap = float(torch.linalg.norm(wp - wr) / torch.linalg.norm(wr))
    print(f"ray weights: program {len(prog.get('colour', []))} rays, "
          f"reference {len(ref['colour'])}; gap {gap!r}", file=sys.stderr)
    return gap


def _loss_gaps(prog: Dict, ref: Dict, what: str):
    lp, lr = np.array(prog["losses"]), np.array(ref["losses"])
    gaps = np.abs(lp - lr) / np.abs(lr)
    print(f"{what} losses: program {lp.tolist()} reference {lr.tolist()} "
          f"gaps {gaps.tolist()}", file=sys.stderr)
    terms = {k: abs(prog["terms1"][k] - v) / abs(v)
             for k, v in ref["terms1"].items() if v != 0}
    print(f"{what} terms: program {prog['terms1']} reference "
          f"{ref['terms1']} gaps {terms}", file=sys.stderr)
    return gaps, terms


def _change_gaps(prog_after, ref: Dict, before, what: str) -> np.ndarray:
    """Each leaf's gap of the norms of its change from ``before``, leaves
    whose reference gradient in the first step is under ``STILL_LEAF`` of
    the median leaf's left out."""
    names = sorted(ref["first_grad"])
    g_ref = _norms(ref["first_grad"], names)
    moving = [n for n, g in zip(names, g_ref)
              if g >= STILL_LEAF * np.median(g_ref)]
    d_ref = _norms({n: ref["after"][n] - before[n] for n in moving}, moving)
    d_prog = _norms({n: prog_after[n] - before[n] for n in moving}, moving)
    return _gaps(d_prog, d_ref, moving, what)


def train_numbers(prog: Dict, ref: Dict, init: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` of the first steps, ``terms1`` (the
    first step's loss terms), ``rays1`` (its per-ray colour and colour
    gradient), ``first_grad`` by leaf, ``after`` (parameters after the
    steps). Returns ``loss1`` (the first step's relative loss gap),
    ``loss`` (the worst step's), ``colour1`` (the first step's colour
    term's), ``ray_weight1`` (``ray_weight_gap``), ``grad`` and
    ``grad_median`` (the worst and the median leaf's gap of first gradient
    norms), ``change`` and ``change_median`` (the same of the change over
    the steps)."""
    gaps, terms = _loss_gaps(prog, ref, "first steps'")
    names = sorted(ref["first_grad"])
    g_ref = _norms(ref["first_grad"], names)
    g_prog = _norms({n: prog["first_grad"].get(
        n, torch.zeros_like(ref["first_grad"][n])) for n in names}, names)
    grad = _gaps(g_prog, g_ref, names, "first gradient")
    change = _change_gaps(prog["after"], ref, init, "change")
    return {"loss1": float(gaps[0]), "loss": float(gaps.max()),
            "colour1": terms["color_loss"],
            "ray_weight1": ray_weight_gap(prog["rays1"], ref["rays1"]),
            "grad": float(grad.max()), "grad_median": float(np.median(grad)),
            "change": float(change.max()),
            "change_median": float(np.median(change))}


def last_step_numbers(prog: Dict, ref: Dict, before: Dict[str, torch.Tensor]
                      ) -> Dict[str, float]:
    """One step from a given state (the window's last), as
    ``train_numbers`` reads the first: ``loss_last``, ``colour_last``,
    ``ray_weight_last`` and ``change_last`` (the median leaf's gap of the
    step's change)."""
    gaps, terms = _loss_gaps(prog, ref, "last step's")
    change = _change_gaps(prog["after"], ref, before, "last step's change")
    return {"loss_last": float(gaps[0]), "colour_last": terms["color_loss"],
            "ray_weight_last": ray_weight_gap(prog["rays1"], ref["rays1"]),
            "change_last": float(np.median(change))}


def grid_points(indices: np.ndarray, resolution: int, bound_min,
                bound_max) -> np.ndarray:
    """World points of flat grid indices, on the axes ``eval_sdf_grid``
    takes (``np.linspace`` in float32)."""
    axes = [np.linspace(bound_min[i], bound_max[i], resolution,
                        dtype=np.float32) for i in range(3)]
    i, j, k = np.unravel_index(indices, (resolution,) * 3)
    return np.stack([axes[0][i], axes[1][j], axes[2][k]], axis=-1)


def volume_gap(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    """The worst cascade level's relative L2 gap."""
    return max(float(torch.linalg.norm((p.float() - r.float()).reshape(-1))
                     / torch.linalg.norm(r.float().reshape(-1)))
               for p, r in zip(prog, ref))


def mesh_numbers(scenes: List[Dict]) -> Dict[str, float]:
    """Per scene: ``volume`` (volume_gap), ``grid`` (the largest SDF gap
    at the sampled grid points), ``mesh_count`` (|Δ triangles| + |Δ
    vertices| against the reference isosurface of the program's grid) and
    ``mesh_area`` (the relative gap of the area); the worst scene's."""
    out = {"volume": 0.0, "grid": 0.0, "mesh_count": 0.0, "mesh_area": 0.0}
    for s in scenes:
        got = {"volume": s["volume"], "grid": s["grid"],
               "mesh_count": float(abs(s["prog_mesh"]["n_tris"]
                                       - s["ref_mesh"]["n_tris"])
                                   + abs(s["prog_mesh"]["n_verts"]
                                         - s["ref_mesh"]["n_verts"])),
               "mesh_area": abs(s["prog_mesh"]["area"] - s["ref_mesh"]["area"])
               / max(s["ref_mesh"]["area"], 1e-30)}
        print(f"scene {s['index']}: {got}; program mesh {s['prog_mesh']}, "
              f"reference {s['ref_mesh']}", file=sys.stderr)
        out = {k: max(out[k], got[k]) for k in out}
    return out
