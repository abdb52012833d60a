"""K1's share of its roofline in the training step: the least time of the
profiled slice's splats (``splat_kernel`` in the trace, the aggregation's
backward: one per view and cascade scale) ÷ their device time.

A splat of n = dim³ voxel queries, ``live`` of them inside the view, into
an (H, W, C) f32 map reads each input byte once (the cotangent of every
query, the coordinates of the live ones) and writes the map once, and
makes 3 f32 operations per channel and corner of a live query. The live
queries are counted from the scene's cameras with the reference's voxel
projection."""

import sys

import torch

from harness.flops import HBM_BYTES_PER_S, PEAK
from reference.gens_plain import project_voxels, scale_intrinsics, voxel_grid

KERNEL = "splat_kernel"


def launch_seconds(C: int, n: int, live: int, H: int, W: int) -> float:
    n_bytes = 4 * C * n + 8 * live + 4 * C * H * W
    ops = 4 * 3 * C * live
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK["float32"])


def least_seconds(scene, model, hw, device) -> float:
    dims = model["volume"]["volume_dims"]
    chans = model["feature_network"]["d_out"]
    intrs = torch.from_numpy(scene["intrs"]).to(device)
    c2ws = torch.from_numpy(scene["c2ws"]).to(device)
    total = 0.0
    for i, dim in enumerate(dims):
        H, W = hw[0] >> i, hw[1] >> i
        pts = voxel_grid(dim, device)
        k = scale_intrinsics(intrs, i)
        for v in range(len(c2ws)):
            live = int(project_voxels(pts, k[v], c2ws[v], (H, W))[1].sum())
            total += launch_seconds(chans[i], dim ** 3, live, H, W)
    return total


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    seconds, launches = tr.kernel_seconds(KERNEL)
    traced = ctx["traced_scenes"]
    model = ctx["model"]
    expected = len(traced) * ctx["dims"]["n_views"] * len(
        model["volume"]["volume_dims"])
    if launches == 0 or seconds <= 0:
        return None
    if launches != expected:
        print(f"k1_roofline: {launches} splats in the slice, {expected} "
              "expected: not read", file=sys.stderr)
        return None
    least = sum(least_seconds(s, model, ctx["dims"]["hw"], ctx["device"])
                for s in traced)
    return 100.0 * least / seconds
