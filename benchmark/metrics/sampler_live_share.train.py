"""Mean share, in %, of the points whose SDF the hierarchical sampler
evaluates that lie inside the voxel mask (counters ``sampler.sdf_live`` ÷
``sampler.sdf_points``): the rest is computed and thrown away. Over the
traced window's steps (``TrainStep(..., timing=True)``'s ``phase_ms``)."""

KEY = "render/sampler/live_share"


def read(ctx):
    rows = [p[KEY] for p in ctx.get("phase_ms", []) if KEY in p]
    return sum(rows) / len(rows) if rows else None
