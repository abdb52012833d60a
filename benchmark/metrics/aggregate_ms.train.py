"""Mean device milliseconds of the volume aggregation (span
``gens/build_scene/aggregate``: the projection and bilinear gathers of
``agg_mean_var``, or the adaptive aggregation) over the traced window's
steps (``TrainStep(..., timing=True)``'s ``phase_ms``)."""

KEY = "build_scene/aggregate"


def read(ctx):
    rows = [p[KEY] for p in ctx.get("phase_ms", []) if KEY in p]
    return sum(rows) / len(rows) if rows else None
