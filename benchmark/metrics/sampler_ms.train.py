"""Mean device milliseconds of the hierarchical sampler (span
``gens/render/sampler``: ``hierarchical_sample``) over the traced window's
steps (``TrainStep(..., timing=True)``'s ``phase_ms``)."""

KEY = "render/sampler"


def read(ctx):
    rows = [p[KEY] for p in ctx.get("phase_ms", []) if KEY in p]
    return sum(rows) / len(rows) if rows else None
