"""Mean device milliseconds of the render core (span ``gens/render/core``:
``render_core``, the SDF, colour blending and the sparse points) over
the traced window's steps (``TrainStep(..., timing=True)``'s ``phase_ms``)."""

KEY = "render/core"


def read(ctx):
    rows = [p[KEY] for p in ctx.get("phase_ms", []) if KEY in p]
    return sum(rows) / len(rows) if rows else None
