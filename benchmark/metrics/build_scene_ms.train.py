"""Mean milliseconds of the training step's build_scene phase over the traced
window's steps (``TrainStep(..., timing=True)``'s CUDA events)."""


def read(ctx):
    rows = [p["build_scene"] for p in ctx.get("phase_ms", [])]
    return sum(rows) / len(rows) if rows else None
