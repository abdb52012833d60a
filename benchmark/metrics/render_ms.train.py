"""Mean milliseconds of the training step's render phase over the traced
window's steps (``TrainStep(..., timing=True)``'s CUDA events)."""


def read(ctx):
    rows = [p["render"] for p in ctx.get("phase_ms", [])]
    return sum(rows) / len(rows) if rows else None
