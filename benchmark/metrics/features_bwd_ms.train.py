"""Mean device milliseconds of the trained feature net's backward (span
``gens/backward/features`` under ``gens/step/backward``: from the first
gradient at the net's outputs to its first layer's weight gradient) over
the traced window's steps (``TrainStep(..., timing=True)``'s
``phase_ms``). A program without the span reads none."""

KEY = "backward/features"


def read(ctx):
    rows = [p[KEY] for p in ctx.get("phase_ms", []) if KEY in p]
    return sum(rows) / len(rows) if rows else None
