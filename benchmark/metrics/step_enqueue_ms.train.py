"""Mean host milliseconds from a training step's entry to the end of its
last phase, before the step waits for the device, over the traced
window's steps (``TrainStep(..., timing=True)``'s ``phase_ms``). Close to
``train_step_ms``, the host paces the step."""

KEY = "enqueue"


def read(ctx):
    rows = [p[KEY] for p in ctx.get("phase_ms", []) if KEY in p]
    return sum(rows) / len(rows) if rows else None
