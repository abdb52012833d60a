"""Mean device milliseconds of the 3D U-Net over the raw cascade (span
``gens/build_scene/reg``) over the traced window's steps
(``TrainStep(..., timing=True)``'s ``phase_ms``)."""

KEY = "build_scene/reg"


def read(ctx):
    rows = [p[KEY] for p in ctx.get("phase_ms", []) if KEY in p]
    return sum(rows) / len(rows) if rows else None
