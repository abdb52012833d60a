"""Mean device milliseconds of the scene build's feature nets (span
``gens/build_scene/features``: both ``extract_features`` calls) over the
traced window's steps (``TrainStep(..., timing=True)``'s ``phase_ms``)."""

KEY = "build_scene/features"


def read(ctx):
    rows = [p[KEY] for p in ctx.get("phase_ms", []) if KEY in p]
    return sum(rows) / len(rows) if rows else None
