"""Mean device milliseconds of the feature nets' encoders (span
``gens/features/encoder``: the trained and the frozen copy's, summed)
over the traced window's steps (``TrainStep(..., timing=True)``'s
``phase_ms``). The rest of ``features_ms.train`` is the decoders and
heads. A program without the span reads none."""

KEY = "features/encoder"


def read(ctx):
    rows = [p[KEY] for p in ctx.get("phase_ms", []) if KEY in p]
    return sum(rows) / len(rows) if rows else None
