"""Mean device milliseconds of the scene build's feature nets a view: span
``gens/build_scene/features`` ÷ the views through the trained and the
frozen copy (counters ``features.views`` + ``features.match_views``), a
step at a time over the traced window's steps (``TrainStep(...,
timing=True)``'s ``phase_ms``). A program without the counters reads
none."""

KEY = "build_scene/features"
VIEWS = ("features/views", "features/match_views")


def read(ctx):
    rows = [p[KEY] / (p[VIEWS[0]] + p[VIEWS[1]])
            for p in ctx.get("phase_ms", [])
            if KEY in p and p.get(VIEWS[0], 0) + p.get(VIEWS[1], 0) > 0]
    return sum(rows) / len(rows) if rows else None
