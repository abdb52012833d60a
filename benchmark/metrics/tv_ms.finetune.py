"""Mean device milliseconds of the TV regulariser's forward over the
cascade (span ``gens/render/tv`` inside ``gens/render/core``) over the
traced window's finetune steps (``FinetuneStep(..., timing=True)``'s
``phase_ms``). A program without the span reads none."""

KEY = "render/tv"


def read(ctx):
    rows = [p[KEY] for p in ctx.get("phase_ms", []) if KEY in p]
    return sum(rows) / len(rows) if rows else None
