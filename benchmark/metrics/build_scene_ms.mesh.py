"""Mean milliseconds of the scene build (``GenSModel.build_scene``) over the traced window's scenes (host clock,
the device synchronized at both ends)."""


def read(ctx):
    rows = [s["build_scene_s"] for s in ctx.get("scenes", [])]
    return sum(rows) / len(rows) * 1e3 if rows else None
