"""Mean seconds of the host isosurface (``grid_to_mesh``) over the traced window's scenes (host clock,
the device synchronized at both ends)."""


def read(ctx):
    rows = [s["isosurface_s"] for s in ctx.get("scenes", [])]
    return sum(rows) / len(rows) * 1.0 if rows else None
