"""Mean seconds of the SDF grid (``eval_sdf_grid``, ending in its host copy) over the traced window's scenes (host clock,
the device synchronized at both ends)."""


def read(ctx):
    rows = [s["mesh_grid_s"] for s in ctx.get("scenes", [])]
    return sum(rows) / len(rows) * 1.0 if rows else None
