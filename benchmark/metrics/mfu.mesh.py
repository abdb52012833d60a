"""The reconstruction's share of the card's peak: the least time of a
scene's operations at the published peaks (``harness.flops.
mesh_scene_min_seconds``) ÷ the measured time a scene."""

from harness.flops import mesh_scene_min_seconds


def read(ctx):
    d = ctx.get("dims")
    if not d or not ctx.get("scene_s"):
        return None
    least = mesh_scene_min_seconds(ctx["model"], d["n_views"], d["hw"],
                                   d["resolution"])
    return 100.0 * least / ctx["scene_s"]
