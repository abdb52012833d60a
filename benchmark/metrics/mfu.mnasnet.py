"""The step's share of the card's peak with the MnasNet-1.0 FPN backbone:
the least time of a training step's operations at the published peaks of
the precisions they run in, the feature nets' counted for MnasNet
(``harness.flops_mnasnet.train_step_min_seconds``) ÷ the measured step
time."""

from harness.flops_mnasnet import train_step_min_seconds


def read(ctx):
    d = ctx.get("dims")
    if not d or not ctx.get("step_s"):
        return None
    least = train_step_min_seconds(ctx["model"], d["n_views"], d["hw"],
                                   d["n_rays"], d["n_sparse"], d["n_pseudo"])
    return 100.0 * least / ctx["step_s"]
