"""The finetune step's share of the card's peak: the least time of its
render forward and backward at the published peaks of the precisions they
run in (``harness.flops_finetune.finetune_step_min_seconds``; no scene
build) ÷ the measured step time."""

from harness.flops_finetune import finetune_step_min_seconds


def read(ctx):
    d = ctx.get("dims")
    if not d or not ctx.get("step_s"):
        return None
    least = finetune_step_min_seconds(ctx["model"], d["n_views"],
                                      d["n_rays"], d["n_sparse"],
                                      d["n_pseudo"])
    return 100.0 * least / ctx["step_s"]
