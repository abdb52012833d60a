"""The finetune's Adam against the card's memory bandwidth, in %: the
least time of its update (28 bytes per float32 element over the five
volumes' elements and the ``mlp`` group's, which the loop counts from the
trained tensors, ``harness.flops_finetune.adam_min_seconds``) ÷ the
optimizer phase's device time (span ``gens/step/optimizer``), over the
traced window's steps."""

from harness.flops_finetune import adam_min_seconds


def read(ctx):
    rows = [p["optimizer"] for p in ctx.get("phase_ms", [])
            if "optimizer" in p]
    if not rows or not ctx.get("volume_params") or not ctx.get("mlp_params"):
        return None
    least = len(rows) * adam_min_seconds(ctx["volume_params"]
                                         + ctx["mlp_params"])
    measured = sum(rows) * 1e-3
    return 100.0 * least / measured if measured > 0 else None
