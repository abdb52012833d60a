"""K3's share of its roofline in a reconstruction: the least time of the
profiled scene's fused SDF MLP launches (``sdf_mlp_tc_kernel`` in the
trace, one per block³ grid chunk) ÷ their device time.

A launch over n rows reads the encoded point and volume features and
writes the output once, reads the weights once, and makes three TF32
products (3xTF32) for every multiply-add of the MLP."""

from harness.flops import HBM_BYTES_PER_S, PEAK, sdf_widths

KERNEL = "sdf_mlp_tc_kernel"


def launch_seconds(cfg, n: int) -> float:
    d_in, d_feat, layers = sdf_widths(cfg)
    ops = n * sum(2 * i * o for i, o in layers)
    n_bytes = 4 * n * (d_in + d_feat + cfg["d_out"]) \
        + 4 * sum(i * o + o for i, o in layers)
    return max(n_bytes / HBM_BYTES_PER_S, 3 * ops / PEAK["tf32"])


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    seconds, launches = tr.kernel_seconds(KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    least = launches * launch_seconds(ctx["model"]["sdf_network"],
                                      ctx["block"] ** 3)
    return 100.0 * least / seconds
