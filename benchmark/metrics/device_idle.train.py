"""The device's idle share of a window step: 100 × (1 − the device's busy
seconds a step ÷ the window's mean step time). The busy seconds are the
union of kernel, copy and fill intervals over the profiled slice that
records the device's activity alone, divided by its steps; the step
time is the traced run's own window's, which no profiler slows."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.busy_s <= 0 or not ctx.get("step_s"):
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.units / ctx["step_s"])
