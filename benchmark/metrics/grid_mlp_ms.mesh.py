"""Mean device milliseconds of the SDF grid's fused MLP (span
``gens/sdf/mlp``: K3, one launch per block³ chunk) under each
``gens/mesh/grid`` root of the program's span log: the traced run's
profiled scenes, whose profiler turns the program's spans on."""

from harness.spans import grid_roots, mean


def read(ctx):
    return mean(grid_roots(ctx), "mlp_ms")
