"""Mean host milliseconds spent inside the SDF grid's lookup and MLP
spans (``gens/sdf/lookup``, ``gens/sdf/mlp``) under each
``gens/mesh/grid`` root of the program's span log: the traced run's
profiled scenes. Close to ``grid_lookup_ms`` + ``grid_mlp_ms``, the host's
launches pace the grid."""

from harness.spans import grid_roots, mean


def read(ctx):
    return mean(grid_roots(ctx), "enqueue_ms")
