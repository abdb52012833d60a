"""Mean device milliseconds of the SDF grid's cascade lookup and
positional encoding (span ``gens/sdf/lookup``, one per block³ chunk) under
each ``gens/mesh/grid`` root of the program's span log: the traced run's
profiled scenes, whose profiler turns the program's spans on. Each
scene's numbers go to standard error."""

from harness.spans import grid_roots, mean, print_roots


def read(ctx):
    rows = grid_roots(ctx)
    print_roots(rows)
    return mean(rows, "lookup_ms")
