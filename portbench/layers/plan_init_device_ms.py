"""plan_init_device_ms (ms/request): device time inside the program's
`hastar.init` span (`planners/hastar.py:HybridAStar._solve`: start and
goal indexing, the coarse geodesic wavefront's chain, the query's state),
timed by two CUDA events around it, gaps included, a query."""

from portbench import plan_spans


def read(ctx):
    return plan_spans.per_query("device_ms", "hastar.init")
