"""plan_path_host_ms (ms/request): host time inside the program's
`hastar.path` span (`HybridAStar.recover_path`: the parent-chain walk on
the device in eager chunks and its reads to the host), a query."""

from portbench import plan_spans


def read(ctx):
    return plan_spans.per_query("host_ms", "hastar.path")
