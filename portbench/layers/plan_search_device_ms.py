"""plan_search_device_ms (ms/request): device time inside the program's
`hastar.search` span, the lattice search chain, stamped in its graph
around the WHILE node (outside its body) at each replay, a query; the
host's flag reads between replays are not in it."""

from portbench import plan_spans


def read(ctx):
    return plan_spans.per_query("device_ms", "hastar.search")
