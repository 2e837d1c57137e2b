"""graph_host_ms (ms/request): the step graphs' host side, from the
program's spans: `graph.run` (`StepGraphs.run`: prepare, load, the
graph's launch, output) less `graph.wait` (the pinned ring's wait for the
card), a request."""

from portbench import spans


def read(ctx):
    return spans.host_ms("graph.run", minus=("graph.wait",))
