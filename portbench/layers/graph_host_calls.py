"""graph_host_calls (calls/request): the CUDA runtime calls the host made
a request in the traced slice (kernel and graph launches, copies and
fills, and the waits for the pose read): the step graphs' host side and
the harness's pose read."""


def read(ctx):
    t = ctx.trace
    return None if t is None else t["host_calls"] / ctx.traced_requests
