"""device_busy_ms (ms/request): the union of the kernels' and copies'
intervals on the device in the traced slice, a request."""


def read(ctx):
    t = ctx.trace
    return None if t is None else t["busy_s"] * 1e3 / ctx.traced_requests
