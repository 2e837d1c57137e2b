"""resample_device_ms (ms/request): device time inside the program's
`resample` span, the gated resampler (`models/mcl.py:_finish`: ESS,
draws and the resampler under its `cond`; nothing on a request the
every-k gate skips), timed by the event nodes of the step's graph, a
request."""

from portbench import spans


def read(ctx):
    return spans.device_ms("resample")
