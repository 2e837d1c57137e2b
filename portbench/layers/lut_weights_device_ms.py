"""lut_weights_device_ms (ms/request): device time inside the program's
`lut_weights` span, the fused predict -> LUT-weigh launch with its seed
(`models/mcl.py:step`), timed by the event nodes of the step's graph, a
request."""

from portbench import spans


def read(ctx):
    return spans.device_ms("lut_weights")
