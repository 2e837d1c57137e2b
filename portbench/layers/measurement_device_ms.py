"""measurement_device_ms (ms/request): device time inside the program's
`measurement` span, the weights (`models/mcl.py:update`'s `_weigh`: the
boxed LF table in SLAM), timed by the event nodes of the step's graph, a
request."""

from portbench import spans


def read(ctx):
    return spans.device_ms("measurement")
