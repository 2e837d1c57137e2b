"""edt_device_ms (ms/request): device time inside the program's `edt` span,
the capped EDT of the frozen grid (`models/slam.py:step`), timed by the
event nodes of the step's graph, a request."""

from portbench import spans


def read(ctx):
    return spans.device_ms("edt")
