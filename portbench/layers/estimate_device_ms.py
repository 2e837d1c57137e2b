"""estimate_device_ms (ms/request): device time inside the program's
`estimate` span, the estimate (`models/mcl.py:_finish`: best and mode
poses), timed by the event nodes of the step's graph, a request."""

from portbench import spans


def read(ctx):
    return spans.device_ms("estimate")
