"""mapping_device_ms (ms/request): device time inside the program's
`mapping` span, the log-odds map update (`models/slam.py:step`), timed
by the event nodes of the step's graph, a request."""

from portbench import spans


def read(ctx):
    return spans.device_ms("mapping")
