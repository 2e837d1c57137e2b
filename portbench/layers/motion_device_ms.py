"""motion_device_ms (ms/request): device time inside the program's `motion`
span, K1, the motion sampler (`models/mcl.py:predict`), timed by the
event nodes of the step's graph, a request."""

from portbench import spans


def read(ctx):
    return spans.device_ms("motion")
