"""rbpf_map_copy_device_ms (ms/request): device time inside the program's
`rbpf.map_copy` span, the gather of the resampled particles' maps into
the step's state buffer (`models/rbpf.py:update`), timed by the stamps of
the step's graph, a request."""

from portbench import spans


def read(ctx):
    return spans.device_ms("rbpf.map_copy")
