"""rbpf_map_write_device_ms (ms/request): device time inside the
program's `rbpf.map_write` spans, every chunk's write of the new codes
into the copy of the maps (`planners/_scatter.py:last_lanes`' table of
the last writing lane a cell, then the scatter), timed by the stamps of
the step's graph, a request."""

from portbench import spans


def read(ctx):
    return spans.device_ms("rbpf.map_write")
