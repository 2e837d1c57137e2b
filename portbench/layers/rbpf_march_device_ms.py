"""rbpf_march_device_ms (ms/request): device time inside the program's
`rbpf.march` spans, every chunk of the per-particle-map march
(`ops/mapping.py:_fidelity_chunk`: each particle's beams through its own
map, the predicted hits and the new codes), timed by the stamps of the
step's graph, a request."""

from portbench import spans


def read(ctx):
    return spans.device_ms("rbpf.march")
