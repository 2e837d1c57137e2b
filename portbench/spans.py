"""Per-request numbers from the program's own spans
(`slam_tpu_torch.utils.profiling`): what they recorded while the traced
slice's profiler session recorded, over the request roots recorded (so a
slice taken again after a lost bracket counts its own requests too).

A program without spans and a run that recorded no root (an untraced
run) give None; a device number is None too where no span timed the
device (the CPU)."""

from __future__ import annotations


def recorded():
    """The program's `profiling.recorded()`, or None."""
    from slam_tpu_torch.utils import profiling

    fn = getattr(profiling, "recorded", None)
    if fn is None:
        return None
    r = fn()
    return r if r["roots"] else None


def host_ms(name: str, minus=()):
    """Host ms a request inside span `name`, less the spans `minus`."""
    r = recorded()
    if r is None or name not in r["host_ms"]:
        return None
    return (r["host_ms"][name] - sum(r["host_ms"].get(m, 0.0) for m in minus)) / r["roots"]


def device_ms(name: str):
    """Device ms a request inside span `name`."""
    r = recorded()
    if r is None or name not in r["device_ms"]:
        return None
    return r["device_ms"][name] / r["roots"]
