"""Per-query numbers of a plan cell from the program's own spans and
counters (`slam_tpu_torch.utils.profiling`): what they recorded while the
traced slice's session recorded, over the queries recorded (the roots
`HybridAStar.solve`; a query opens a second root, `recover_path`'s).

A program without the planner's spans or per-root counts, and a run that
recorded no query, give None; a device number is None too where no span
timed the device (the CPU)."""

from __future__ import annotations

ROOT = "HybridAStar.solve"


def recorded():
    """(the program's `profiling.recorded()`, the queries it recorded), or
    None."""
    from slam_tpu_torch.utils import profiling

    fn = getattr(profiling, "recorded", None)
    r = fn() if fn is not None else None
    n = (r or {}).get("root_names", {}).get(ROOT, 0)
    return (r, n) if n else None


def per_query(kind: str, name: str):
    """`kind` ("host_ms", "device_ms" or "counts") of `name`, a query."""
    got = recorded()
    if got is None or name not in got[0].get(kind, {}):
        return None
    return got[0][kind][name] / got[1]
