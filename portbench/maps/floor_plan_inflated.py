"""The floor plan a planner searches: the frozen stand-in
(`maps/floor_plan.py`) with its free space eroded by the vehicle's disc,
in plain numpy, so the inflation is part of the data that the program and
the reference both receive. A configuration names it as its map builder
(`"plan": {"builder": "floor_plan_inflated", ...}`)."""

from __future__ import annotations

import numpy as np

from portbench.maps import floor_plan


def build(height: int = 599, width: int = 1297, radius: int = 7, **rooms) -> np.ndarray:
    """bool[H, W] blocked mask: the stand-in's (`floor_plan.build`'s
    `rooms` arguments, its defaults where none is given), and every cell within
    `radius` (a disc, di^2 + dj^2 <= radius^2) of a blocked cell or of the
    map's edge. The planners' erode preamble (upstream
    `apps/hastar_planner.cpp`, `benchmarks/suite.py bench_hastar`'s
    radius 7 for its 15 px ellipse)."""
    blocked = floor_plan.build(height, width, **rooms)
    h, w = blocked.shape
    padded = np.pad(blocked, radius, constant_values=True)
    out = np.zeros_like(blocked)
    for di in range(-radius, radius + 1):
        for dj in range(-radius, radius + 1):
            if di * di + dj * dj <= radius * radius:
                out |= padded[radius + di:radius + di + h, radius + dj:radius + dj + w]
    return out
