"""Shared app plumbing: map loading with synthetic fallback, timing (port
of `slam_tpu/apps/common.py`).

Every app runs on the CUDA card unless given `--cpu` (`app_device`), and
raises without a card otherwise. The reference apps all start from
`cv::imread` + threshold/erode preambles (`apps/grid_slam.cpp:79-86`,
`apps/hastar_planner.cpp:130-134`); these helpers do the same from PNG
paths and provide procedurally generated maps for asset-free runs.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np

from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.utils import maps as maplib


def load_blocked(path: str | None, h: int = 256, w: int = 256) -> np.ndarray:
    """bool[H, W] blocked mask from a PNG (threshold 128, obstacle = dark,
    `apps/grid_slam.cpp:84-86`) or a synthetic room when path is None."""
    if path:
        return maplib.load_binary_map(path) == 0
    from slam_tpu_torch.models.simulate import synthetic_room

    return synthetic_room(h, w)


def inflate(blocked: np.ndarray, radius: int) -> np.ndarray:
    """Vehicle inflation: erode free space by a disc — the planners' erode
    preamble (`apps/hastar_planner.cpp:130-134`), through
    `native.erode_disc` (multithreaded C++ when built, else its numpy
    fallback)."""
    if radius <= 0:
        return blocked
    from slam_tpu_torch import native

    return ~native.erode_disc((~blocked).astype(np.uint8), radius).astype(bool)


def app_device(cpu: bool):
    """The apps' device: the CPU with `--cpu`, else the CUDA card (raises
    RuntimeError without one)."""
    return entry_device("cpu" if cpu else None)


@contextmanager
def measure_time(label: str):
    """`apps/hastar_planner.cpp:29-48` equivalent."""
    t0 = time.perf_counter()
    yield
    print(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")


def interactive_queries(stream=None):
    """Headless equivalent of the planners' mouse loop
    (`apps/hastar_planner.cpp:50-117`, `apps/rrt_planner.cpp:44-68`: L/R
    click = start/goal, replan when both are set).

    Reads commands from `stream` (default stdin), yields (start, goal)
    pairs, each of which the caller replans on the WARM planner object:

        X1 Y1 X2 Y2    plan start=(X1,Y1) goal=(X2,Y2)
        start X Y      set start (replans once goal is also set)
        goal X Y       set goal
        q / quit       exit
    """
    import sys

    stream = stream if stream is not None else sys.stdin
    start = goal = None
    for line in stream:
        parts = line.split()
        if not parts:
            continue
        cmd = parts[0].lower()
        if cmd in ("q", "quit", "exit"):
            return
        try:
            if cmd == "start":
                start = (float(parts[1]), float(parts[2]))
            elif cmd == "goal":
                goal = (float(parts[1]), float(parts[2]))
            else:
                vals = [float(v) for v in parts]
                if len(vals) != 4:
                    raise ValueError(line)
                start, goal = (vals[0], vals[1]), (vals[2], vals[3])
        except (ValueError, IndexError):
            print(f"? unparsed: {line.strip()!r} (want 'X1 Y1 X2 Y2', "
                  f"'start X Y', 'goal X Y', or 'quit')")
            continue
        if start is not None and goal is not None:
            yield start, goal
