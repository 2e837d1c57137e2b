"""Maps the port runs on without any asset file."""

from __future__ import annotations

import numpy as np


def synthetic_floor_plan() -> np.ndarray:
    """bool[599, 1297] blocked mask: the synthetic stand-in for the
    reference's floor plan that `bench.py:floor_plan_blocked` uses when
    the asset is absent (border walls + a grid of rooms with door gaps)."""
    h, w = 599, 1297
    blocked = np.zeros((h, w), bool)
    blocked[:4, :] = blocked[-4:, :] = True
    blocked[:, :4] = blocked[:, -4:] = True
    for x in range(200, w - 100, 200):  # vertical walls with door gaps
        blocked[:, x : x + 4] = True
        blocked[h // 2 - 40 : h // 2 + 40, x : x + 4] = False
    for y in range(150, h - 80, 150):  # horizontal walls with door gaps
        blocked[y : y + 4, :] = True
        blocked[y : y + 4, w // 3 - 40 : w // 3 + 40] = False
        blocked[y : y + 4, 2 * w // 3 - 40 : 2 * w // 3 + 40] = False
    return blocked
