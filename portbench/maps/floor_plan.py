"""The synthetic floor plan: a frozen copy, in numpy, of the program's
`slam_tpu_torch/utils/maps.py:synthetic_floor_plan`, so a change to the
program cannot move the yardstick. A configuration names it as its map
builder (`"plan": {"builder": "floor_plan", ...}`); the other entries
of `plan` are `build`'s arguments."""

from __future__ import annotations

import numpy as np


def build(height: int = 599, width: int = 1297, room_w: int = 200, room_h: int = 150,
          wall: int = 4, door: int = 40) -> np.ndarray:
    """bool[H, W] blocked mask: border walls and a grid of rooms with door
    gaps. The defaults are the 599 x 1297 stand-in for the upstream
    floor plan (`bench.py:floor_plan_blocked`): walls every 200 columns
    with a door of rows H//2 +- 40, walls every 150 rows with doors of
    columns W//3 +- 40 and 2W//3 +- 40."""
    h, w = height, width
    blocked = np.zeros((h, w), bool)
    blocked[:wall, :] = blocked[-wall:, :] = True
    blocked[:, :wall] = blocked[:, -wall:] = True
    for x in range(room_w, w - 100, room_w):
        blocked[:, x:x + wall] = True
        blocked[h // 2 - door:h // 2 + door, x:x + wall] = False
    for y in range(room_h, h - 80, room_h):
        blocked[y:y + wall, :] = True
        blocked[y:y + wall, w // 3 - door:w // 3 + door] = False
        blocked[y:y + wall, 2 * w // 3 - door:2 * w // 3 + door] = False
    return blocked
