"""Occupancy-grid coordinate conventions (port of `slam_tpu/core/grid.py`).

World coordinates are y-up with the origin at the bottom-left of the map;
image (array) coordinates are (row i, col j) with row 0 at the top:

    i = floor(H - y - 1)        j = floor(x)
    x = j                       y = H - i        (cell -> world)
"""

from __future__ import annotations

import torch


def world_to_cell(shape, x, y):
    """World (x, y) -> int32 image (i, j): floor, then cast (as the JAX
    package does, so negative coordinates floor toward -inf)."""
    h = shape[0]
    i = torch.floor(h - y - 1.0).to(torch.int32)
    j = torch.floor(x).to(torch.int32)
    return i, j


def cell_to_world(shape, i, j):
    """Image (i, j) -> f32 world (x, y) (`slam/util.h:40-43`)."""
    h = shape[0]
    x = torch.as_tensor(j).to(torch.float32)
    y = torch.as_tensor(h - i).to(torch.float32)
    return x, y


def in_bounds(shape, i, j):
    """Bounds test (`slam/util.h:45-53`)."""
    h, w = shape[0], shape[1]
    return (i >= 0) & (i < h) & (j >= 0) & (j < w)


def clamp_cell(shape, i, j):
    """Clamp cell indices into range (for safe gathers; pair with in_bounds)."""
    h, w = shape[0], shape[1]
    return torch.clamp(i, 0, h - 1), torch.clamp(j, 0, w - 1)
