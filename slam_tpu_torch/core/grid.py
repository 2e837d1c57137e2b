"""Occupancy-grid coordinate conventions and log-odds algebra (port of
`slam_tpu/core/grid.py`).

World coordinates are y-up with the origin at the bottom-left of the map;
image (array) coordinates are (row i, col j) with row 0 at the top:

    i = floor(H - y - 1)        j = floor(x)
    x = j                       y = H - i        (cell -> world)

The SLAM map is one shared f32[H, W] grid of the log-odds of occupancy:
p_occ = sigmoid(l), and a cell is blocked iff l > 0 (strict: unknown, 0,
is traversable).
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


def cell_to_world(shape, i, j, dtype=torch.float32):
    """Image (i, j) -> world (x, y) in `dtype` (`slam/util.h:40-43`)."""
    h = shape[0]
    x = torch.as_tensor(j).to(dtype)
    y = torch.as_tensor(h - i).to(dtype)
    return x, y


def in_bounds(shape, i, j):
    """Bounds test (`slam/util.h:45-53`)."""
    h, w = shape[0], shape[1]
    return (i >= 0) & (i < h) & (j >= 0) & (j < w)


def clamp_cell(shape, i, j):
    """Clamp cell indices into range (for safe gathers; pair with in_bounds)."""
    h, w = shape[0], shape[1]
    return torch.clamp(i, 0, h - 1), torch.clamp(j, 0, w - 1)


def log_odds(p):
    """p -> log odds (`slam/util.h:72`)."""
    return torch.log(p / (1.0 - p))


def log_odds_inv(l):
    """log odds -> p (`slam/util.h:73`); equals sigmoid(l)."""
    return torch.sigmoid(l)


def blocked_from_logodds(grid_logodds: torch.Tensor) -> torch.Tensor:
    """bool[H, W]: cell is blocked iff log-odds(occ) > 0."""
    return grid_logodds > 0.0


def blocked_from_prob_free(prob_free: torch.Tensor) -> torch.Tensor:
    """bool[H, W] from a probability-of-free map (blocked iff p_free < 0.5,
    `slam/raycast.cpp:43`)."""
    return prob_free < 0.5


def blocked_from_u8(map_u8: torch.Tensor) -> torch.Tensor:
    """bool[H, W] from a quantized uint8 map (blocked iff value < 128,
    `slam/raycast.cpp:90`)."""
    return map_u8 < 128


def blocked_from_binary(map_i32: torch.Tensor) -> torch.Tensor:
    """bool[H, W] from a 0/1 ground-truth map (blocked iff value == 0,
    `slam/raycast.cpp:136`)."""
    return map_i32 == 0


def uniform_logodds(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """A fresh unknown map: log-odds 0 (p = 0.5) everywhere."""
    return torch.zeros(shape, dtype=dtype, device=device)
