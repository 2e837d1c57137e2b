"""Map IO and the maps the port runs on without any asset file, and the
planners' map preamble (disc erosion, vehicle inflation)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def load_grayscale(path) -> np.ndarray:
    """u8[H, W] grayscale image."""
    return np.asarray(Image.open(path).convert("L"))


def load_binary_map(path, threshold: int = 128) -> np.ndarray:
    """i32[H, W] 0/1 ground-truth map: 1 = free, 0 = obstacle
    (`apps/grid_slam.cpp:84-86` THRESH_BINARY at 128; a copy of
    `slam_tpu/utils/maps.py:load_binary_map`)."""
    g = load_grayscale(path)
    return (g > threshold).astype(np.int32)


def load_prob_map(path, threshold: int = 128) -> np.ndarray:
    """f32[H, W] probability-of-free map, 0.0 or 1.0 after binarization
    (the planners' CV_64F convention, `slam/astar.h:14-17`; a copy of
    `slam_tpu/utils/maps.py:load_prob_map`)."""
    return load_binary_map(path, threshold).astype(np.float32)


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


def erode(binary: np.ndarray, radius: int) -> np.ndarray:
    """Binary erosion by a disc of `radius` (a copy of
    `slam_tpu/utils/maps.py:erode`): the AND of the shifted copies over
    the disc's offsets, False outside the map."""
    if radius <= 0:
        return binary.copy()
    out = binary.astype(bool)
    h, w = out.shape
    acc = np.ones_like(out)
    yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    disc = (yy * yy + xx * xx) <= radius * radius
    padded = np.pad(out, radius, constant_values=False)
    for dy, dx in zip(*np.nonzero(disc)):
        acc &= padded[dy : dy + h, dx : dx + w]
    return acc.astype(binary.dtype)


def inflate(blocked: np.ndarray, radius: int) -> np.ndarray:
    """Vehicle inflation: erode free space by a disc of `radius` (the
    numpy path of `slam_tpu/apps/common.py:inflate`, the planners' map
    preamble)."""
    if radius <= 0:
        return blocked
    return ~erode((~blocked).astype(np.uint8), radius).astype(bool)
