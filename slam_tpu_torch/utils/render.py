"""Headless rendering: occupancy maps + overlays -> PNG/GIF (a copy of
`slam_tpu/utils/render.py`, which is numpy and PIL only).

The reference's observability is interactive OpenCV drawing (`cv::imshow` in
every app; particle/pose overlays `apps/grid_slam.cpp:112-127`, frontier and
tree drawing inside the planners). A GPU deployment is headless too, so the
equivalent here renders numpy frames and writes PNG/GIF via PIL. All drawing
is host-side numpy: callers pass host arrays (`tensor.cpu().numpy()`).

Colors follow `slam/colors.h:5-12` (BGR there, RGB here).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image

# `slam/colors.h` equivalents (RGB).
BLUE = (0, 0, 255)
GREEN = (0, 255, 0)
RED = (255, 0, 0)
WHITE = (255, 255, 255)
BLACK = (0, 0, 0)
YELLOW = (255, 255, 0)
CYAN = (0, 255, 255)
MAGENTA = (255, 0, 255)


def prob_to_rgb(prob_occ: np.ndarray) -> np.ndarray:
    """u8[H, W, 3] grayscale canvas from P(occupied) in [0, 1] (dark =
    occupied, matching the reference's P(free)-scaled gray maps)."""
    g = np.clip((1.0 - np.asarray(prob_occ)) * 255.0, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def blocked_to_rgb(blocked: np.ndarray) -> np.ndarray:
    return prob_to_rgb(np.asarray(blocked, np.float32))


def world_to_px(shape, x, y) -> Tuple[int, int]:
    """World (x, y) -> (row, col), the `slam/util.h:30-38` convention."""
    h = shape[0]
    return int(np.floor(h - y - 1.0)), int(np.floor(x))


def draw_disc(img: np.ndarray, i: int, j: int, radius: int, color) -> None:
    h, w = img.shape[:2]
    i0, i1 = max(0, i - radius), min(h, i + radius + 1)
    j0, j1 = max(0, j - radius), min(w, j + radius + 1)
    if i0 >= i1 or j0 >= j1:
        return
    yy, xx = np.mgrid[i0:i1, j0:j1]
    mask = (yy - i) ** 2 + (xx - j) ** 2 <= radius * radius
    img[i0:i1, j0:j1][mask] = color


def draw_line(img: np.ndarray, i0: int, j0: int, i1: int, j1: int, color) -> None:
    """Bresenham segment (cv::line parity for 1px lines)."""
    h, w = img.shape[:2]
    di, dj = abs(i1 - i0), abs(j1 - j0)
    si = 1 if i0 < i1 else -1
    sj = 1 if j0 < j1 else -1
    err = di - dj
    i, j = i0, j0
    while True:
        if 0 <= i < h and 0 <= j < w:
            img[i, j] = color
        if i == i1 and j == j1:
            break
        e2 = 2 * err
        if e2 > -dj:
            err -= dj
            i += si
        if e2 < di:
            err += di
            j += sj


def draw_pose(img, x, y, theta, color, radius: int = 2, nose: int = 6) -> None:
    """Disc + heading tick (`apps/grid_slam.cpp:draw_particle` analogue)."""
    i, j = world_to_px(img.shape, float(x), float(y))
    draw_disc(img, i, j, radius, color)
    i2, j2 = world_to_px(
        img.shape,
        float(x) + nose * np.cos(float(theta)),
        float(y) + nose * np.sin(float(theta)),
    )
    draw_line(img, i, j, i2, j2, color)


def draw_particles(img, xs, ys, color=RED, max_draw: int = 2000) -> None:
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    stride = max(1, len(xs) // max_draw)
    h, w = img.shape[:2]
    i = np.clip(np.floor(h - ys[::stride] - 1.0).astype(int), 0, h - 1)
    j = np.clip(np.floor(xs[::stride]).astype(int), 0, w - 1)
    img[i, j] = color


def draw_path_cells(img, path: Sequence[Tuple[int, int]], color=GREEN) -> None:
    """Draw an (i, j) cell path (A*/HA* output)."""
    for (i0, j0), (i1, j1) in zip(path, path[1:]):
        draw_line(img, i0, j0, i1, j1, color)


def draw_path_world(img, path: Sequence[Tuple[float, float]], color=GREEN) -> None:
    """Draw an (x, y) world path (RRT* output)."""
    cells = [world_to_px(img.shape, x, y) for x, y in path]
    draw_path_cells(img, cells, color)


def draw_scan(img, sensor_x, sensor_y, sensor_theta, angles, dists, color=CYAN):
    for a, d in zip(np.asarray(angles), np.asarray(dists)):
        ex = float(sensor_x) + float(d) * np.cos(float(sensor_theta) + float(a))
        ey = float(sensor_y) + float(d) * np.sin(float(sensor_theta) + float(a))
        i0, j0 = world_to_px(img.shape, float(sensor_x), float(sensor_y))
        i1, j1 = world_to_px(img.shape, ex, ey)
        draw_line(img, i0, j0, i1, j1, color)


def save_png(img: np.ndarray, path: str) -> None:
    Image.fromarray(img).save(path)


def save_gif(frames: List[np.ndarray], path: str, fps: int = 10) -> None:
    """Assemble frames into an animated GIF (the notebook's slam.gif
    analogue)."""
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(
        path,
        save_all=True,
        append_images=ims[1:],
        duration=int(1000 / fps),
        loop=0,
    )
