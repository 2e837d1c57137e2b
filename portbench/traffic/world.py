"""The lidar that scans the world the traffic runs in. A frozen copy, in
plain PyTorch and numpy, of what the program uses for the same purpose
(`slam_tpu_torch/models/fake_lidar.py:scan` and `ops/raycast.py:
raycast_march`), so a change to the program cannot move the yardstick.

World coordinates are y-up with the origin at the bottom-left of the map;
image (row i, column j) has row 0 at the top: i = floor(H - y - 1),
j = floor(x).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def world_to_cell(h: int, x, y):
    i = torch.floor(h - y - 1.0).to(torch.int32)
    j = torch.floor(x).to(torch.int32)
    return i, j


def sensor_pose(x, y, theta, offset):
    """The sensor's pose from the robot's: the mounting offset (ox, oy,
    rot) as a displacement d at angle atan2(oy, ox) from the heading."""
    ox, oy, rot = offset
    d, a = math.hypot(ox, oy), math.atan2(oy, ox)
    return x + torch.cos(theta + a) * d, y + torch.sin(theta + a) * d, theta + rot


def march(blocked: torch.Tensor, x, y, theta, *, step: float, max_dist: float,
          chunk: int = 64):
    """Fixed-step ray march (the upstream `slam/raycast.cpp` semantics):
    positions origin + k * step * dir for k = 1..K; the origin's own cell
    is never tested; distance exhausted or out of bounds is a miss
    (dist = max_dist), a blocked cell a hit at k * step. Returns (dist,
    hit) of the broadcast rays."""
    dev = blocked.device
    h, w = blocked.shape
    x, y, theta = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (x, y, theta)))
    shape = x.shape
    x, y, theta = x.reshape(-1), y.reshape(-1), theta.reshape(-1)
    m = x.shape[0]
    k_end = -(-int(math.ceil(max_dist / step)) // chunk) * chunk
    dx, dy = torch.cos(theta) * step, torch.sin(theta) * step
    i0, j0 = world_to_cell(h, x, y)
    cell0 = i0 * w + j0
    flat = blocked.reshape(-1)
    ks_rel = torch.arange(1, chunk + 1, dtype=torch.float32, device=dev)
    resolved = torch.zeros((m,), dtype=torch.bool, device=dev)
    hit = torch.zeros((m,), dtype=torch.bool, device=dev)
    dist = torch.full((m,), max_dist, dtype=torch.float32, device=dev)
    for k0 in range(0, k_end, chunk):
        ks = float(k0) + ks_rel
        d = ks * step
        i, j = world_to_cell(h, x[:, None] + ks[None, :] * dx[:, None],
                             y[:, None] + ks[None, :] * dy[:, None])
        inb = (i >= 0) & (i < h) & (j >= 0) & (j < w)
        occ = flat[(i.clamp(0, h - 1).long() * w + j.clamp(0, w - 1)).reshape(-1)]
        occ = occ.reshape(i.shape)
        miss = (d[None, :] >= max_dist) | ~inb
        hit_k = occ & (i * w + j != cell0[:, None]) & ~miss
        event = miss | hit_k
        first = event.to(torch.uint8).argmax(dim=-1)
        newly = event.any(dim=-1) & ~resolved
        hit_first = torch.gather(hit_k, 1, first[:, None])[:, 0]
        hit = torch.where(newly, hit_first, hit)
        dist = torch.where(newly & hit_first, (float(k0) + first.float() + 1.0) * step, dist)
        resolved |= event.any(dim=-1)
        if bool(resolved.all()):
            break
    return dist.reshape(shape), hit.reshape(shape)


def beam_angles(start: float, stop: float, n: int):
    """Beam angles relative to the sensor heading, centred on it
    (`LidarConfig.angles`: k * step - range / 2)."""
    rng = stop - start
    return [k * (rng / n) - rng / 2.0 for k in range(n)]


def scans(blocked: torch.Tensor, poses: np.ndarray, lidar: dict, offset) -> torch.Tensor:
    """f32 [T, B] ranges of the scans taken from robot poses [T, 3] (f64)
    by the lidar {start, stop, n_rays, max_dist, step}; a miss reads
    max_dist exactly."""
    dev = blocked.device
    p = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    sx, sy, st = sensor_pose(p[:, 0], p[:, 1], p[:, 2], offset)
    ang = torch.tensor(beam_angles(lidar["start"], lidar["stop"], lidar["n_rays"]),
                       dtype=torch.float32, device=dev)
    dist, hit = march(blocked, sx[:, None], sy[:, None], st[:, None] + ang[None, :],
                      step=lidar["step"], max_dist=lidar["max_dist"])
    return torch.where(hit, dist, torch.full_like(dist, lidar["max_dist"]))
