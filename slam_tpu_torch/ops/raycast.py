"""Fixed-step DDA raycasting (port of `slam_tpu/ops/raycast.py:raycast_march`).

Semantics match the reference (`slam/raycast.cpp:8-141`): step positions
p_k = origin + k * step * dir for k = 1..K; the origin's own cell is never
tested; at each step, distance exhausted (d >= max_dist) or out of bounds
resolves the ray as a MISS (dist == max_dist, hit False), else a blocked
cell resolves it as a HIT at distance k * step. Rays march together in
chunks of `chunk` steps; the loop stops once every ray has resolved.
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.core import grid as gridlib


def raycast_march(
    blocked: torch.Tensor,
    x,
    y,
    theta,
    *,
    step: float = 0.5,
    max_dist: float = 500.0,
    chunk: int = 64,
):
    """March rays through bool[H, W] `blocked`. x, y, theta broadcast to a
    common batch shape. Returns (dist f32[batch], hit bool[batch])."""
    blocked = blocked.to(torch.bool)
    dev = blocked.device
    h, w = blocked.shape
    x, y, theta = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (x, y, theta))
    )
    batch_shape = x.shape
    x, y, theta = x.reshape(-1), y.reshape(-1), theta.reshape(-1)
    m = x.shape[0]

    k_total = int(math.ceil(max_dist / step))
    k_end = -(-k_total // chunk) * chunk

    dx = torch.cos(theta) * step
    dy = torch.sin(theta) * step
    i0, j0 = gridlib.world_to_cell((h, w), x, y)
    cell0 = i0 * w + j0  # may be out of range; only used for inequality tests

    flat = blocked.reshape(-1)
    ks_rel = torch.arange(1, chunk + 1, dtype=torch.float32, device=dev)
    resolved = torch.zeros((m,), dtype=torch.bool, device=dev)
    hit = torch.zeros((m,), dtype=torch.bool, device=dev)
    dist = torch.full((m,), max_dist, dtype=torch.float32, device=dev)

    k0 = 0
    while k0 < k_end and not bool(resolved.all()):
        ks = float(k0) + ks_rel  # [chunk]
        d = ks * step
        px = x[:, None] + ks[None, :] * dx[:, None]
        py = y[:, None] + ks[None, :] * dy[:, None]
        i, j = gridlib.world_to_cell((h, w), px, py)
        inb = gridlib.in_bounds((h, w), i, j)
        ic, jc = gridlib.clamp_cell((h, w), i, j)
        occ = flat[(ic.long() * w + jc).reshape(-1)].reshape(i.shape)
        cell = i * w + j
        miss = (d[None, :] >= max_dist) | ~inb
        hit_k = occ & (cell != cell0[:, None]) & ~miss
        event = miss | hit_k

        any_event = event.any(dim=-1)
        first = event.to(torch.uint8).argmax(dim=-1)  # first True
        d_first = (float(k0) + first.to(torch.float32) + 1.0) * step
        hit_first = torch.gather(hit_k, 1, first[:, None])[:, 0]

        newly = any_event & ~resolved
        resolved = resolved | any_event
        hit = torch.where(newly, hit_first, hit)
        dist = torch.where(newly & hit_first, d_first, dist)
        k0 += chunk
    return dist.reshape(batch_shape), hit.reshape(batch_shape)
