"""Raycasting over occupancy grids (port of `slam_tpu/ops/raycast.py`):
the fixed-step DDA march and the sphere trace over a distance transform.

Semantics match the reference (`slam/raycast.cpp:8-141`): step positions
p_k = origin + k * step * dir for k = 1..K; the origin's own cell is never
tested; at each step, distance exhausted (d >= max_dist) or out of bounds
resolves the ray as a MISS (dist == max_dist, hit False), else a blocked
cell resolves it as a HIT at distance k * step. Rays march together in
chunks of `chunk` steps; the loop stops once every ray has resolved.

The JAX package's `while_loop`s become host loops. Both bodies leave a
resolved ray untouched, so the host reads `all(resolved)` only once per
chunk of steps (march) or iterations (sphere trace).
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.core import grid as gridlib

# Sphere-trace iterations between two host reads of `all(resolved)`.
_SDF_CHUNK = 8


def raycast_march(
    blocked: torch.Tensor,
    x,
    y,
    theta,
    *,
    step: float = 0.5,
    max_dist: float = 500.0,
    chunk: int = 64,
    row_offset: int | None = None,
    full_h: int | None = None,
):
    """March rays through bool[H, W] `blocked`. x, y, theta broadcast to a
    common batch shape. Returns (dist f32[batch], hit bool[batch]).

    `blocked` may be a row block of a map `full_h` rows high whose first
    row is the map's `row_offset`: cells outside the block read as free,
    so a ray's first hit on the whole map is the least of its first hits
    over the blocks (`parallel/mapshard.py` marches so)."""
    blocked = blocked.to(torch.bool)
    dev = blocked.device
    lh, w = blocked.shape
    h = lh if full_h is None else int(full_h)
    ro = 0 if row_offset is None else int(row_offset)
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
        il = i - ro  # block-local row; rows outside the block read as free
        inblk = (il >= 0) & (il < lh)
        ilc = torch.clamp(il, 0, lh - 1)
        jc = torch.clamp(j, 0, w - 1)
        occ = flat[(ilc.long() * w + jc).reshape(-1)].reshape(i.shape) & inblk
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


def raycast_sdf(
    edt: torch.Tensor,
    x,
    y,
    theta,
    *,
    step: float = 0.5,
    max_dist: float = 500.0,
    margin: float = 1.0,
    max_iters: int | None = None,
):
    """Sphere-trace rays over the f32[H, W] distance transform `edt`.

    Each iteration reads the EDT at the current position and advances by
    max(step, edt - margin): free stretches are crossed in one jump and
    near surfaces the advance falls to `step`. A cell is blocked iff its
    EDT is 0 (HIT at the marched distance, never the origin's cell);
    out of bounds or t >= max_dist is a MISS (dist == max_dist). `margin`
    guards against EDT overestimation (>= 1.5 with `edt_jfa`, 1.0 with
    `edt_exact`). Returns (dist f32[batch], hit bool[batch])."""
    dev = edt.device
    h, w = edt.shape
    x, y, theta = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (x, y, theta))
    )
    batch_shape = x.shape
    x, y, theta = x.reshape(-1), y.reshape(-1), theta.reshape(-1)
    m = x.shape[0]
    if max_iters is None:
        max_iters = int(math.ceil(max_dist / step)) + 4

    dx = torch.cos(theta)
    dy = torch.sin(theta)
    i0, j0 = gridlib.world_to_cell((h, w), x, y)
    cell0 = i0 * w + j0
    flat = edt.reshape(-1)

    t = torch.full((m,), step, dtype=torch.float32, device=dev)
    resolved = torch.zeros((m,), dtype=torch.bool, device=dev)
    hit = torch.zeros((m,), dtype=torch.bool, device=dev)
    dist = torch.full((m,), max_dist, dtype=torch.float32, device=dev)
    k = 0
    while k < max_iters and not bool(resolved.all()):
        for _ in range(min(_SDF_CHUNK, max_iters - k)):
            i, j = gridlib.world_to_cell((h, w), x + t * dx, y + t * dy)
            ic, jc = gridlib.clamp_cell((h, w), i, j)
            cell = ic * w + jc  # == i * w + j wherever the ray is in bounds
            d_cell = flat[cell]
            # Still marching: in bounds (clamping moved nothing), t < max.
            on = (t < max_dist) & (ic == i) & (jc == j)
            hit_now = (d_cell <= 0.0) & (cell != cell0) & on & ~resolved
            dist = torch.where(hit_now, t, dist)
            hit = hit | hit_now
            resolved = resolved | hit_now | ~on
            t = torch.where(resolved, t, t + torch.clamp(d_cell - margin, min=step))
            k += 1
    return dist.reshape(batch_shape), hit.reshape(batch_shape)


def raycast_hit_points(x, y, theta, dist, hit):
    """Continuous hit coordinates (origin + dist * dir) of hitting rays,
    -1 elsewhere."""
    hx = torch.where(hit, x + dist * torch.cos(theta), -1.0)
    hy = torch.where(hit, y + dist * torch.sin(theta), -1.0)
    return hx, hy
