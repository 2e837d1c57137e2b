"""The SLAM step's map-side work, worked out again from the grid: the
capped distance transform, the likelihood-field weights through the boxed
correlative table, and the log-odds map update. Plain PyTorch of the same
semantics as the port's SLAM step.

  capped EDT   the distance between cell centres to the nearest blocked
               cell (log-odds > 0): the nearest blocked cell of each
               column within C + 1 rows (C = ceil(cap)), then the least
               g^2 + k^2 over the columns k within C; square roots
               correctly rounded
  score        log(z_hit N(d; sigma) + z_rand / max_dist) of each cell
  table        over T heading bins spanning the cloud's circular spread
               (4 circular stddevs + 0.02 each side), in a box of 128
               cells around the cloud's mean sensor cell: the sum over the
               scan's valid beams of the score at the beam's endpoint
               cell, offset floor(0.5 - dy), floor(0.5 + dx) from the cell;
               off the map the floor log(z_rand / max_dist)
  weight       the sensor cell's table score, linear between the two bins
               around the particle's heading; a particle out of the box
               or more than half a bin past the window scores the floor
               times the valid beams
  map update   each beam marched in steps of 0.5 from the sensor pose of
               the mode pose: each new in-map cell before the range adds
               l_free once, the first at or past it l_occ (not on a
               max-range miss), the march ending at the first step off
               the map; the sum clamped to [l_min, l_max]
"""

from __future__ import annotations

import math

import torch

from portbench.reference.beam import sensor


def edt_capped(blocked: torch.Tensor, cap: float) -> torch.Tensor:
    h, w = blocked.shape
    dev = blocked.device
    c = int(math.ceil(cap))
    ii = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    up = ii - torch.cummax(torch.where(blocked, ii, -(1 << 30)), 0).values
    down = torch.cummin(torch.where(blocked, ii, 1 << 30).flip(0), 0).values.flip(0) - ii
    g = torch.clamp(torch.minimum(up, down), max=c + 1).to(torch.float32)
    g2 = torch.nn.functional.pad(g * g, (c, c), value=1e9)
    best = torch.full((h, w), 1e9, dtype=torch.float32, device=dev)
    for k in range(-c, c + 1):
        best = torch.minimum(best, g2[:, c + k:c + k + w] + float(k * k))
    big = float(h + w)
    return torch.sqrt(torch.clamp(best, max=big * big).to(torch.float64)).to(torch.float32)


def score_field(edt, stddev, z_hit, z_rand, max_dist):
    pdf = torch.exp(-0.5 * (edt / stddev) * (edt / stddev)) / (stddev * math.sqrt(2.0 * math.pi))
    return torch.log(torch.clamp(z_hit * pdf + z_rand / max_dist, min=1e-30))


def lf_weights(edt, x, y, th, dists, angles, cfg: dict):
    """f32 [N] log weights of poses (x, y, th) through the boxed table."""
    h, w = edt.shape
    dev = edt.device
    t = int(cfg["lf_table_bins"])
    max_dist = float(cfg["raycast"]["max_dist"])
    z_rand = float(cfg["lf_z_rand"])
    sx, sy, st = sensor(x, y, th, cfg["scanner_offset"])
    c, s = torch.mean(torch.cos(st)), torch.mean(torch.sin(st))
    mx, my = torch.mean(sx), torch.mean(sy)
    mu = torch.atan2(s, c)
    rbar = torch.clamp(torch.sqrt(c * c + s * s), 1e-7, 1.0 - 1e-7)
    half = torch.clamp(cfg["lf_table_spread"] * torch.sqrt(-2.0 * torch.log(rbar))
                       + cfg["lf_table_min_halfwidth"], cfg["lf_table_min_halfwidth"], math.pi)
    binw = 2.0 * half / (t - 1)
    heads = mu + (torch.arange(t, dtype=torch.float32, device=dev) - (t - 1) / 2.0) * binw
    box = int(cfg["lf_table_box"])
    si, sj = min(box, h), min(box, w)
    mi = torch.floor(h - my - 1.0).to(torch.int32)
    mj = torch.floor(mx).to(torch.int32)
    i0 = torch.clamp(mi - si // 2, 0, h - si)
    j0 = torch.clamp(mj - sj // 2, 0, w - sj)

    # The table over the box: T x si x sj sums of the score at the
    # endpoints of the valid beams.
    pad = int(math.ceil(max_dist)) + 1
    floor_val = float(math.log(max(z_rand / max_dist, 1e-30)))
    score = score_field(edt, cfg["meas_stddev"], cfg["lf_z_hit"], z_rand, max_dist)
    valid = dists < max_dist
    ang = heads[:, None] + angles[None, :]
    oi = (torch.floor(0.5 - dists[None, :] * torch.sin(ang)).to(torch.int64) + pad).clamp(0, 2 * pad)
    oj = (torch.floor(0.5 + dists[None, :] * torch.cos(ang)).to(torch.int64) + pad).clamp(0, 2 * pad)
    rows = i0.long() - pad + torch.arange(si, device=dev)
    cols = j0.long() - pad + torch.arange(sj, device=dev)
    tab = torch.zeros((t, si, sj), dtype=torch.float32, device=dev)
    for b in torch.nonzero(valid).flatten().tolist():
        r = rows[None, :] + oi[:, b:b + 1]  # [T, si]
        q = cols[None, :] + oj[:, b:b + 1]  # [T, sj]
        on = ((r >= 0) & (r < h))[:, :, None] & ((q >= 0) & (q < w))[:, None, :]
        v = score[r.clamp(0, h - 1)[:, :, None], q.clamp(0, w - 1)[:, None, :]]
        tab += torch.where(on, v, floor_val)

    # The lookup.
    i = torch.floor(h - sy - 1.0).to(torch.int32)
    j = torch.floor(sx).to(torch.int32)
    il = i.clamp(0, h - 1) - i0
    jl = j.clamp(0, w - 1) - j0
    in_box = (il >= 0) & (il < si) & (jl >= 0) & (jl < sj)
    binw_ = torch.where(binw > 0, binw, 1.0)
    d = torch.atan2(torch.sin(st - mu), torch.cos(st - mu))
    u = torch.clamp(d / binw_ + (t - 1) / 2.0, 0.0, float(t - 1))
    t0 = torch.clamp(torch.floor(u).long(), 0, t - 2)
    frac = u - t0.to(u.dtype)
    ilc, jlc = il.clamp(0, si - 1).long(), jl.clamp(0, sj - 1).long()
    lo, hi = tab[t0, ilc, jlc], tab[t0 + 1, ilc, jlc]
    sc = (1.0 - frac) * lo + frac * hi
    floor_lw = valid.sum().to(torch.float32) * floor_val
    out = (torch.abs(d) > half + 0.5 * binw_) | ~in_box
    return torch.where(out, floor_lw, sc)


def logodds_update(grid, px, py, pth, dists, angles, cfg: dict):
    """The grid after mapping one scan from robot pose (px, py, pth)."""
    h, w = grid.shape
    dev = grid.device
    step = float(cfg["raycast"]["step"])
    max_dist = float(cfg["raycast"]["max_dist"])
    m = cfg["map"]
    sx, sy, st = sensor(px, py, pth, cfg["scanner_offset"])
    a = st + angles  # [B]
    k = torch.arange(1, int(math.ceil(max_dist / step)) + 1, dtype=torch.float32, device=dev)
    d = k * step
    xs = sx + k[None, :] * (torch.cos(a) * step)[:, None]
    ys = sy + k[None, :] * (torch.sin(a) * step)[:, None]
    i = torch.floor(h - ys - 1.0).to(torch.int64)
    j = torch.floor(xs).to(torch.int64)
    cell = i * w + j
    i0 = torch.floor(h - sy - 1.0).to(torch.int64)
    j0 = torch.floor(sx).to(torch.int64)
    prev = torch.cat([(i0 * w + j0).reshape(1, 1).expand(cell.shape[0], 1), cell[:, :-1]], dim=1)
    inb = (i >= 0) & (i < h) & (j >= 0) & (j < w)
    processed = (cell != prev) & (torch.cumprod(inb.to(torch.int32), dim=1) > 0)
    z = dists[:, None]
    free = processed & (d[None, :] < z)
    past = processed & (d[None, :] >= z)
    first = torch.argmax(past.to(torch.uint8), dim=1)
    occ = torch.zeros_like(past)
    has = past.any(dim=1) & (dists < max_dist)
    occ[torch.arange(past.shape[0], device=dev), first] = has
    occ &= past
    flat = torch.where(inb, i.clamp(0, h - 1) * w + j.clamp(0, w - 1), h * w).reshape(-1)
    n_free = torch.zeros(h * w + 1, dtype=torch.int64, device=dev).index_add_(
        0, flat, free.reshape(-1).to(torch.int64))[:-1]
    n_occ = torch.zeros(h * w + 1, dtype=torch.int64, device=dev).index_add_(
        0, flat, occ.reshape(-1).to(torch.int64))[:-1]
    delta = n_free.to(torch.float32) * m["l_free"] + n_occ.to(torch.float32) * m["l_occ"]
    return torch.clamp(grid + delta.reshape(h, w), m["l_min"], m["l_max"])
