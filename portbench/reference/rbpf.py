"""The per-particle-map filter's weigh and map step, worked out again from
each particle's own map: plain PyTorch of the upstream RBPF's semantics
(`slam/raycast.cpp:143-242`, `slam/mcl.cpp:49-77`), in float32.

  sensor   the robot pose moved by the lidar's mount (ox, oy, rot): a
           displacement d = hypot(ox, oy) at angle atan2(oy, ox) from the
           heading, whose cosine and sine are taken in float64 and
           rounded to float32 (the same bits on every device); heading
           theta + rot
  beams    beam b at the sensor's heading plus the scan's angle b, its
           cosine and sine taken as the mount's
  march    samples k = 1..K, K = ceil(max_dist / step), at the sensor
           plus k times (step cos, step sin); a sample's cell is row
           floor(H - y - 1), column floor(x); a sample is visited where
           its cell is on the map, every earlier sample's was too, and
           its cell is not the previous sample's (the sensor's for k = 1)
  hit      the first visited sample outside the sensor's own cell whose
           cell reads occupied (code < 128) in the particle's map as it
           was before the scan: predicted range k step
  weight   each beam's log(N(err; sigma) + eps), N the normal density
           set to 0 past 4 sigma, err = predicted - measured on a hit and
           measured - max_dist otherwise; summed over the beams
  write    into a copy of the particle's map, from its codes before the
           scan: each visited sample with k step < measured the free
           update, the first visited sample with k step >= measured the
           occupied update where measured < max_dist (a miss writes no
           endpoint). The u8 rule: P(free) = code / 255 times l / l0,
           clamped to [1 / 255, 1], stored as floor(255 P); with the
           ratios taken exactly (4 / 5 and 6 / 5 here) that is
           clamp(floor(code l / l0), 1, 255) in integers. Where several
           writes of one particle land on one cell, the last in (beam,
           sample) order stays.
"""

from __future__ import annotations

import math
from fractions import Fraction

import torch

# Lanes (particle x beam x sample) worked at once.
BLOCK_LANES = 1 << 23


def _cos_sin(a: torch.Tensor):
    a = a.to(torch.float64)
    return torch.cos(a).to(torch.float32), torch.sin(a).to(torch.float32)


def sensor(x, y, th, offset):
    ox, oy, rot = offset
    d, a = math.hypot(ox, oy), math.atan2(oy, ox)
    c, s = _cos_sin(th + a)
    return x + c * d, y + s * d, th + rot


def ratio(m: dict, key: str):
    """(numerator, denominator) of l / l0 taken exactly from the decimals."""
    r = Fraction(str(m[key])) / Fraction(str(m["l0"]))
    return r.numerator, r.denominator


def update_code(code: torch.Tensor, num: int, den: int) -> torch.Tensor:
    """The u8 rule on codes (any integer dtype): clamp(floor(code num /
    den), 1, 255)."""
    return torch.clamp((code.to(torch.int64) * num) // den, 1, 255)


def weigh_and_map(maps: torch.Tensor, x, y, th, dists, angles, cfg: dict):
    """(log weights f32 [N], the new maps u8 [N, H, W]) of particles at
    poses (x, y, th) against their maps `maps` u8 [N, H, W] and one scan
    (ranges `dists` [B] at `angles` [B] from the sensor's heading)."""
    n, h, w = maps.shape
    dev = maps.device
    rc, m = cfg["raycast"], cfg["map"]
    step, max_dist = float(rc["step"]), float(rc["max_dist"])
    sigma, eps = float(cfg["meas_stddev"]), float(cfg["meas_epsilon"])
    occ_below = int(m["occupied_below"])
    free_r, occ_r = ratio(m, "l_free"), ratio(m, "l_occ")
    k_total = int(math.ceil(max_dist / step))
    ks = torch.arange(1, k_total + 1, dtype=torch.float32, device=dev)
    kidx = torch.arange(k_total, device=dev)
    z = dists.to(dev, torch.float32)
    angles = angles.to(dev, torch.float32)
    b = z.shape[0]
    sx, sy, st = sensor(x, y, th, cfg["scanner_offset"])
    out = maps.clone().reshape(-1)
    src = maps.reshape(-1)
    lw = torch.empty((n,), dtype=torch.float32, device=dev)
    norm = sigma * math.sqrt(2.0 * math.pi)
    per = max(1, BLOCK_LANES // (b * k_total))
    for p0 in range(0, n, per):
        p1 = min(n, p0 + per)
        c, s = _cos_sin(st[p0:p1, None] + angles[None, :])  # [C, B]
        px = sx[p0:p1, None, None] + (c * step)[..., None] * ks
        py = sy[p0:p1, None, None] + (s * step)[..., None] * ks
        i = torch.floor(h - py - 1.0).to(torch.int64)
        j = torch.floor(px).to(torch.int64)
        cell = i * w + j  # [C, B, K]
        i0 = torch.floor(h - sy[p0:p1] - 1.0).to(torch.int64)
        j0 = torch.floor(sx[p0:p1]).to(torch.int64)
        own = (i0 * w + j0)[:, None, None]
        prev = torch.cat([own.expand(-1, b, 1), cell[..., :-1]], dim=-1)
        on = (i >= 0) & (i < h) & (j >= 0) & (j < w)
        stayed = torch.cumsum((~on).to(torch.int32), dim=-1) == 0
        visited = stayed & (cell != prev)
        base = torch.arange(p0, p1, device=dev)[:, None, None] * (h * w)
        tgt = base + i.clamp(0, h - 1) * w + j.clamp(0, w - 1)
        code = src[tgt]

        # The predicted hit against the map before the scan.
        occupied = visited & (code < occ_below) & (cell != own)
        first_hit = torch.where(occupied, kidx, k_total).amin(dim=-1)  # [C, B]
        hit = first_hit < k_total
        pred = (first_hit + 1).to(torch.float32) * step
        err = torch.where(hit, pred - z, z - max_dist)
        pdf = torch.exp(-0.5 * (err / sigma) ** 2) / norm
        pdf = torch.where(err.abs() > 4.0 * sigma, torch.zeros_like(pdf), pdf)
        lw[p0:p1] = torch.log(pdf + eps).to(torch.float64).sum(dim=-1).to(torch.float32)

        # The writes, from the codes before the scan.
        d = ks * step
        free = visited & (d < z[:, None])
        past = visited & (d >= z[:, None])
        first_past = torch.where(past, kidx, k_total).amin(dim=-1, keepdim=True)
        occ = (kidx == first_past) & (z[:, None] < max_dist)
        write = free | occ
        new = torch.where(occ, update_code(code, *occ_r), update_code(code, *free_r))
        t, v = tgt[write], new[write]  # lane order: particle, beam, sample
        t_sorted, order = torch.sort(t, stable=True)
        last = torch.ones_like(t_sorted, dtype=torch.bool)
        last[:-1] = t_sorted[1:] != t_sorted[:-1]
        out[t_sorted[last]] = v[order[last]].to(torch.uint8)
    return lw, out.reshape(n, h, w)


def mean_pose(x, y, th):
    """(x, y, heading) of a cloud: the mean position and the circular mean
    heading, in float64."""
    x, y, th = (v.to(torch.float64) for v in (x, y, th))
    return (float(x.mean()), float(y.mean()),
            float(torch.atan2(torch.sin(th).mean(), torch.cos(th).mean())))
