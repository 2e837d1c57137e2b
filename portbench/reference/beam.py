"""The beam measurement on a directional distance table, worked out again
from the map: the table's entries and each particle's log weight.

The table (`lut[i, j, b]`, bins last): the distance from the centre of
cell (i, j) to the first blocked cell along angular bin b, taken on a
canvas rotated to the bin's direction that samples the map dilated by
2 x 2 (a cell counts as blocked where any of the four cells around the
sampled point is), capped at 1.25 max_dist and stored in bfloat16 (or as
an 8-bit code of step cap / 255). Bin b's canvas also serves bins b + 90,
b + 180 and b + 270 degrees (scans along -u, -v and +u). The bin angle is
float32(b) * (2 pi / n) with its sine and cosine taken on the host.

A particle's weight: its sensor pose (the mounting offset as a
displacement), the sensor's cell, the first beam's bin s = round((theta
+ a_0) / binw) mod n, beam k's value at bin (s + g k) mod n; a hit is a
value under max_dist in a cell on the map; the beam's term is log(pdf +
eps) of the clamped Gaussian of (value - range) on a hit, of (range -
max_dist) otherwise (upstream `slam/raycast.cpp:225-242`); the weight is
their sum.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SQRT_2PI = math.sqrt(2.0 * math.pi)


def _iota(d0, d1, axis, dev):
    v = torch.arange((d0, d1)[axis], dtype=torch.float32, device=dev)
    return (v[:, None] if axis == 0 else v[None, :]).expand(d0, d1)


def _dilate(blocked):
    a = blocked.clone()
    a[:-1, :] |= blocked[1:, :]
    b = a.clone()
    b[:, :-1] |= a[:, 1:]
    return b


def _encode(run, dtype, max_dist):
    if dtype == torch.uint8:
        q = torch.full((), float(np.float32(max_dist * 1.25) * (np.float32(1.0) / np.float32(255.0))),
                       dtype=torch.float32, device=run.device)
        return torch.clamp(torch.floor(run / q), 0.0, 255.0).to(torch.uint8)
    return run.to(dtype)


def table(blocked: torch.Tensor, n_bins: int, max_dist: float, dtype) -> torch.Tensor:
    """[H, W, n_bins] table of the bool map `blocked` (n_bins % 4 == 0)."""
    dev = blocked.device
    h, w = blocked.shape
    d = int(math.ceil(math.hypot(h, w))) + 2
    cap = torch.tensor(max_dist * 1.25, dtype=torch.float32, device=dev)
    ci, cj, cd = (h - 1) / 2.0, (w - 1) / 2.0, (d - 1) / 2.0
    ucol, vcol = _iota(d, d, 0, dev), _iota(d, d, 1, dev)
    ii, jj = _iota(h, w, 0, dev) - ci, _iota(h, w, 1, dev) - cj
    uu, vv = ucol - cd, vcol - cd
    dil = _dilate(blocked.bool())
    big = float(1 << 20)
    n4 = n_bins // 4
    out = torch.empty((h, w, n_bins), dtype=dtype, device=dev)
    for b in range(n4):
        theta = torch.tensor(b, dtype=torch.float32) * (2.0 * math.pi / n_bins)
        di, dj = (-torch.sin(theta)).to(dev), torch.cos(theta).to(dev)
        fi = ci + uu * dj + vv * di
        fj = cj + uu * (-di) + vv * dj
        i, j = torch.floor(fi).to(torch.int32), torch.floor(fj).to(torch.int32)
        inb = (i >= 0) & (i < h) & (j >= 0) & (j < w)
        canvas = dil.reshape(-1)[i.clamp(0, h - 1).long() * w + j.clamp(0, w - 1).long()] & inb
        ui = torch.round(ii * dj + jj * (-di) + cd).to(torch.int32).clamp(0, d - 1).long()
        vi = torch.round(ii * di + jj * dj + cd).to(torch.int32).clamp(0, d - 1).long()
        v_fwd = torch.where(canvas, vcol, big)
        v_bwd = torch.where(canvas, vcol, -big)
        u_fwd = torch.where(canvas, ucol, big)
        u_bwd = torch.where(canvas, ucol, -big)
        runs = (
            torch.flip(torch.cummin(torch.flip(v_fwd, (1,)), 1).values, (1,)) - vcol,
            ucol - torch.cummax(u_bwd, 0).values,
            vcol - torch.cummax(v_bwd, 1).values,
            torch.flip(torch.cummin(torch.flip(u_fwd, (0,)), 0).values, (0,)) - ucol,
        )
        at = ui * d + vi
        for q, run in enumerate(runs):
            out[:, :, q * n4 + b] = _encode(torch.minimum(run, cap), dtype, max_dist).reshape(-1)[at]
    return out


def sensor(x, y, th, offset):
    ox, oy, rot = offset
    d, a = math.hypot(ox, oy), math.atan2(oy, ox)
    return x + torch.cos(th + a) * d, y + torch.sin(th + a) * d, th + rot


def log_weights(lut, x, y, th, dists, angle0: float, *, offset, beam_stride: int,
                max_dist: float, stddev: float, eps: float, chunk: int = 1 << 18):
    """f32 [N] log weights of poses (x, y, th) against one scan (ranges
    `dists` [B], first beam at `angle0` from the heading)."""
    h, w, n_bins = lut.shape
    dev = lut.device
    f = np.float32
    inv_std = float(f(1.0) / f(stddev))
    inv_norm = float(f(1.0) / f(stddev * _SQRT_2PI))
    clamp = float(f(4.0 * stddev))
    q = float(max_dist) * 1.25 / 255.0 if lut.dtype == torch.uint8 else None
    binw = torch.tensor(float(f(2.0 * math.pi / n_bins)), dtype=torch.float32, device=dev)
    z = dists.to(dev, torch.float32)
    k = torch.arange(z.shape[0], device=dev) * beam_stride
    flat_lut = lut.reshape(h * w, n_bins)
    out = []
    for c0 in range(0, x.shape[0], chunk):
        sx, sy, st = sensor(x[c0:c0 + chunk], y[c0:c0 + chunk], th[c0:c0 + chunk], offset)
        i = torch.floor(h - sy - 1.0).to(torch.int32)
        j = torch.floor(sx).to(torch.int32)
        inb = (i >= 0) & (i < h) & (j >= 0) & (j < w)
        row = i.clamp(0, h - 1).long() * w + j.clamp(0, w - 1).long()
        s = torch.remainder(torch.round((st + float(angle0)) / binw).to(torch.int64), n_bins)
        bins = torch.remainder(s[:, None] + k[None, :], n_bins)
        raw = flat_lut[row[:, None], bins].to(torch.float32)
        pred = raw if q is None else (raw + 0.5) * q
        hit = (pred < max_dist) & inb[:, None]
        err = torch.where(hit, pred - z[None, :], z[None, :] - max_dist)
        zz = err * inv_std
        pdf = torch.where(torch.abs(err) > clamp, 0.0, torch.exp((-0.5 * zz) * zz) * inv_norm)
        out.append(torch.sum(torch.log(pdf + eps), dim=1))
    return torch.cat(out)
