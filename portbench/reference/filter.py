"""The particle filter's estimate, resampler and wake-up cloud, worked out
again: plain PyTorch of the same semantics as the port's filter.

  estimate     the best particle (the first maximum of the accumulated log
               weights) and the mode pose, the softmax(tau * log w)
               weighted mean with a circular mean of the heading; when the
               measurement is uninformative (half the particles or more
               tie the top score, relative 1e-6) the best pose is the mode
  systematic   low-variance resampling: draw k takes particle i iff
               c_{i-1} <= (k + u0) / n < c_i, the prefix sum c of the
               normalised weights taken in float64; weights reset to
               -log n
  wake-up      every particle at the canvas centre (w/2, h/2, pi/2), then
               replaced where its select draw u < 1 lands on a free cell
               (i, j) by that cell's world point with heading theta, the
               draws u, i, j, theta made in that order
"""

from __future__ import annotations

import math

import numpy as np
import torch


def log_f32(n) -> float:
    out = np.zeros((), np.float32)
    torch.log(torch.tensor(float(n), dtype=torch.float32), out=torch.from_numpy(out))
    return float(out)


def estimate(x, y, th, log_weight, lw, tau: float):
    """((best x, y, theta), (mode x, y, theta), the share of particles that
    tie the top score); informative when that share is under a half."""
    k = torch.argmax(log_weight)
    wm = torch.softmax(log_weight * tau, dim=-1)
    mode = (torch.sum(wm * x), torch.sum(wm * y),
            torch.atan2(torch.sum(wm * torch.sin(th)), torch.sum(wm * torch.cos(th))))
    max_lw = torch.amax(lw)
    tol = torch.clamp(1e-6 * torch.abs(max_lw), min=1e-6)
    tied = float(torch.mean(((max_lw - lw) < tol).to(torch.float32)))
    best = (x[k], y[k], th[k]) if tied < 0.5 else mode
    return best, mode, tied


def systematic(log_weight, u0):
    """Indices int64 [N] of the particles systematic resampling keeps."""
    n = log_weight.shape[-1]
    dev = log_weight.device
    c = torch.cumsum(torch.softmax(log_weight, dim=-1), dim=-1, dtype=torch.float64)
    c = c / c[-1:]
    ends = torch.ceil(n * c - torch.as_tensor(u0, dtype=torch.float32, device=dev)).to(torch.int64)
    counts = torch.diff(ends.clamp(0, n), prepend=torch.zeros(1, dtype=torch.int64, device=dev))
    idx = torch.repeat_interleave(torch.arange(n, device=dev), counts.clamp(min=0))[:n]
    if idx.numel() < n:  # a prefix sum that ends a rounding short of 1
        idx = torch.cat([idx, idx.new_full((n - idx.numel(),), n - 1)])
    return idx


def wake_up(gen: torch.Generator, n: int, blocked: torch.Tensor):
    """(x, y, theta) f32 [n] of a cloud woken up lost on `blocked`."""
    h, w = blocked.shape
    dev = blocked.device
    kw = dict(generator=gen, device=dev)
    u = torch.rand((n,), **kw)
    i = torch.randint(0, h, (n,), dtype=torch.int32, **kw)
    j = torch.randint(0, w, (n,), dtype=torch.int32, **kw)
    theta = torch.rand((n,), **kw) * (2.0 * math.pi) - math.pi
    use = (u < 1.0) & ~blocked[i.long(), j.long()]
    cx, cy, ct = (torch.full((n,), v, dtype=torch.float32, device=dev)
                  for v in (w / 2.0, h / 2.0, math.pi / 2.0))
    return (torch.where(use, j.to(torch.float32), cx), torch.where(use, (h - i).to(torch.float32), cy),
            torch.where(use, theta, ct))
