"""Compressed directional distance transform (CDDT) for maps whose dense
beam table outgrows device memory (port of `slam_tpu/ops/cddt.py`).

Per (half-bin, rotated-canvas row) the table stores the sorted obstacle
RUN intervals along the bin's ray direction, i16 [n_bins/2, d, K], where
K is the most runs any row crosses. Bins theta and theta + 180 share one
table: the reverse ray searches the same intervals backward. A query
reads its ray's interval row, then takes a masked min over it (K <= 64)
or runs a fixed-trip binary search (K > 64).

Geometry is the dense build's (`ops/lut.py`: the same rotated canvas of
the 2x2-dilated map, the same cell-center snap), so a query equals the
dense-LUT query except at ulp-level angle ties: the dense quad build
derives bins [n/4, n/2) from the [0, n/4) canvases while this table
evaluates their own angles.

The build runs on `blocked`'s device with no host read inside a pass:
each bin's runs are compacted by a per-row `topk` of the run starts'
columns (every (row, rank) pair comes from exactly one run start, so no
lane collides and none writes a shared slot), the max run count is kept
on the device, and K is read once per pass. Each bin's sin and cos are
taken on the host, so a table built on the card equals the CPU's bit for
bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from slam_tpu_torch.core import grid as gridlib
from slam_tpu_torch.ops import lut as lutlib

_PAD = 32767  # i16 sentinel: beyond any canvas coordinate
# Runs per row the adaptive build guesses before it measures K.
_K_GUESS = 64


@dataclasses.dataclass
class CDDTTable:
    """starts/ends: i16[n_bins//2, d, K] sorted obstacle-run intervals per
    (half-bin, canvas row), padded with _PAD. n_overflow > 0 means some row
    had more than K runs (the tail was dropped: rebuild with a larger K)."""

    starts: torch.Tensor
    ends: torch.Tensor
    n_bins: int = 360
    n_overflow: int = 0

    @property
    def d(self) -> int:
        return self.starts.shape[1]

    @property
    def k(self) -> int:
        return self.starts.shape[2]

    @property
    def nbytes(self) -> int:
        return self.starts.numel() * 2 + self.ends.numel() * 2


def _first_k_columns(mask: torch.Tensor, k: int) -> torch.Tensor:
    """i32[d, k]: per row of a bool[d, d] mask, the columns of its first k
    True entries in order, padded with _PAD."""
    d = mask.shape[1]
    cols = torch.arange(d, dtype=torch.int32, device=mask.device).expand_as(mask)
    keys = torch.where(mask, cols, _PAD)
    first = torch.topk(keys, min(k, d), dim=1, largest=False, sorted=True).values
    if k > d:
        first = torch.nn.functional.pad(first, (0, k - d), value=_PAD)
    return first


def _row_intervals(rot: torch.Tensor, k: int):
    """Per-row obstacle runs of a bool[d, d] canvas -> (starts, ends i32
    [d, k], the most runs in any row, runs dropped by the k cap), the
    counts as 0-d device tensors. The JAX package scatters each run start
    to (row, rank) and every other lane to one dropped slot; here the
    first k starts (and ends) of each row are selected directly."""
    zero = torch.zeros((rot.shape[0], 1), dtype=torch.bool, device=rot.device)
    prev = torch.cat([zero, rot[:, :-1]], dim=1)
    nxt = torch.cat([rot[:, 1:], zero], dim=1)
    rs = rot & ~prev  # run starts
    re = rot & ~nxt  # run ends
    runs_per_row = torch.sum(rs, dim=1, dtype=torch.int32)
    n_max = torch.max(runs_per_row)
    n_dropped = torch.sum(torch.clamp(runs_per_row - k, min=0))
    return _first_k_columns(rs, k), _first_k_columns(re, k), n_max, n_dropped


def build_cddt(blocked, n_bins: int = 360, k: int | None = None) -> CDDTTable:
    """Offline build on `blocked`'s device: n_bins//2 rotated canvases ->
    interval tables. `k` (max runs per row) defaults to adaptive: one pass
    with a guess of 64, trimmed to the measured maximum (rebuilt once at
    the measured maximum when the guess was low)."""
    if n_bins % 2 != 0:
        raise ValueError("cddt needs an even n_bins (half-table sharing)")
    blocked = torch.as_tensor(blocked, dtype=torch.bool)
    dev = blocked.device
    h, w = blocked.shape
    d = int(math.ceil(math.hypot(h, w))) + 2
    if d >= _PAD:
        raise ValueError(
            f"map diagonal {d} overflows the i16 interval coordinates "
            f"(max {_PAD - 1}); cddt tables currently support maps up to "
            "~23k px on a side"
        )
    half = n_bins // 2
    binw = 2.0 * math.pi / n_bins
    dil = lutlib.dilate2x2(blocked)
    adaptive = k is None

    def one_pass(k_try: int):
        starts = torch.empty((half, d, k_try), dtype=torch.int16, device=dev)
        ends = torch.empty_like(starts)
        kmax = torch.zeros((), dtype=torch.int32, device=dev)
        dropped = torch.zeros((), dtype=torch.int64, device=dev)
        for b in range(half):
            # The JAX build's angle: f32(b * binw), the product in f64. It
            # stays a CPU scalar, so its sin and cos are the CPU's on any
            # device and a table built on the card equals the CPU's.
            theta = torch.tensor(np.float32(b * binw))
            rot = lutlib.rotated_blocked_canvas(blocked, theta, d, dil)
            s, e, n, nd = _row_intervals(rot, k_try)
            starts[b] = s
            ends[b] = e
            kmax = torch.maximum(kmax, n)
            dropped += nd
        kmax, dropped = torch.stack([kmax.to(torch.int64), dropped]).tolist()
        return starts, ends, kmax, dropped

    k_try = _K_GUESS if adaptive else k
    starts, ends, kmax, dropped = one_pass(k_try)
    if adaptive and kmax > k_try:
        # Guess was low: one rebuild at the measured maximum.
        starts, ends, kmax, dropped = one_pass(kmax)
    if adaptive:
        kfit = max(kmax, 1)
        starts = starts[:, :, :kfit].contiguous()
        ends = ends[:, :, :kfit].contiguous()
        dropped = 0
    return CDDTTable(starts=starts, ends=ends, n_bins=n_bins, n_overflow=dropped)


def raycast_cddt(table: CDDTTable, x, y, theta, *, max_dist: float = 500.0, shape=None):
    """(dist, hit) with the march/lut conventions, on the table's device.
    `shape` is the (H, W) of the source map (needed for the cell snap)."""
    if shape is None:
        raise ValueError("raycast_cddt needs the source map shape")
    h, w = shape
    d, k, n_bins = table.d, table.k, table.n_bins
    half = n_bins // 2
    if max_dist * 1.25 >= _PAD - d:
        # PAD-as-miss relies on PAD - v > cap for every canvas coordinate.
        raise ValueError(
            f"max_dist {max_dist} too large for this table's i16 headroom "
            f"(needs max_dist * 1.25 < {_PAD - d})"
        )
    dev = table.starts.device
    # Filled on the device: a Python number made a CUDA tensor is a host
    # copy, which a CUDA graph of the step cannot hold.
    cap = torch.full((), max_dist * 1.25, dtype=torch.float32, device=dev)
    ci, cj, cd = (h - 1) / 2.0, (w - 1) / 2.0, (d - 1) / 2.0

    x, y, theta = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (x, y, theta))
    )
    b = lutlib.angle_bin(theta, n_bins)
    fwd = b < half
    bh = torch.where(fwd, b, b - half)

    i, j = gridlib.world_to_cell((h, w), x, y)
    inb = gridlib.in_bounds((h, w), i, j)
    ic, jc = gridlib.clamp_cell((h, w), i, j)

    th = bh.to(torch.float32) * (2.0 * math.pi / n_bins)
    di = -torch.sin(th)
    dj = torch.cos(th)
    ii = ic.to(torch.float32) - ci
    jj = jc.to(torch.float32) - cj
    u_q = ii * dj + jj * (-di) + cd
    v_q = ii * di + jj * dj + cd
    ui = torch.clamp(torch.round(u_q).to(torch.int32), 0, d - 1)
    v = torch.clamp(torch.round(v_q).to(torch.int32), 0, d - 1)

    row = bh.long() * d + ui  # row into the [half*d, K] tables
    starts = table.starts.reshape(-1, k)
    ends = table.ends.reshape(-1, k)

    # Forward (+v): first run with end >= v -> dist = max(start - v, 0).
    # Backward (-v): last run with start <= v -> dist = max(v - end, 0).
    if k <= 64:
        # K-wide scan: one contiguous row gather per direction per ray and
        # a masked min. Runs are disjoint and sorted, so the min over the
        # eligible runs is the first eligible run's distance.
        s_rows = starts[row].to(torch.int32)  # [..., K]
        e_rows = ends[row].to(torch.int32)
        vk = v[..., None]
        pad = torch.full((), _PAD, dtype=torch.int32, device=dev)
        df = torch.where(e_rows >= vk, torch.clamp(s_rows - vk, min=0), pad)
        db = torch.where(s_rows <= vk, torch.clamp(vk - e_rows, min=0), pad)
        dist = torch.minimum(
            torch.where(fwd, df.amin(dim=-1), db.amin(dim=-1)).to(torch.float32), cap)
    else:
        # Fixed-trip binary search: lower_bound(ends, v) forward,
        # upper_bound(starts, v) backward; no host read.
        s_flat, e_flat = starts.reshape(-1), ends.reshape(-1)
        lo = torch.zeros_like(v)
        hi = torch.full_like(v, k)
        for _ in range(max(1, int(math.ceil(math.log2(k + 1))))):
            live = lo < hi
            mid = (lo + hi) // 2
            flat = row * k + torch.clamp(mid, 0, k - 1)
            kv = torch.where(fwd, e_flat[flat], s_flat[flat]).to(torch.int32)
            go_right = torch.where(fwd, kv < v, kv <= v)
            lo = torch.where(live & go_right, mid + 1, lo)
            hi = torch.where(live & ~go_right, mid, hi)
        s_f = s_flat[row * k + torch.clamp(lo, 0, k - 1)].to(torch.float32)
        e_b = e_flat[row * k + torch.clamp(lo - 1, 0, k - 1)].to(torch.float32)
        vf = v.to(torch.float32)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        # lo == k forward (every real run's end < v): no run ahead. PAD
        # starts (short rows) also read as misses via the cap.
        dist_f = torch.where(lo >= k, cap, torch.maximum(s_f - vf, zero))
        dist_b = torch.where(lo >= 1, torch.maximum(vf - e_b, zero), cap)
        dist = torch.minimum(torch.where(fwd, dist_f, dist_b), cap)

    hit = (dist < max_dist) & inb
    return torch.where(hit, dist, torch.full_like(dist, max_dist)), hit
