"""Systematic resampling of a particle-sharded filter without an
[N]-sized all-gather (port of `slam_tpu/parallel/resample.py`).

The plain resampler (`ops/resample.py:systematic_indices`) takes a global
prefix sum and gathers `pose[idx]`; on a sharded particle axis that gather
would need every shard's particles on every rank. Here the only
[N]-sized collective is ONE reduce-scatter, and the prefix sum needs only
an all-gather of the D per-shard sums:

  * particle i (global prefix c_i) owns the output slots
    [ceil(N c_{i-1} - u0), ceil(N c_i - u0)); the ranges partition [0, N),
    so every slot has exactly one writer: the particle whose range starts
    there, or, at a shard's first slot, the one particle whose range
    covers the shard boundary (its carry-in);
  * with one writer per slot a sum equals the write, so the writes of all
    ranks meet in one `psum_scatter` of [D, 4, L] buffers (a written flag
    and x, y, theta; rank t keeps row t, its own slots);
  * a local forward fill (cumulative max of the written slots) copies
    each writer into the rest of its range.

A shard's first range starts where the previous shard's last range ends:
the exclusive prefix of the per-shard sums is accumulated in the same
order in which each shard's last prefix is formed, so the ranges meet
exactly. The prefix sum is in float64, as in the plain resampler.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.core.types import Particles, Pose, log_f32


def _resample_local(ax, lw, x, y, th, u0, n_global: int):
    """One rank's part: [L] local arrays in, the resampled [L] pose out."""
    d, s = ax.size, ax.index
    l = lw.shape[0]
    dev = lw.device

    # Global softmax weights against the global max, then the global
    # prefix: the local f64 cumsum offset by the exclusive prefix of the
    # [D] per-shard sums.
    m = ax.pmax(torch.amax(lw).reshape(1))[0]
    e = torch.exp(lw - m)
    total_e = ax.psum(torch.sum(e).reshape(1))[0]
    wgt = e / total_e
    cs = torch.cumsum(wgt, dim=0, dtype=torch.float64)
    sums = ax.all_gather(cs[-1:])[:, 0]  # [D]
    acc = torch.cumsum(sums, dim=0)
    total = acc[-1]
    prefix = acc[s - 1] if s > 0 else torch.zeros((), dtype=torch.float64, device=dev)
    u0 = torch.as_tensor(u0, dtype=torch.float32, device=dev)
    ends = torch.ceil(n_global * ((prefix + cs) / total) - u0).to(torch.int64)
    first = torch.ceil(n_global * (prefix / total) - u0).to(torch.int64).reshape(1)
    starts = torch.cat([first, ends[:-1]])
    starts = starts.clamp(0, n_global)
    ends = ends.clamp(0, n_global)
    occupied = ends > starts

    # Writes into the [D * L] = [N] slots; an empty range writes a drop
    # slot of its own past them (no slot collects the empty ranges: on
    # CUDA such a slot serializes their stores).
    lane = torch.arange(l, device=dev)
    buf = torch.zeros((4, n_global + l), dtype=torch.float32, device=dev)
    pos = torch.where(occupied, starts, n_global + lane)
    vals = torch.stack([torch.ones_like(x), x, y, th])  # [4, L]
    buf[:, pos] = vals
    # Carry-ins: the particle whose range strictly covers shard t's first
    # slot t * L writes it.
    bounds = torch.arange(d, device=dev, dtype=torch.int64) * l  # [D]
    covers = (starts[:, None] < bounds[None, :]) & (ends[:, None] > bounds[None, :])  # [L, D]
    has = covers.any(dim=0)
    src = torch.argmax(covers.to(torch.uint8), dim=0)
    cpos = torch.where(has, bounds, n_global)
    cval = torch.where(has[None, :], vals[:, src], 0.0)
    buf[:, cpos] = cval
    # A slot has one writer over all ranks; the drop slots stay here.
    buf = buf[:, :n_global].reshape(4, d, l).transpose(0, 1)  # [D, 4, L]

    mine = ax.psum_scatter(buf)  # [4, L]: this shard's slots

    written = mine[0] > 0
    src_slot = torch.cummax(torch.where(written, lane, -1), dim=0).values.clamp(min=0)
    return mine[1][src_slot], mine[2][src_slot], mine[3][src_slot]


def systematic_resample_sharded(mesh, particles: Particles, *, u0=None, generator=None,
                                axis: str = "p", n_global=None) -> Particles:
    """Sharded counterpart of `ops.resample.resample(particles,
    "systematic")`: this rank's particles are shard `index` of the
    `axis` of `mesh`, L each, N = D * L in all (`n_global`). `u0` injects
    the draw; otherwise it is drawn from `generator`, which every rank
    holds in the same state, as the plain resampler draws it. Returns the
    rank's resampled shard with uniform weights -log(N)."""
    ax = mesh.axis(axis)
    lw = particles.log_weight
    l = lw.shape[0]
    n = ax.size * l if n_global is None else int(n_global)
    if n != ax.size * l:
        raise ValueError(f"{n} particles do not split into {ax.size} shards of {l}")
    if u0 is None:
        u0 = torch.rand((), generator=generator, device=lw.device)
    p = particles.pose
    fx, fy, fth = _resample_local(ax, lw, p.x, p.y, p.theta, u0, n)
    return Particles(
        pose=Pose(x=fx, y=fy, theta=fth),
        log_weight=torch.full_like(lw, -log_f32(n)),
    )
