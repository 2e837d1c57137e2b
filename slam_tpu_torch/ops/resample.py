"""Particle resampling as prefix sums, and augmented-MCL random-particle
injection (port of `slam_tpu/ops/resample.py`).

Random draws come from a `torch.Generator` on the particles' device, or
are injected (`u0=` / `u=` / `draws=`) so tests can feed in JAX's own
draws. The resamplers take log weights [..., N] with any leading batch
axes (a fleet's robots, `models/fleet.py`) and work on the last axis; a
single filter is the 1-D case.
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.core import grid as gridlib
from slam_tpu_torch.core.types import Particles, Pose, log_f32


def normalized_weights(log_w):
    return torch.softmax(log_w, dim=-1)


def effective_sample_size(log_w):
    """ESS = 1 / sum(w_i^2) for normalized w."""
    w = normalized_weights(log_w)
    return 1.0 / torch.sum(w * w, dim=-1)


def multinomial_indices(log_w, *, u=None, generator=None):
    """N independent draws from the weight distribution (the reference's
    `probabilistic_fitness_selection`, `slam/mcl.cpp:157-203`). `u` are
    uniforms in [0, 1), one per particle."""
    n = log_w.shape[-1]
    c = torch.cumsum(normalized_weights(log_w), dim=-1)
    if u is None:
        u = torch.rand(log_w.shape, generator=generator, device=log_w.device)
    u = u * c[..., -1:]
    return torch.clamp(torch.searchsorted(c, u, right=False), 0, n - 1).to(torch.int32)


def systematic_indices(log_w, *, u0=None, generator=None):
    """Low-variance systematic resampling without a binary search.

    Draw k selects particle i iff c_{i-1} <= (k + u0)/n < c_i, so particle
    i's output range is [ceil(n c_{i-1} - u0), ceil(n c_i - u0)). Each
    range offers its particle index at its own start (clamped into [0,
    n)), an empty range offering -1, which never wins; a scatter-max then
    a cumulative max fill the output. No slot collects the empty ranges:
    on CUDA such a slot serializes their atomics. `u0` is one uniform in
    [0, 1) per batch row (a 0-d tensor for a single filter)."""
    n = log_w.shape[-1]
    dev = log_w.device
    # The prefix sum in float64: at 100k+ particles an f32 sum's rounding
    # (~sqrt(N) ulps) moves n * c by whole slots, so any other summation
    # order (CUDA's scan varies its grouping from run to run, and a batch
    # of rows scans in another order than one row) moved ~1% of the
    # indices; in f64 only a draw within ~1e-11 of a bin edge can move.
    c = torch.cumsum(normalized_weights(log_w), dim=-1, dtype=torch.float64)
    c = c / c[..., -1:]
    if u0 is None:
        u0 = torch.rand(log_w.shape[:-1], generator=generator, device=dev)
    u0 = torch.as_tensor(u0, dtype=torch.float32, device=dev)
    ends = torch.ceil(n * c - u0[..., None]).to(torch.int32)
    starts = torch.cat([torch.zeros_like(ends[..., :1]), ends[..., :-1]], dim=-1)
    occupied = ends > starts
    lane = torch.arange(n, dtype=torch.int32, device=dev).expand_as(ends)
    seed = torch.full_like(ends, -1).scatter_reduce(
        -1, torch.clamp(starts, 0, n - 1).long(), torch.where(occupied, lane, -1), "amax"
    )
    idx = torch.cummax(seed, dim=-1).values
    # Guard the (floating-point-edge) case where slot 0 got no seed.
    return torch.clamp(idx, 0, n - 1)


def gather_pose_packed(pose: Pose, idx) -> Pose:
    """pose[..., idx] along the last axis through ONE [*, 3] row gather
    instead of three; idx is [N] or [R, N] (per batch row)."""
    packed = torch.stack([pose.x, pose.y, pose.theta], dim=-1)
    idx = idx.long()
    if idx.dim() == 2:  # rows of robot r start at r * N of the flat view
        idx = idx + idx.shape[1] * torch.arange(idx.shape[0], device=idx.device)[:, None]
    packed = packed.reshape(-1, 3)[idx]
    return Pose(x=packed[..., 0], y=packed[..., 1], theta=packed[..., 2])


def resample(particles: Particles, method: str = "systematic", *, u0=None,
             u=None, generator=None) -> Particles:
    """Select a new particle set and reset weights to uniform."""
    if method == "systematic":
        idx = systematic_indices(particles.log_weight, u0=u0, generator=generator)
    elif method == "multinomial":
        idx = multinomial_indices(particles.log_weight, u=u, generator=generator)
    else:
        raise ValueError(f"unknown resample method: {method}")
    return Particles(
        pose=gather_pose_packed(particles.pose, idx),
        log_weight=torch.full_like(particles.log_weight, -log_f32(particles.n)),
    )


# --------------------------------------------------------------------------
# Augmented MCL (notebook cell 9): fast/slow weight averages, and uniform
# random particles over free space when the fast average collapses.
# --------------------------------------------------------------------------


def update_w_averages(log_w, w_slow, w_fast, alpha_slow=0.1, alpha_fast=0.9):
    """w_slow / w_fast EMAs of the mean unnormalized weight."""
    w_avg = torch.mean(torch.exp(log_w))
    w_slow = w_slow + alpha_slow * (w_avg - w_slow)
    w_fast = w_fast + alpha_fast * (w_avg - w_fast)
    return w_slow, w_fast


def injection_ratio(w_slow, w_fast):
    return torch.clamp(1.0 - w_fast / torch.clamp(w_slow, min=1e-30), min=0.0)


def injection_draws(n: int, shape, *, generator=None, device=None):
    """The four draws of `inject_random_particles`, in JAX's order: the
    select uniform in [0, 1), cell row i in [0, h), column j in [0, w)
    (int32) and heading theta in [-pi, pi), each [n]."""
    h, w = shape
    kw = dict(generator=generator, device=device)
    u = torch.rand((n,), **kw)
    i = torch.randint(0, h, (n,), dtype=torch.int32, **kw)
    j = torch.randint(0, w, (n,), dtype=torch.int32, **kw)
    theta = torch.rand((n,), **kw) * (2.0 * math.pi) - math.pi
    return u, i, j, theta


def inject_random_particles(particles: Particles, blocked: torch.Tensor, ratio, *,
                            draws=None, generator=None) -> Particles:
    """Replace a `ratio` fraction of particles (a float or a 0-d tensor on
    the particles' device) with uniform poses over free space: a particle
    is replaced iff its select draw is below `ratio` AND its drawn cell is
    free, so a draw that lands on a blocked cell keeps the original
    particle (the realized ratio is slightly lower near clutter). `draws`
    injects (u, i, j, theta) as `injection_draws` returns them; with
    particles [R, N] (a fleet) they are [R, N] and `ratio` is [R, 1]."""
    n = particles.n
    h, w = blocked.shape
    if draws is None:
        draws = injection_draws(n, (h, w), generator=generator,
                                device=particles.pose.x.device)
    u, i, j, theta = draws
    free = ~blocked[i.long(), j.long()]
    use = (u < ratio) & free
    x, y = gridlib.cell_to_world((h, w), i, j)
    pp = particles.pose
    return particles.replace(pose=Pose(
        x=torch.where(use, x, pp.x),
        y=torch.where(use, y, pp.y),
        theta=torch.where(use, theta, pp.theta),
    ))
