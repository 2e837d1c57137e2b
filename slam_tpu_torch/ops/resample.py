"""Particle resampling as prefix sums, and augmented-MCL random-particle
injection (port of `slam_tpu/ops/resample.py`).

Random draws come from a `torch.Generator` on the particles' device, or
are injected (`u0=` / `u=` / `draws=`) so tests can feed in JAX's own
draws.
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.core import grid as gridlib
from slam_tpu_torch.core.types import Particles, Pose, log_f32


def normalized_weights(log_w):
    return torch.softmax(log_w, dim=0)


def effective_sample_size(log_w):
    """ESS = 1 / sum(w_i^2) for normalized w."""
    w = normalized_weights(log_w)
    return 1.0 / torch.sum(w * w)


def multinomial_indices(log_w, *, u=None, generator=None):
    """N independent draws from the weight distribution (the reference's
    `probabilistic_fitness_selection`, `slam/mcl.cpp:157-203`). `u` are N
    uniforms in [0, 1)."""
    n = log_w.shape[0]
    c = torch.cumsum(normalized_weights(log_w), dim=0)
    if u is None:
        u = torch.rand((n,), generator=generator, device=log_w.device)
    u = u * c[-1]
    return torch.clamp(torch.searchsorted(c, u, right=False), 0, n - 1).to(torch.int32)


def systematic_indices(log_w, *, u0=None, generator=None):
    """Low-variance systematic resampling without a binary search.

    Draw k selects particle i iff c_{i-1} <= (k + u0)/n < c_i, so particle
    i's output range is [ceil(n c_{i-1} - u0), ceil(n c_i - u0)). Each
    occupied range start is scattered (max of the particle index; empty
    ranges go to a dropped extra slot) and a cumulative max fills the rest.
    `u0` is one uniform in [0, 1) (a 0-d tensor)."""
    n = log_w.shape[0]
    dev = log_w.device
    c = torch.cumsum(normalized_weights(log_w), dim=0)
    c = c / c[-1]
    if u0 is None:
        u0 = torch.rand((), generator=generator, device=dev)
    ends = torch.ceil(n * c - u0).to(torch.int32)
    starts = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev), ends[:-1]])
    occupied = ends > starts
    pos = torch.where(occupied, torch.clamp(starts, 0, n - 1), n).long()
    seed = torch.full((n + 1,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, pos, torch.arange(n, dtype=torch.int32, device=dev), "amax"
    )[:n]
    idx = torch.cummax(seed, dim=0).values
    # Guard the (floating-point-edge) case where slot 0 got no seed.
    return torch.clamp(idx, 0, n - 1)


def gather_pose_packed(pose: Pose, idx) -> Pose:
    """pose[idx] through ONE [N, 3] row gather instead of three."""
    packed = torch.stack([pose.x, pose.y, pose.theta], dim=1)[idx.long()]
    return Pose(x=packed[:, 0], y=packed[:, 1], theta=packed[:, 2])


def resample(particles: Particles, method: str = "systematic", *, u0=None,
             u=None, generator=None) -> Particles:
    """Select a new particle set and reset weights to uniform."""
    if method == "systematic":
        idx = systematic_indices(particles.log_weight, u0=u0, generator=generator)
    elif method == "multinomial":
        idx = multinomial_indices(particles.log_weight, u=u, generator=generator)
    else:
        raise ValueError(f"unknown resample method: {method}")
    n = particles.n
    return Particles(
        pose=gather_pose_packed(particles.pose, idx),
        log_weight=torch.full(
            (n,), -log_f32(n), dtype=particles.log_weight.dtype,
            device=particles.log_weight.device,
        ),
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
    injects (u, i, j, theta) as `injection_draws` returns them."""
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
