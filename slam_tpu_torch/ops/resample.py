"""Particle resampling as prefix sums (port of the selection half of
`slam_tpu/ops/resample.py`; adaptive injection is not ported yet).

Random draws come from a `torch.Generator` on the particles' device, or
are injected (`u0=` / `u=`) so tests can feed in JAX's own draws.
"""

from __future__ import annotations

import torch

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
