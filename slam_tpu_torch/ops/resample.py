"""Particle resampling as prefix sums, and augmented-MCL random-particle
injection (port of `slam_tpu/ops/resample.py`).

Random draws come from a `torch.Generator` on the particles' device, or
are injected (`u0=` / `u=` / `draws=`) so tests can feed in JAX's own
draws. The resamplers take log weights [..., N] with any leading batch
axes (a fleet's robots, `models/fleet.py`) and work on the last axis; a
single filter is the 1-D case. A caller that has formed the normalized
weights already (the ESS gate) hands them in (`w=`), so the softmax runs
once.

On a CUDA device the systematic resampler is the kernel chain
`ops/resample_cuda.py` (`csrc/resample.cu`), which also applies a gate
a row on the device; on the CPU it is the plain version below
(`systematic_ends`, then `indices_from_ends`), its reference.
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.core import grid as gridlib
from slam_tpu_torch.core.types import Particles, Pose, log_f32
from slam_tpu_torch.ops import resample_cuda


def normalized_weights(log_w):
    return torch.softmax(log_w, dim=-1)


def effective_sample_size(log_w, *, w=None):
    """ESS = 1 / sum(w_i^2) for normalized w (`w`: `normalized_weights(
    log_w)`, where the caller has formed them)."""
    if w is None:
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


def systematic_ends(w, u0):
    """Particle i's end slot, int32 [..., N], of systematic resampling from
    the normalized weights `w` with the draw `u0` (f32, one a batch row):
    draw k selects particle i iff c_{i-1} <= (k + u0)/n < c_i, so particle
    i's slots are [ceil(n c_{i-1} - u0), ceil(n c_i - u0)), c the prefix
    sum of w over its last value."""
    n = w.shape[-1]
    # The prefix sum in float64: at 100k+ particles an f32 sum's rounding
    # (~sqrt(N) ulps) moves n * c by whole slots, so any other summation
    # order (CUDA's scan varies its grouping from run to run, and a batch
    # of rows scans in another order than one row) moved ~1% of the
    # indices; in f64 only a draw within ~1e-11 of a bin edge can move.
    c = torch.cumsum(w, dim=-1, dtype=torch.float64)
    c = c / c[..., -1:]
    return torch.ceil(n * c - u0[..., None]).to(torch.int32)


def indices_from_ends(ends):
    """The particle of each slot, int32 [..., N], from `systematic_ends`:
    each particle's range offers its index at its own start (clamped into
    [0, n)), an empty range offering -1, which never wins; a scatter-max
    then a cumulative max fill the slots. So slot k takes the largest
    occupied particle that starts at or before k, which is the first
    particle whose end lies past k. No slot collects the empty ranges: on
    CUDA such a slot serializes their atomics."""
    n = ends.shape[-1]
    starts = torch.cat([torch.zeros_like(ends[..., :1]), ends[..., :-1]], dim=-1)
    occupied = ends > starts
    lane = torch.arange(n, dtype=torch.int32, device=ends.device).expand_as(ends)
    seed = torch.full_like(ends, -1).scatter_reduce(
        -1, torch.clamp(starts, 0, n - 1).long(), torch.where(occupied, lane, -1), "amax"
    )
    idx = torch.cummax(seed, dim=-1).values
    # Guard the (floating-point-edge) case where slot 0 got no seed.
    return torch.clamp(idx, 0, n - 1)


def _draw_u0(log_w, u0, generator):
    """`u0` as an f32 tensor on the weights' device, one a batch row, drawn
    from `generator` where not given."""
    if u0 is None:
        u0 = torch.rand(log_w.shape[:-1], generator=generator, device=log_w.device)
    return torch.as_tensor(u0, dtype=torch.float32, device=log_w.device)


def systematic_indices(log_w, *, u0=None, generator=None, w=None):
    """Low-variance systematic resampling: the slot of draw (k + u0)/n
    holds the particle whose prefix-sum interval contains it. `u0` is one uniform in [0, 1) per batch row (a 0-d tensor
    for a single filter); `w` the normalized weights where already formed.
    On a CUDA device the kernel chain (`ops/resample_cuda.py`), on the CPU
    `indices_from_ends(systematic_ends(w, u0))`."""
    if w is None:
        w = normalized_weights(log_w)
    u0 = _draw_u0(log_w, u0, generator)
    if w.is_cuda:
        return resample_cuda.launch(w.contiguous(), u0.contiguous())
    return indices_from_ends(systematic_ends(w, u0))


def gather_pose_packed(pose: Pose, idx) -> Pose:
    """pose[..., idx] along the last axis through ONE [*, 3] row gather
    instead of three; idx is [N] or [R, N] (per batch row)."""
    packed = torch.stack([pose.x, pose.y, pose.theta], dim=-1)
    idx = idx.long()
    if idx.dim() == 2:  # rows of robot r start at r * N of the flat view
        idx = idx + idx.shape[1] * torch.arange(idx.shape[0], device=idx.device)[:, None]
    packed = packed.reshape(-1, 3)[idx]
    return Pose(x=packed[..., 0], y=packed[..., 1], theta=packed[..., 2])


def resample_draws(log_w, method: str, *, u0=None, u=None, generator=None):
    """(u0, u): the draws `resample` would make from `generator` (where not
    given), made now, so a resample under `core/graph.py:cond` draws
    nothing (JAX splits its key before `lax.cond`)."""
    if method == "systematic":
        u0 = _draw_u0(log_w, u0, generator)
    elif method == "multinomial" and u is None:
        u = torch.rand(log_w.shape, generator=generator, device=log_w.device)
    return u0, u


def resample(particles: Particles, method: str = "systematic", *, u0=None,
             u=None, generator=None, w=None, gate=None) -> Particles:
    """Select a new particle set and reset weights to uniform. `w`: the
    normalized weights where already formed (systematic). `gate` (bool, one
    a batch row): the rows where it is False keep their particles; the
    systematic kernel chain on a CUDA device reads it there, elsewhere the
    rows are selected after resampling."""
    lw = particles.log_weight
    if method == "systematic" and lw.is_cuda:
        if w is None:
            w = normalized_weights(lw)
        u0 = _draw_u0(lw, u0, generator)
        pose, new_lw = resample_cuda.launch(
            w.contiguous(), u0.contiguous(),
            gate=None if gate is None else gate.reshape(-1).contiguous(),
            pose=particles.pose, log_weight=lw)
        return Particles(pose=pose, log_weight=new_lw)
    if method == "systematic":
        idx = systematic_indices(lw, u0=u0, generator=generator, w=w)
    elif method == "multinomial":
        idx = multinomial_indices(lw, u=u, generator=generator)
    else:
        raise ValueError(f"unknown resample method: {method}")
    new = Particles(pose=gather_pose_packed(particles.pose, idx),
                    log_weight=torch.full_like(lw, -log_f32(particles.n)))
    if gate is None:
        return new
    g = gate.reshape(lw.shape[:-1])[..., None]
    old, sel = particles.pose, new.pose
    return Particles(
        pose=Pose(x=torch.where(g, sel.x, old.x), y=torch.where(g, sel.y, old.y),
                  theta=torch.where(g, sel.theta, old.theta)),
        log_weight=torch.where(g, new.log_weight, lw))


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
