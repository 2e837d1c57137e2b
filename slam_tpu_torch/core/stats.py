"""Distributions, angle math and pose statistics (port of
`slam_tpu/core/stats.py`)."""

from __future__ import annotations

import math

import torch

_SQRT_2PI = 2.5066282746310002


def pdf_normal(stddev, x):
    """N(0, stddev^2) density (`slam/util.cpp:9-13`)."""
    z = x / stddev
    return torch.exp(-0.5 * z * z) / (stddev * _SQRT_2PI)


def pdf_normal_clamp(stddev, x, multiple_stddev=4.0):
    """Density clamped to zero beyond `multiple_stddev` sigmas
    (`slam/util.cpp:15-19`)."""
    return torch.where(
        torch.abs(x) > multiple_stddev * stddev,
        torch.zeros((), dtype=x.dtype, device=x.device),
        pdf_normal(stddev, x),
    )


def log_pdf_normal_clamp_eps(stddev, x, eps, multiple_stddev=4.0):
    """log(pdf_normal_clamp(stddev, x) + eps): the per-beam weight factor of
    the reference measurement model (`slam/raycast.cpp:225-242`)."""
    return torch.log(pdf_normal_clamp(stddev, x, multiple_stddev) + eps)


def pdf_triangular(stddev, x):
    """Triangular density (`slam/util.cpp:21-25`)."""
    var = stddev * stddev
    peak = 1.0 / torch.sqrt(torch.tensor(6 * var, dtype=torch.float32))  # f32, as JAX
    return torch.clamp(peak.to(x.device) - torch.abs(x) / (6 * var), min=0.0)


def sample_normal(stddev, shape=(), *, generator=None, device=None, noise=None):
    """Zero-mean Gaussian sample(s); `stddev` may broadcast against
    `shape`. `noise` injects the standard-normal draws."""
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    return noise * stddev


def sample_triangular(stddev, shape=(), *, generator=None, device=None, u=None):
    """Triangular sample(s) (`slam/util.cpp:36-43`): sqrt(6)/2 * u1 + u2
    with u_i ~ U(-stddev, stddev). `u` = (u1, u2) injects the two
    U(-1, 1) draws."""
    if u is None:
        u = tuple(torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0
                  for _ in range(2))
    u1, u2 = (v * stddev for v in u)
    return math.sqrt(6.0) / 2.0 * u1 + u2


def random_cell(shape, *, generator=None, device=None):
    """Uniform random (i, j) cell over the half-open [0, h) x [0, w), the
    analogue of `slam/util.cpp:53-64`: two int32 0-d tensors."""
    h, w = shape[0], shape[1]
    kw = dict(dtype=torch.int32, generator=generator, device=device)
    return torch.randint(0, h, (), **kw), torch.randint(0, w, (), **kw)


def normalize_angle(angle):
    """Wrap to [-pi, pi) with a floored modulo (`jnp.mod`'s semantics, which
    `torch.remainder` shares and `torch.fmod` does not)."""
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def average_pose(x, y, theta, weights=None):
    """Mean position + circular-mean heading (`slam/util.cpp:66-85`);
    pass `weights` for a weighted variant. Returns (x, y, theta) 0-d
    tensors."""
    if weights is None:
        ax = torch.mean(x)
        ay = torch.mean(y)
        cx = torch.mean(torch.cos(theta))
        cy = torch.mean(torch.sin(theta))
    else:
        w = weights / torch.sum(weights)
        ax = torch.sum(w * x)
        ay = torch.sum(w * y)
        cx = torch.sum(w * torch.cos(theta))
        cy = torch.sum(w * torch.sin(theta))
    return ax, ay, torch.atan2(cy, cx)
