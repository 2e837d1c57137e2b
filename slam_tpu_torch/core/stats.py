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
