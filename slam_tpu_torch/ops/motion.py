"""Odometry motion model (port of `slam_tpu/ops/motion.py`).

`sample_motion_model_odometry` is the plain PyTorch version of the CUDA
motion kernel (`ops/motion_cuda.py`) and the CPU path of `mcl.predict`.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.core.stats import normalize_angle
from slam_tpu_torch.core.types import Odometry, Pose


def sample_motion_model_odometry(
    odom: Odometry, pose: Pose, alphas, *, noise=None, generator=None
) -> Pose:
    """Sample next pose(s) under the odometry motion model
    (`slam/motion.cpp:9-32`): perturb (rot1, trans, rot2) with zero-mean
    Gaussians whose stddevs are alpha-weighted mixes of the commanded
    motion, then integrate.

    `noise` = (n1, n2, n3), three standard-normal tensors of the pose batch
    shape; when None they are drawn from `generator`.
    """
    a0, a1, a2, a3 = (float(a) for a in alphas)
    if noise is None:
        shape, dev = pose.x.shape, pose.x.device
        noise = tuple(
            torch.randn(shape, generator=generator, device=dev) for _ in range(3)
        )
    n1, n2, n3 = noise

    r1, t, r2 = odom.rot1, odom.trans, odom.rot2
    std_r1 = torch.sqrt(a0 * r1 * r1 + a1 * t * t)
    std_t = torch.sqrt(a2 * t * t + a3 * (r1 * r1 + r2 * r2))
    std_r2 = torch.sqrt(a0 * r2 * r2 + a1 * t * t)

    rot1 = r1 - n1 * std_r1
    trans = t - n2 * std_t
    rot2 = r2 - n3 * std_r2

    x = pose.x + trans * torch.cos(pose.theta + rot1)
    y = pose.y + trans * torch.sin(pose.theta + rot1)
    theta = normalize_angle(pose.theta + rot1 + rot2)
    return Pose(x=x, y=y, theta=theta)
