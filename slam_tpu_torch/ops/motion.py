"""Probabilistic motion models (port of `slam_tpu/ops/motion.py`): the
odometry and velocity samplers, the inverse odometry model and the
odometry density (Thrun et al., Probabilistic Robotics ch. 5).

`sample_motion_model_odometry` is the plain PyTorch version of the CUDA
motion kernel (`ops/motion_cuda.py`) and the CPU path of `mcl.predict`.
Samplers draw from a `torch.Generator`, or take their standard-normal
draws injected (`noise=`).
"""

from __future__ import annotations

import torch

from slam_tpu_torch.core.stats import normalize_angle, pdf_normal
from slam_tpu_torch.core.types import Odometry, Pose, Velocity


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
    n1, n2, n3 = _normals(pose, noise, generator)

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


def _normals(pose: Pose, noise, generator):
    if noise is not None:
        return noise
    shape, dev = pose.x.shape, pose.x.device
    return tuple(torch.randn(shape, generator=generator, device=dev) for _ in range(3))


def sample_motion_model_velocity(
    vel: Velocity, pose: Pose, dt, alphas, *, noise=None, generator=None
) -> Pose:
    """Sample next pose(s) under the velocity motion model
    (`slam/motion.cpp:34-56`'s noise structure, w == 0 guarded) with the
    textbook arc integration x' = x - v/w sin(th) + v/w sin(th + w dt)
    (Thrun table 5.3). `noise` = three standard-normal tensors (v, w,
    gamma) of the pose batch shape."""
    a0, a1, a2, a3, a4, a5 = (float(a) for a in alphas)
    n1, n2, n3 = _normals(pose, noise, generator)
    v0, w0 = vel.v, vel.w
    v = v0 + n1 * torch.sqrt(a0 * v0 * v0 + a1 * w0 * w0)
    w = w0 + n2 * torch.sqrt(a2 * w0 * w0 + a3 * v0 * v0)
    gamma = n3 * torch.sqrt(a4 * v0 * v0 + a5 * w0 * w0)
    r = v / torch.where(w == 0, 1e-6, w)
    th = pose.theta
    x = pose.x - r * torch.sin(th) + r * torch.sin(th + w * dt)
    y = pose.y + r * torch.cos(th) - r * torch.cos(th + w * dt)
    return Pose(x=x, y=y, theta=normalize_angle(th + w * dt + gamma * dt))


def odometry_from_poses(prev: Pose, curr: Pose) -> Odometry:
    """Inverse odometry model: (rot1, trans, rot2) from a pose pair."""
    dx = curr.x - prev.x
    dy = curr.y - prev.y
    trans = torch.sqrt(dx * dx + dy * dy)
    rot1 = normalize_angle(torch.atan2(dy, dx) - prev.theta)
    rot2 = normalize_angle(curr.theta - prev.theta - rot1)
    return Odometry(rot1=rot1, trans=trans, rot2=rot2)


def motion_model_odometry_density(odom: Odometry, prev: Pose, curr: Pose, alphas):
    """p(curr | prev, odom) under the odometry model (Thrun table 5.5)."""
    a0, a1, a2, a3 = (float(a) for a in alphas)
    hat = odometry_from_poses(prev, curr)
    r1, t, r2 = (torch.as_tensor(v, dtype=torch.float32, device=prev.x.device)
                 for v in (odom.rot1, odom.trans, odom.rot2))
    p1 = pdf_normal(torch.sqrt(a0 * r1 * r1 + a1 * t * t) + 1e-12,
                    normalize_angle(r1 - hat.rot1))
    p2 = pdf_normal(torch.sqrt(a2 * t * t + a3 * (r1 * r1 + r2 * r2)) + 1e-12,
                    t - hat.trans)
    p3 = pdf_normal(torch.sqrt(a0 * r2 * r2 + a1 * t * t) + 1e-12,
                    normalize_angle(r2 - hat.rot2))
    return p1 * p2 * p3
