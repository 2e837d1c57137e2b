"""Simulated lidar (port of `slam_tpu/models/fake_lidar.py`): one batched
raycast of `n_rays` beams against the ground-truth grid, max-range misses
encoded as dist == max_dist (`slam/fake_lidar.cpp:15-33`,
`apps/grid_slam.cpp:147-166`)."""

from __future__ import annotations

import torch

from slam_tpu_torch.core.config import LidarConfig, RaycastConfig
from slam_tpu_torch.core.types import Pose, Scan
from slam_tpu_torch.ops.raycast import raycast_march


def scan(
    blocked_gt: torch.Tensor,
    pose: Pose,
    cfg: LidarConfig,
    rc: RaycastConfig = RaycastConfig(),
    generator=None,
) -> Scan:
    """Scan the ground-truth map from `pose` (the sensor pose in the world
    frame). Returns a Scan with beam angles relative to the pose heading.
    `cfg.noise_stddev > 0` adds Gaussian range noise from `generator`."""
    dev = blocked_gt.device
    angles = torch.tensor(cfg.angles, dtype=torch.float32, device=dev)  # [B]
    dists, hits = raycast_march(
        blocked_gt, pose.x, pose.y, pose.theta + angles,
        step=rc.step, max_dist=cfg.max_dist, chunk=rc.chunk,
    )
    dists = torch.where(hits, dists, torch.full_like(dists, cfg.max_dist))
    if cfg.noise_stddev > 0.0:
        if generator is None:
            raise ValueError("noise_stddev > 0 requires a generator")
        noise = torch.randn(dists.shape, generator=generator, device=dev)
        noisy = torch.clamp(dists + noise * cfg.noise_stddev, rc.step, cfg.max_dist)
        dists = torch.where(hits, noisy, dists)
    return Scan(angles=angles, dists=dists)
