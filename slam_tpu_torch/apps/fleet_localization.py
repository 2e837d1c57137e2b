"""Multi-robot localization demo: a fleet of MCL filters on one map (port
of `slam_tpu/apps/fleet_localization.py`, on the CUDA card unless
`--cpu`).

No reference equivalent (the C++ apps run one filter per process,
`apps/grid_slam.cpp`). Every robot's predict + panorama-fused update +
resample advances through `slam_tpu_torch.models.fleet`: on the card with
the lut backend one launch of the fused kernel for the whole fleet, then
the batched estimate and resampler. Each robot wanders independently
(wall-avoiding, like grid_slam's auto driver), localizes against the known
map, and the app reports per-robot ATE and renders all trajectories.

    python -m slam_tpu_torch.apps.fleet_localization --map floor_plan.png \
        --robots 8 --particles 10000 --steps 100 --out fleet.png
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from slam_tpu_torch.apps.common import app_device, load_blocked
from slam_tpu_torch.core.config import (
    LidarConfig,
    MCLConfig,
    RaycastConfig,
    beam_bin_stride,
)
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import fleet, mcl as mcl_mod
from slam_tpu_torch.ops import motion as motion_ops
from slam_tpu_torch.ops import rayfield
from slam_tpu_torch.ops.measurement import sensor_pose
from slam_tpu_torch.ops.raycast import raycast_march
from slam_tpu_torch.utils import render
from slam_tpu_torch.utils.metrics import ate_rmse


def gt_step(blocked, gt: Pose, alphas, trans: float, lidar: LidarConfig, scan_rc, cfg,
            generator):
    """The whole fleet's ground-truth step as one batched function: the
    wall-avoiding wander's odometry (turn where a short march ahead hits),
    the noisy motion, and each robot's scan by the exact march. Returns
    (the new truth [R], the odometry [R] on the device, the scans [R, B])."""
    dev = blocked.device
    _, hit = raycast_march(blocked, gt.x, gt.y, gt.theta,
                           step=1.0, max_dist=4.0 * trans, chunk=8)
    rot = torch.where(hit, 0.6, 0.0)
    odoms = Odometry(rot1=rot, trans=torch.where(hit, trans * 0.4, trans), rot2=rot)
    new_gt = motion_ops.sample_motion_model_odometry(odoms, gt, alphas, generator=generator)
    sp = sensor_pose(new_gt, cfg.scanner_offset)
    angles = torch.tensor(lidar.angles, dtype=torch.float32, device=dev)
    dists, hits = raycast_march(
        blocked, sp.x[:, None], sp.y[:, None], sp.theta[:, None] + angles[None, :],
        step=scan_rc.step, max_dist=lidar.max_dist, chunk=scan_rc.chunk,
    )
    dists = torch.where(hits, dists, torch.full_like(dists, lidar.max_dist))
    return new_gt, odoms, Scan(angles=angles.expand_as(dists).contiguous(), dists=dists)


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-robot MCL fleet demo")
    ap.add_argument("--map", required=True)
    ap.add_argument("--robots", type=int, default=8)
    ap.add_argument("--particles", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--beams", type=int, default=90)
    ap.add_argument("--trans", type=float, default=2.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="fleet.png")
    ap.add_argument("--backend", default="lut", choices=["lut", "sdf", "march"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA card")
    args = ap.parse_args(argv)

    dev = app_device(args.cpu)
    blocked_np = load_blocked(args.map)
    blocked = torch.from_numpy(blocked_np).to(dev)
    h, w = blocked.shape
    lidar = LidarConfig(start=0.0, stop=np.pi, max_dist=500.0, n_rays=args.beams)
    rc = RaycastConfig(step=1.0, max_dist=500.0, backend=args.backend)
    cfg = MCLConfig(
        n_particles=args.particles,
        meas_stddev=5.0,
        lut_beam_stride=(
            beam_bin_stride(lidar, rc) if args.backend == "lut" else None
        ),
    )
    field = rayfield.make_ray_field(blocked, rc)
    alphas = (5e-4, 5e-4, 1e-2, 1e-2)

    # Spawn robots on free cells with a little clearance.
    rng = np.random.default_rng(args.seed)
    ii, jj = np.nonzero(~blocked_np[8:-8, 8:-8])
    picks = rng.choice(len(ii), size=args.robots, replace=False)
    gx = [float(jj[p] + 8) + 0.5 for p in picks]
    gy = [float(h - (ii[p] + 8)) - 0.5 for p in picks]
    gth = [float(rng.uniform(0, 2 * np.pi)) for _ in picks]
    gt = Pose.create(gx, gy, gth, device=dev)

    fl = fleet.MCLFleet(args.robots, cfg, rc, seed=args.seed, device=dev)
    states = fl.init(gt)

    scan_rc = RaycastConfig(max_dist=500.0)
    g_gt = mcl_mod.make_generator(args.seed + 1, dev)
    trails_gt = [[] for _ in range(args.robots)]
    trails_est = [[] for _ in range(args.robots)]
    for _ in range(args.steps):
        gt, odoms, scans = gt_step(blocked, gt, alphas, args.trans, lidar, scan_rc, cfg, g_gt)
        states = fl.step(states, odoms, scans, field, alphas)
        mp = fleet.mean_poses(states)
        both = torch.stack([gt.x, gt.y, mp.x, mp.y]).cpu().numpy()
        for q in range(args.robots):
            trails_gt[q].append([float(both[0, q]), float(both[1, q])])
            trails_est[q].append([float(both[2, q]), float(both[3, q])])

    ates = [
        ate_rmse(np.asarray(trails_est[q]), np.asarray(trails_gt[q]))
        for q in range(args.robots)
    ]
    for q, a in enumerate(ates):
        print(f"robot {q}: ATE {a:.2f}px")
    print(f"fleet mean ATE {np.mean(ates):.2f}px over {args.steps} steps")

    # Render: map + one colored trail per robot (gt thin, estimate solid).
    palette = [
        render.RED, render.GREEN, render.BLUE, render.MAGENTA,
        render.CYAN, render.YELLOW, (255, 128, 0), (128, 0, 255),
    ]
    img = render.blocked_to_rgb(blocked_np)
    for q in range(args.robots):
        color = palette[q % len(palette)]
        faint = tuple(int(0.45 * c + 0.55 * 255) for c in color)
        render.draw_path_world(img, trails_gt[q], faint)
        render.draw_path_world(img, trails_est[q], color)
    render.save_png(img, args.out)
    print(f"wrote {args.out}")
    return np.mean(ates)


if __name__ == "__main__":
    main()
