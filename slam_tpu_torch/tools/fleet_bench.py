"""Multi-robot MCL fleet throughput (port of `benchmarks/fleet_bench.py`).

R independent filters share the synthetic floor plan's 360-bin bf16 LUT
(`utils/maps.synthetic_floor_plan`), each at `--particles` particles, 90
beams over pi, max_dist 500, the scanner 30 px ahead of the pose. On the
card a fleet step is one launch of the fused predict -> weigh kernel with
a robot axis plus the batched estimate and resampler
(`models/fleet.py`), so the step time should grow far slower than R.

    python -m slam_tpu_torch.tools.fleet_bench [--robots 1 4 8 16] [--particles 100000]
    python -m slam_tpu_torch.tools.fleet_bench --robots 2 --particles 2000 --device cpu

Prints one JSON line per R, `fleet_mcl_step_ms_r{R}` (the JAX tool's
name), timed with CUDA events on the card (the host clock on the CPU).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from slam_tpu_torch.core.config import LidarConfig, MCLConfig, RaycastConfig, beam_bin_stride
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import fake_lidar, fleet
from slam_tpu_torch.ops import rayfield
from slam_tpu_torch.ops.measurement import sensor_pose
from slam_tpu_torch.utils.maps import synthetic_floor_plan

ALPHAS = (0.0005, 0.0005, 0.01, 0.01)
ODOM = (2.5, 0.02, 0.02)


def configs(particles: int):
    """(lidar, RaycastConfig, MCLConfig) of `benchmarks/fleet_bench.py:51-59`."""
    lidar = LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="lut")
    cfg = MCLConfig(n_particles=particles, meas_stddev=5.0, scanner_offset=(0.0, 30.0, 0.0),
                    lut_beam_stride=beam_bin_stride(lidar, rc))
    return lidar, rc, cfg


def fleet_inputs(blocked, r: int, lidar, cfg, rng):
    """(start poses [R], odometry [R] on the host, scans [R, B]) of R robots
    spread over the map's open middle band, heading pi, each scanned from
    its start (the JAX tool's setup)."""
    h, w = blocked.shape
    dev = blocked.device
    xs = rng.uniform(300, w - 300, r)
    ys = rng.uniform(200, h - 200, r)
    poses = Pose.create(xs, ys, np.full(r, np.pi), device=dev)
    scans = [fake_lidar.scan(blocked, sensor_pose(Pose.create(float(xs[q]), float(ys[q]), np.pi,
                                                              device=dev), cfg.scanner_offset),
                             lidar, RaycastConfig(max_dist=500.0)) for q in range(r)]
    scans = Scan(angles=torch.stack([s.angles for s in scans]),
                 dists=torch.stack([s.dists for s in scans]))
    odoms = Odometry.create(*([v] * r for v in ODOM))
    return poses, odoms, scans


def time_fleet(fl, field, poses, odoms, scans, iters: int, warmup: int = 3):
    """(ms per fleet step, the final states) after `warmup` steps."""
    dev = poses.x.device
    states = fl.init(poses)
    for _ in range(warmup):
        states = fl.step(states, odoms, scans, field, ALPHAS)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            states = fl.step(states, odoms, scans, field, ALPHAS)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / iters, states
    t0 = time.perf_counter()
    for _ in range(iters):
        states = fl.step(states, odoms, scans, field, ALPHAS)
    return (time.perf_counter() - t0) / iters * 1e3, states


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--robots", type=int, nargs="+", default=[1, 4, 8, 16])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = entry_device(args.device)
    blocked = torch.from_numpy(synthetic_floor_plan()).to(dev)
    lidar, rc, cfg = configs(args.particles)
    field = rayfield.make_ray_field(blocked, rc)
    rng = np.random.default_rng(0)
    for r in args.robots:
        poses, odoms, scans = fleet_inputs(blocked, r, lidar, cfg, rng)
        fl = fleet.MCLFleet(r, cfg, rc, seed=0, device=dev)
        ms, _ = time_fleet(fl, field, poses, odoms, scans, args.iters)
        print(json.dumps({"metric": f"fleet_mcl_step_ms_r{r}", "value": round(ms, 3),
                          "unit": "ms", "device": str(dev)}))
        print(f"# R={r} x {args.particles}: {ms:.2f} ms/fleet-step = {ms / r:.3f} "
              f"ms/robot-step ({r * args.particles / ms * 1e3:,.0f} particle-updates/s)",
              file=sys.stderr)


if __name__ == "__main__":
    main()
