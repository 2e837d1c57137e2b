"""RBPF fidelity mode at scale: per-particle maps on the floor plan (port of
`tools/rbpf_fidelity.py`).

The reference's exact algorithm (`slam/pose.h:32-37` Particle{pose,
weight, map}, `slam/mcl.cpp:49-77` fused weight and map update,
`slam/mcl.cpp:205-227` map copies on resample) keeps one 599 x 1297 map a
particle. This tool runs the port's RBPF (`models/rbpf.py`, maps
resampled by one batched gather) at `--particles` N along the C++
harness's deterministic wander (rot1 0.01, trans 2.5, rot2 0.01 a step;
scans are exact marches off the true map) and prints ATE and step time.
The map is `--map` (a PNG, 0 = obstacle), else the synthetic floor plan;
the start is the canvas center, or the free cell nearest it.

    python -m slam_tpu_torch.tools.rbpf_fidelity --particles 1000 --steps 120
    python -m slam_tpu_torch.tools.rbpf_fidelity --particles 16 --steps 5 --device cpu

A step is timed on the host clock with a device sync after it (the JAX
tool's per-step fence); the first two steps are left out.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from slam_tpu_torch.core.config import LidarConfig, MCLConfig, RaycastConfig
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Odometry, Pose
from slam_tpu_torch.models import fake_lidar, rbpf
from slam_tpu_torch.ops.measurement import sensor_pose
from slam_tpu_torch.utils.maps import load_binary_map, synthetic_floor_plan
from slam_tpu_torch.utils.metrics import ate_rmse


def start_xy(blocked: np.ndarray) -> tuple:
    """World (x, y) of the canvas center, or of the free cell nearest it
    where the center is blocked."""
    h, w = blocked.shape
    ci, cj = int(math.floor(h - h / 2.0 - 1.0)), int(math.floor(w / 2.0))
    if not blocked[ci, cj]:
        return w / 2.0, h / 2.0
    free = np.argwhere(~blocked)
    ci, cj = (int(v) for v in free[np.argmin((free[:, 0] - ci) ** 2 + (free[:, 1] - cj) ** 2)])
    return float(cj) + 0.5, float(h - ci) - 1.5  # the cell (ci, cj) under world_to_cell


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run(blocked: np.ndarray, particles: int, steps: int, seed: int = 0, device=None) -> dict:
    """The JAX tool's loop on `blocked` (bool[H, W]); returns its JSON
    record."""
    dev = entry_device(device)
    h, w = blocked.shape
    blocked_t = torch.from_numpy(np.asarray(blocked, bool)).to(dev)
    cfg = MCLConfig(n_particles=particles, meas_stddev=5.0, scanner_offset=(0.0, 30.0, 0.0),
                    resample="systematic")
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="march")
    lidar = LidarConfig(start=0.0, stop=2 * math.pi, max_dist=500.0, n_rays=90)

    engine = rbpf.RBPF(cfg, rc, seed=seed, device=dev)
    x0, y0 = start_xy(np.asarray(blocked, bool))
    state = engine.init(Pose.create(x0, y0, math.pi / 2, device=dev), (h, w))
    odom = Odometry.create(0.01, 2.5, 0.01)
    gt = [x0, y0, math.pi / 2]
    est, gts = [], []
    t_total, t0_all = 0.0, time.perf_counter()
    for t in range(steps):
        th1 = gt[2] + 0.01
        gt = [gt[0] + 2.5 * math.cos(th1), gt[1] + 2.5 * math.sin(th1), th1 + 0.01]
        sp = sensor_pose(Pose.create(*gt, device=dev), cfg.scanner_offset)
        scan = fake_lidar.scan(blocked_t, sp, lidar, rc)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state = engine.step(state, odom, scan)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if t >= 2:
            t_total += time.perf_counter() - t0
        mp = rbpf.mean_pose(state)
        est.append([float(mp.x), float(mp.y)])
        gts.append(gt[:2])
    ate = ate_rmse(np.asarray(est), np.asarray(gts))
    per_step = t_total / max(1, steps - 2)
    return {"ate_px": round(float(ate), 3), "ms_per_step": round(per_step * 1e3, 1),
            "particles": particles, "steps": steps, "device": device_name(dev),
            "map": [h, w], "total_s": time.perf_counter() - t0_all}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--particles", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--map", default=None, help="map PNG (the synthetic floor plan if absent)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true", help="emit one machine-readable JSON line")
    args = ap.parse_args(argv)

    blocked = (load_binary_map(args.map) == 0) if args.map else synthetic_floor_plan()
    rec = run(blocked, args.particles, args.steps, args.seed,
              "cpu" if args.cpu else args.device)
    h, w = rec["map"]
    per = rec["ms_per_step"] / 1e3
    print(f"RBPF fidelity: {args.particles} particles x {args.steps} steps on {h}x{w} map "
          f"({rec['device']}): ATE {rec['ate_px']:.2f}px, {rec['ms_per_step']:.0f} ms/step "
          f"({args.particles / max(per, 1e-9):,.0f} particle-updates/s), "
          f"total {rec['total_s']:.0f}s")
    if args.json:
        print(json.dumps({k: rec[k] for k in ("ate_px", "ms_per_step", "particles", "steps",
                                               "device")}))
    return rec


if __name__ == "__main__":
    main()
