"""Full grid SLAM on a maze: unknown map, mapping every step (port of
`benchmarks/maze_slam_bench.py`).

Big-map SLAM: the map changes every scan, so the step rebuilds its EDT
(the static-map tables of `maze_bench.py` do not apply), and the
likelihood-field measurement casts no rays in the update. The maze is
`--map` (a PNG, 0 = obstacle), else the JAX tool's 1024 px fallback: a
border and 3% random blocked cells from seed 0.

    python -m slam_tpu_torch.tools.maze_slam_bench [--particles 10000] [--steps 40]
    python -m slam_tpu_torch.tools.maze_slam_bench --measurement likelihood_field,likelihood_field_table:128
    python -m slam_tpu_torch.tools.maze_slam_bench --particles 64 --steps 4 --device cpu

`--measurement` is a comma list of tiers run in one process; a `:N`
suffix sets `lf_table_box`, a `:eN` suffix `SLAMConfig.edt_box` (e.g.
``likelihood_field_table:128:e1024``). Each tier prints one JSON line with
the JAX tool's keys: `value` is the pipelined step time (10 steps
enqueued back to back over two alternating scans, one sync after them),
`per_step_fenced_ms` the time of a step with a sync after every step
(the first two left out), `ate_px` the closed-loop ATE over `--steps`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from slam_tpu_torch.core.config import (
    LidarConfig,
    MapConfig,
    MCLConfig,
    MotionConfig,
    RaycastConfig,
    SLAMConfig,
)
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Odometry, Pose
from slam_tpu_torch.models import fake_lidar
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.models import slam as slam_mod
from slam_tpu_torch.ops import motion
from slam_tpu_torch.ops.measurement import sensor_pose
from slam_tpu_torch.tools.maze_bench import find_start
from slam_tpu_torch.utils.maps import load_binary_map
from slam_tpu_torch.utils.metrics import ate_rmse

ALPHAS = (5e-4, 5e-4, 1e-2, 1e-2)
PIPELINED_ITERS = 10


def fallback_maze(size: int = 1024) -> np.ndarray:
    """bool[size, size]: the JAX tool's stand-in when the maze PNG is
    absent (`benchmarks/maze_slam_bench.py:68-73`)."""
    rng = np.random.default_rng(0)
    blocked = np.ones((size, size), bool)
    blocked[8:-8, 8:-8] = rng.random((size - 16, size - 16)) > 0.97
    return blocked


def parse_tier(label: str):
    """(measurement, lf_table_box, edt_box) of a `--measurement` entry."""
    parts = label.split(":")
    table_box = edt_box = None
    for mod in parts[1:]:
        if mod.startswith("e"):
            edt_box = int(mod[1:])
        elif mod:
            table_box = int(mod)
    return parts[0], table_box, edt_box


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_tier(blocked: np.ndarray, label: str, particles: int, steps: int, device=None) -> dict:
    """One tier on `blocked` (bool[H, W]): the JAX tool's JSON record."""
    dev = entry_device(device)
    h, w = blocked.shape
    blocked_t = torch.from_numpy(np.asarray(blocked, bool)).to(dev)
    meas, table_box, edt_box = parse_tier(label)
    lidar = LidarConfig(start=0.0, stop=2 * np.pi, max_dist=500.0, n_rays=90)
    cfg = SLAMConfig(
        mcl=MCLConfig(n_particles=particles, meas_stddev=5.0, measurement=meas,
                      lf_table_box=table_box),
        map=MapConfig(height=h, width=w),
        lidar=lidar,
        motion=MotionConfig(alphas=ALPHAS),
        raycast=RaycastConfig(step=1.0, max_dist=500.0, backend="sdf"),
        edt_box=edt_box,
    )
    scan_rc = RaycastConfig(max_dist=500.0)
    sx, sy = find_start(np.asarray(blocked, bool), dev)
    odom = Odometry.create(0.02, 2.0, 0.02)
    engine = slam_mod.GridSLAM(cfg, seed=0, device=dev)
    gt = Pose.create(sx, sy, 0.9, device=dev)
    state = engine.init(gt)
    # The truth's motion noise: its own generator, seeded as the JAX tool's
    # key (its draws are Philox's, not JAX's).
    truth_gen = mcl_mod.make_generator(3, dev)

    def scan_at(pose):
        return fake_lidar.scan(blocked_t, sensor_pose(pose, cfg.mcl.scanner_offset), lidar,
                               scan_rc)

    est, gts = [], []
    t_meas = 0.0
    for t in range(steps):
        gt = motion.sample_motion_model_odometry(odom, gt, cfg.motion.alphas,
                                                 generator=truth_gen)
        scan = scan_at(gt)
        _sync(dev)
        t0 = time.perf_counter()
        state = engine.step(state, odom, scan)
        _sync(dev)
        if t >= 2:
            t_meas += time.perf_counter() - t0
        mp = mcl_mod.mean_pose(state.mcl)
        est.append([float(mp.x), float(mp.y)])
        gts.append([float(gt.x), float(gt.y)])
    ate = ate_rmse(np.asarray(est), np.asarray(gts))
    per = t_meas / max(1, steps - 2)

    # Steady state, pipelined: two scans from slightly different poses,
    # alternated, so the map keeps flipping boundary cells (one repeated
    # scan converges the map and lets an incremental EDT skip its work).
    gt2 = Pose.create(float(gt.x) + 3.0, float(gt.y) + 3.0, float(gt.theta) + 0.05, device=dev)
    scans = [scan_at(p) for p in (gt, gt2)]
    st = engine.step(state, odom, scans[0])
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(PIPELINED_ITERS):
        st = engine.step(st, odom, scans[i % 2])
    _sync(dev)
    pipe = (time.perf_counter() - t0) / PIPELINED_ITERS
    return {"metric": f"maze_slam_step_ms_{particles}", "measurement": label,
            "value": round(pipe * 1e3, 2), "unit": "ms",
            "per_step_fenced_ms": round(per * 1e3, 2), "ate_px": round(float(ate), 2),
            "map": [h, w], "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu"}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--particles", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--map", default=None, help="maze PNG (the 1024 px fallback if absent)")
    ap.add_argument("--measurement", default="likelihood_field",
                    help="comma list of tiers; :N sets lf_table_box, :eN edt_box")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    blocked = (load_binary_map(args.map) == 0) if args.map else fallback_maze()
    recs = []
    for label in args.measurement.split(","):
        rec = run_tier(blocked, label, args.particles, args.steps,
                       "cpu" if args.cpu else args.device)
        recs.append(rec)
        print(json.dumps({k: rec[k] for k in ("metric", "measurement", "value", "unit",
                                              "per_step_fenced_ms", "ate_px")}), flush=True)
        h, w = rec["map"]
        print(f"# maze SLAM {h}x{w} [{label}]: {args.particles} particles x {args.steps} "
              f"steps, {rec['value']:.1f} ms/step pipelined ({1e3 / rec['value']:.1f} Hz; "
              f"{rec['per_step_fenced_ms']:.0f} ms with a sync after every step), ATE "
              f"{rec['ate_px']:.2f}px on {rec['device']}", file=sys.stderr)
    return recs


if __name__ == "__main__":
    main()
