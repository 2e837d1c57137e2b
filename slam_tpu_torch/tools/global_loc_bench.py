"""Global localization on the synthetic floor plan: the port of
`tools/global_loc_bench.py` (its configuration, lines 63-110).

Particles start uniform over the plan's free cells with uniform headings
(`mcl.init_uniform`) and weigh against the known map through the 360-bin
bf16 LUT (on CUDA, one launch of `csrc/lut_weights.cu` a step, each step
one CUDA graph replay through `mcl.MCL.step`, as the JAX tool jits its
step). The truth
starts at (400, 400, pi) and follows `forward_arc_commands(steps, 2.5,
0.04)` through the noisy motion model with a generator of its own (seed +
100). Per seed it reports, as the JAX tool does, the step at which the
filter commits to the truth (spread < 20 px and mean error < 10 px) and
the post-convergence ATE, and besides: the step at which the cloud
collapses onto any one hypothesis (spread < 20 px), the final error, and
how many initial particles lie near the truth's start pose.

    python -m slam_tpu_torch.tools.global_loc_bench --particles 1000000 --seeds 10
    python -m slam_tpu_torch.tools.global_loc_bench --particles 200000 --device cpu

`--plant K` moves K particles of each initial cloud next to the truth's
start pose: a filter that weighs and resamples correctly then converges on
the truth.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from slam_tpu_torch.core.config import LidarConfig, MCLConfig, RaycastConfig, beam_bin_stride
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Pose
from slam_tpu_torch.models import fake_lidar
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.models.simulate import forward_arc_commands
from slam_tpu_torch.ops import measurement, motion, rayfield
from slam_tpu_torch.utils.maps import synthetic_floor_plan

ALPHAS = (5e-4, 5e-4, 1e-2, 1e-2)
START = (400.0, 400.0, math.pi)
# The JAX tool's convergence test.
SPREAD_PX = 20.0
ERROR_PX = 10.0
# Windows of `near_start` (px, rad) and the spread of `plant`'s poses.
NEAR = ((2.0, 0.035), (3.0, 0.1))
PLANT_PX = 1.0
PLANT_RAD = 0.02


def configs(n_particles: int):
    """(lidar, the filter's LUT RaycastConfig, the scans' march
    RaycastConfig, MCLConfig) of `tools/global_loc_bench.py:63-75`."""
    lidar = LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="lut")
    cfg = MCLConfig(n_particles=n_particles, meas_stddev=5.0,
                    lut_beam_stride=beam_bin_stride(lidar, rc))
    return lidar, rc, RaycastConfig(step=0.5, max_dist=500.0), cfg


def truth_and_scans(blocked, lidar, scan_rc, cfg, seed: int, cmds):
    """The truth's poses (f64 [T, 3], after each command) and the scans
    from them, on `blocked`'s device."""
    g = torch.Generator().manual_seed(seed + 100)
    gt = Pose.create(*START)
    truths, scans = [], []
    for odom in cmds:
        gt = motion.sample_motion_model_odometry(odom, gt, ALPHAS, generator=g)
        truths.append((float(gt.x), float(gt.y), float(gt.theta)))
        scans.append(fake_lidar.scan(blocked, measurement.sensor_pose(
            gt.to(blocked.device), cfg.scanner_offset), lidar, scan_rc))
    return np.array(truths), scans


def near_start(pose: Pose) -> list:
    """How many of `pose`'s particles lie within each window of NEAR of
    the truth's start pose (distance and wrapped heading)."""
    d = torch.hypot(pose.x - START[0], pose.y - START[1])
    dth = torch.remainder(pose.theta - START[2] + math.pi, 2 * math.pi) - math.pi
    return [int(((d <= px) & (dth.abs() <= rad)).sum()) for px, rad in NEAR]


def plant(state: mcl_mod.MCLState, noise: torch.Tensor) -> mcl_mod.MCLState:
    """`state` with its first k particles moved next to the truth's start
    pose: START + (PLANT_PX, PLANT_PX, PLANT_RAD) * `noise`, standard
    normal draws f32 [3, k]."""
    p = state.particles.pose
    k = noise.shape[1]
    noise = noise.to(p.x.device)
    x, y, th = p.x.clone(), p.y.clone(), p.theta.clone()
    x[:k] = START[0] + PLANT_PX * noise[0]
    y[:k] = START[1] + PLANT_PX * noise[1]
    th[:k] = START[2] + PLANT_RAD * noise[2]
    return state.replace(particles=state.particles.replace(pose=Pose(x=x, y=y, theta=th)))


def run(state, field, cmds, scans, cfg, rc, engine=None):
    """The step over the commands and scans: (final state, f32 [T, 4]
    per-step (mean x, mean y, std x, std y) on the state's device, the
    per-step ms). The step is `engine.step` (an `mcl.MCL` of `cfg`, `rc`:
    one CUDA graph replay a step on the card, as the JAX tool jits it)
    when given, else the eager `mcl.step`. On CUDA the times come from
    CUDA events and the loop makes no host read."""
    if engine is not None:
        def step(st, odom, scan):
            return engine.step(st, odom, ALPHAS, scan, field)
    else:
        def step(st, odom, scan):
            return mcl_mod.step(st, odom, ALPHAS, scan, field, cfg, rc)
    dev = state.particles.pose.x.device
    stats = torch.empty((len(cmds), 4), device=dev)
    marks = []
    for k, (odom, scan) in enumerate(zip(cmds, scans)):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            start = time.perf_counter()
        state = step(state, odom, scan)
        if dev.type == "cuda":
            stop.record()
        else:
            stop = time.perf_counter()
        marks.append((start, stop))
        mp = mcl_mod.mean_pose(state)
        pp = state.particles.pose
        stats[k] = torch.stack([mp.x, mp.y, pp.x.std(correction=0), pp.y.std(correction=0)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        ms = [a.elapsed_time(b) for a, b in marks]
    else:
        ms = [(b - a) * 1e3 for a, b in marks]
    return state, stats, ms


def summarize(stats, truths) -> dict:
    """Convergence of one run from `run`'s per-step stats and the truths:
    converged_at_step (the JAX tool's test), post_convergence_ate_px,
    collapsed_at_step (spread alone), final error and spread."""
    s = stats.cpu().numpy().astype(np.float64)
    errs = np.hypot(s[:, 0] - truths[:, 0], s[:, 1] - truths[:, 1])
    spread = np.maximum(s[:, 2], s[:, 3])
    steps = range(len(errs))
    conv = next((t + 1 for t in steps if spread[t] < SPREAD_PX and errs[t] < ERROR_PX), None)
    after = errs[conv - 1:] if conv is not None else np.array([])
    return {
        "converged_at_step": conv,
        "post_convergence_ate_px": float(np.sqrt(np.mean(after ** 2))) if after.size else None,
        "collapsed_at_step": next((t + 1 for t in steps if spread[t] < SPREAD_PX), None),
        "final_error_px": float(errs[-1]),
        "final_spread_px": float(spread[-1]),
        "finite": bool(np.isfinite(s).all()),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seeds", type=int, default=3, help="seeds 0 .. SEEDS-1")
    ap.add_argument("--plant", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    dev = entry_device(args.device)
    blocked = torch.from_numpy(synthetic_floor_plan()).to(dev)
    lidar, rc, scan_rc, cfg = configs(args.particles)
    field = rayfield.make_ray_field(blocked, rc)
    engine = mcl_mod.MCL(cfg, rc, device=dev)
    cmds = forward_arc_commands(args.steps, trans=2.5, rot=0.04)
    runs = []
    for seed in range(args.seeds):
        truths, scans = truth_and_scans(blocked, lidar, scan_rc, cfg, seed, cmds)
        st = mcl_mod.init_uniform(mcl_mod.make_generator(seed, dev), args.particles, blocked)
        if args.plant:
            st = plant(st, torch.randn((3, args.plant), generator=mcl_mod.make_generator(
                seed + 200, dev), device=dev))
        near = near_start(st.particles.pose)
        st, stats, ms = run(st, field, cmds, scans, cfg, rc, engine=engine)
        runs.append({"seed": seed, **summarize(stats, truths), "near_start": near,
                     "median_step_ms": float(np.median(ms))})
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({
        "metric": f"global_localization_{args.particles // 1000}k", "device": str(dev),
        "steps": args.steps, "plant": args.plant, "near_windows": NEAR,
        "converged": sum(r["converged_at_step"] is not None for r in runs),
        "collapsed": sum(r["collapsed_at_step"] is not None for r in runs),
        "of": len(runs), "runs": runs,
    }))


if __name__ == "__main__":
    main()
