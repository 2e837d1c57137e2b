"""The port's three filter steps with the systematic resampler in them,
timed alone, for A/B runs of two trees of the package on one card.

    mcl        `bench.py`'s MCL step through `mcl.step` (`chip_smoke.py`
               phase 7): 100k particles on the synthetic floor plan's
               360-bin bf16 LUT, from (400, 400, pi), odometry (2.5, 0.02,
               0.02); 3 warm-up steps, then blocks of steps
    slam       `benchmarks/suite.py slam`'s step through `GridSLAM` (phase
               9): 1M particles, the boxed table, resample_every=4, two
               alternating scans; 4 warm-up steps, then blocks of steps
    globalloc  `tools/global_loc_bench.py`'s configuration through
               `mcl.step` (phase 15): 1M particles from `init_uniform`,
               seed 0, 60 steps

Each case prints one JSON line with the step run two ways in the same
call, through the entry point's CUDA graph (`mcl.MCL.step`,
`slam.GridSLAM.step`: one replay a step, `graph`) and through the eager
free function (`mcl.step`, `slam.step`: `eager`): ms per step (CUDA
events; median, min and max over the blocks, or over the 60 steps), device
ms and launches per step (torch.profiler); and the device ms of one
`resample` call on the case's own weights (the last state's; for globalloc
the uniform cloud's weights after step 1, as dispersed as the step ever
sees). A tree whose package predates the graphed entry points reports
`graph` as null.

    env PYTHONPATH=<tree> python slam_tpu_torch/tools/step_bench.py --label NAME

runs the `slam_tpu_torch` of <tree> (the script uses only APIs that the
package has had since its global-localization slice), so two trees are
compared in one call as tree A, tree B, tree B, tree A. `--device cpu`
with small `--particles` / `--big-particles` is a functional check.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import statistics
import subprocess

import numpy as np
import torch

from slam_tpu_torch.core.config import (
    LidarConfig, MapConfig, MCLConfig, MotionConfig, RaycastConfig, SLAMConfig, beam_bin_stride,
)
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Odometry, Pose
from slam_tpu_torch.models import fake_lidar
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.models import slam as slam_mod
from slam_tpu_torch.models.simulate import forward_arc_commands
from slam_tpu_torch.ops import measurement, rayfield, resample
from slam_tpu_torch.tools import global_loc_bench as glb
from slam_tpu_torch.utils.maps import synthetic_floor_plan

BENCH_ODOM = (2.5, 0.02, 0.02)
BENCH_ALPHAS = (0.0005, 0.0005, 0.01, 0.01)
SLAM_ODOM = (0.02, 2.5, 0.02)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_ms(fn, dev, iters: int = 20, warmup: int = 3):
    """(device ms, kernel launches) per call of `fn` from torch.profiler
    (the CPU: (None, None))."""
    if dev.type != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        _sync(dev)
    ms = n = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time > 0:
            ms += e.device_time / 1e3 / iters
            n += 1 / iters
    return ms, n


def blocks_ms(advance, dev, blocks: int, iters: int) -> list:
    """ms per call of `advance` in each of `blocks` blocks of `iters` calls:
    CUDA events on the card, the host clock elsewhere."""
    import time

    out = []
    for _ in range(blocks):
        _sync(dev)
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                advance()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                advance()
            out.append((time.perf_counter() - t0) * 1e3 / iters)
    return out


def spread(ms) -> dict:
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms), "n": len(ms)}


def resample_ms(particles, dev, seed: int) -> float:
    g = mcl_mod.make_generator(seed, dev)
    return device_ms(lambda: resample.resample(particles, "systematic", generator=g), dev)[0]


def both_ways(make_advance, dev, blocks, iters, warmup) -> dict:
    """{"graph": ..., "eager": ...}: for each way, `make_advance(graphed)`
    (None when the tree lacks the graphed entry point) run `warmup` steps,
    then timed in `blocks` blocks of `iters` steps and profiled; the last
    state's box under "box"."""
    out = {}
    for way in ("graph", "eager"):
        made = make_advance(way == "graph")
        if made is None:
            out[way] = None
            continue
        advance, box = made
        for _ in range(warmup):
            advance()
        ms = blocks_ms(advance, dev, blocks, iters)
        dms, launches = device_ms(advance, dev, iters, warmup=0)
        out[way] = {"ms_per_step": spread(ms), "device_ms_per_step": dms,
                    "launches_per_step": launches}
        out["box"] = box
    return out


def mcl_case(dev, blocked, field, n, blocks, iters) -> dict:
    lidar = LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="lut")
    cfg = MCLConfig(n_particles=n, meas_stddev=5.0, scanner_offset=(0.0, 30.0, 0.0),
                    lut_beam_stride=beam_bin_stride(lidar, rc))
    pose0 = Pose.create(400.0, 400.0, math.pi, device=dev)
    scan = fake_lidar.scan(blocked, measurement.sensor_pose(pose0, cfg.scanner_offset), lidar,
                           RaycastConfig(max_dist=500.0))
    odom = Odometry.create(*BENCH_ODOM)

    def make(graphed):
        box = [mcl_mod.init(mcl_mod.make_generator(0, dev), n, pose0)]
        if graphed:
            if not hasattr(mcl_mod.MCL, "step"):
                return None
            engine = mcl_mod.MCL(cfg, rc, device=dev)

            def advance():
                box[0] = engine.step(box[0], odom, BENCH_ALPHAS, scan, field)
        else:
            def advance():
                box[0] = mcl_mod.step(box[0], odom, BENCH_ALPHAS, scan, field, cfg, rc)
        return advance, box

    res = both_ways(make, dev, blocks, iters, warmup=3)
    box = res.pop("box")
    return {"particles": n, **res, "resample_device_ms": resample_ms(box[0].particles, dev, 1)}


def slam_case(dev, blocked, n, blocks, iters) -> dict:
    cfg = SLAMConfig(
        mcl=MCLConfig(n_particles=n, meas_stddev=5.0, measurement="likelihood_field_table",
                      lf_table_box=128, resample_every=4),
        map=MapConfig(),
        lidar=LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90),
        motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
        raycast=RaycastConfig(step=0.5, max_dist=500.0, backend="sdf"),
        map_pose="mode",
    )
    scans = [fake_lidar.scan(blocked, measurement.sensor_pose(p, cfg.mcl.scanner_offset),
                             cfg.lidar, cfg.raycast)
             for p in (Pose.create(400.0, 400.0, math.pi, device=dev),
                       Pose.create(403.0, 403.0, math.pi + 0.05, device=dev))]
    odom = Odometry.create(*SLAM_ODOM)
    engine = slam_mod.GridSLAM(cfg, seed=0, device=dev)

    def make(graphed):
        if graphed and not hasattr(engine, "graphs"):
            return None
        box = [engine.init(Pose.create(400.0, 400.0, math.pi, device=dev)), 0]

        def advance():
            if graphed:
                box[0] = engine.step(box[0], odom, scans[box[1] % 2])
            else:
                box[0] = slam_mod.step(box[0], odom, scans[box[1] % 2], cfg)
            box[1] += 1

        return advance, box

    # 20 steps hold 5 resamples, as in the timed blocks.
    res = both_ways(make, dev, blocks, iters, warmup=4)
    box = res.pop("box")
    return {"particles": n, **res, "resample_device_ms": resample_ms(
        box[0].mcl.particles, dev, 2)}


def globalloc_case(dev, blocked, field, n, steps) -> dict:
    lidar, rc, scan_rc, cfg = glb.configs(n)
    cmds = forward_arc_commands(steps, trans=2.5, rot=0.04)
    _, scans = glb.truth_and_scans(blocked, lidar, scan_rc, cfg, 0, cmds)
    st0 = mcl_mod.init_uniform(mcl_mod.make_generator(0, dev), n, blocked)
    # The uniform cloud's weights after one step, before the resampler.
    one = mcl_mod.step(st0, cmds[0], glb.ALPHAS, scans[0], field,
                       _no_resample(cfg), rc)
    out = {"particles": n, "steps": steps}
    for way in ("graph", "eager"):
        engine, kw = None, {}
        if way == "graph":
            if "engine" not in inspect.signature(glb.run).parameters:
                out[way] = None
                continue
            engine = mcl_mod.MCL(cfg, rc, device=dev)
            kw = {"engine": engine}
        st0 = mcl_mod.init_uniform(mcl_mod.make_generator(0, dev), n, blocked)
        st, _, ms = glb.run(st0, field, cmds, scans, cfg, rc, **kw)
        box = [st]

        def advance():
            if engine is not None:
                box[0] = engine.step(box[0], cmds[-1], glb.ALPHAS, scans[-1], field)
            else:
                box[0] = mcl_mod.step(box[0], cmds[-1], glb.ALPHAS, scans[-1], field, cfg, rc)

        dms, launches = device_ms(advance, dev, 10)
        out[way] = {"ms_per_step": spread(ms), "step_1_ms": ms[0],
                    "converged_device_ms_per_step": dms, "launches_per_step": launches}
    out["resample_device_ms_uniform_step_1"] = resample_ms(one.particles, dev, 3)
    return out


def _no_resample(cfg: MCLConfig) -> MCLConfig:
    import dataclasses

    return dataclasses.replace(cfg, ess_threshold=-1.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--cases", nargs="+", default=["mcl", "slam", "globalloc"])
    ap.add_argument("--particles", type=int, default=100_000, help="the mcl case")
    ap.add_argument("--big-particles", type=int, default=1_000_000,
                    help="the slam and globalloc cases")
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--gl-steps", type=int, default=60)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = entry_device(args.device)
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    blocked = torch.from_numpy(np.asarray(synthetic_floor_plan())).to(dev)
    field = rayfield.make_ray_field(blocked, RaycastConfig(step=0.5, max_dist=500.0,
                                                           backend="lut"))
    for case in args.cases:
        if case == "mcl":
            res = mcl_case(dev, blocked, field, args.particles, args.blocks, args.iters)
        elif case == "slam":
            res = slam_case(dev, blocked, args.big_particles, args.blocks, args.iters)
        elif case == "globalloc":
            res = globalloc_case(dev, blocked, field, args.big_particles, args.gl_steps)
        else:
            raise SystemExit(f"unknown case {case}")
        print(json.dumps({"label": args.label, "case": case, **res, "device": smi or str(dev)}),
              flush=True)


if __name__ == "__main__":
    main()
