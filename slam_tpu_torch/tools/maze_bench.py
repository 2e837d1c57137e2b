"""Big-map benchmark: MCL on a maze (port of `benchmarks/maze_bench.py`).

The maze is the JAX tool's procedural stand-in (`--size` px a side, walls
every `--pitch` px, doors knocked at random from seed 0), or a PNG given
with `--map`. The filter localizes on it with 10k particles, 90 beams
over pi, max_dist 500 and 360 bins, through one of two ray tables:

  * ``lut``: the dense bins-last table (u8 by default: size^2 * 360 B,
    2.07 GB at 2400 px), on the card through `mcl.step`'s fused kernel;
  * ``cddt``: the compressed run-interval table (`ops/cddt.py`), whose
    queries run per (particle, beam) through the beam model; predict is
    the standalone odometry kernel there.

Prints the JAX tool's JSON lines (metric names unchanged):

  <name>_mcl_step_ms_10k[_cddt]     predict -> update step latency
  <name>_localization_ate_px[_cddt] closed-loop tracking ATE (60 steps)
  <name>_<backend>_build_s          one-off table build time

    python -m slam_tpu_torch.tools.maze_bench --backend cddt
    python -m slam_tpu_torch.tools.maze_bench --size 7000 --pitch 400 --backend cddt
    python -m slam_tpu_torch.tools.maze_bench --size 240 --device cpu

Steps are timed with CUDA events on the card (host clock on the CPU).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from slam_tpu_torch.core.config import (
    LidarConfig,
    MCLConfig,
    MotionConfig,
    RaycastConfig,
    SLAMConfig,
    beam_bin_stride,
)
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Odometry, Pose
from slam_tpu_torch.models import fake_lidar, simulate
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.ops import edt as edtlib
from slam_tpu_torch.ops import rayfield
from slam_tpu_torch.utils.metrics import ate_rmse

ALPHAS = (5e-4, 5e-4, 1e-2, 1e-2)


def procedural_maze(size: int = 2400, pitch: int = 40) -> np.ndarray:
    """bool[size, size] blocked mask: the JAX tool's synthetic maze
    (`benchmarks/maze_bench.py:115-130`), the same cells for the same
    arguments."""
    h = w = size
    p = pitch
    lo, hi = p // 5, p - p // 5  # door span within each wall segment
    rng = np.random.default_rng(0)
    blocked = np.zeros((h, w), bool)
    blocked[::p, :] = True
    blocked[:, ::p] = True
    for i in range(0, h, p):  # knock doors
        for j in range(0, w, p):
            if rng.random() < 0.7:
                blocked[i, j + lo : j + hi] = False
            if rng.random() < 0.7:
                blocked[i + lo : i + hi, j] = False
    blocked[[0, -1], :] = True
    blocked[:, [0, -1]] = True
    return blocked


def find_start(blocked: np.ndarray, device=None) -> tuple:
    """A free cell with near-max clearance, closest to the map center (the
    JAX tool's rule): clearance is the capped EDT with out-of-map cells
    blocked, on `device`. Returns world (x, y)."""
    bpad = torch.from_numpy(np.pad(blocked, 1, constant_values=True)).to(device)
    e = edtlib.edt_capped(bpad, 64.0)[1:-1, 1:-1].cpu().numpy()
    free = ~blocked
    e[~free] = 0.0
    ii, jj = np.nonzero(free & (e >= e[free].max() - 1.0))
    h, w = blocked.shape
    k = np.argmin((ii - h / 2) ** 2 + (jj - w / 2) ** 2)
    i, j = int(ii[k]), int(jj[k])
    return float(j) + 0.5, float(h - i) - 0.5


def configs(backend: str, particles: int = 10_000, bins: int = 360, dtype: str = "u8"):
    """(lidar, RaycastConfig, MCLConfig) of the JAX tool: the fused panorama
    route needs the dense table, so only ``lut`` sets a beam stride."""
    lidar = LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend=backend, lut_bins=bins,
                       lut_dtype=dtype)
    cfg = MCLConfig(n_particles=particles, meas_stddev=5.0,
                    lut_beam_stride=beam_bin_stride(lidar, rc) if backend == "lut" else None)
    return lidar, rc, cfg


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_field(blocked, backend: str, bins: int = 360, dtype: str = "u8", device=None,
                cache_dir=None):
    """(the RayField, its build seconds, a description) on `device`."""
    dev = entry_device(device)
    _, rc, _ = configs(backend, bins=bins, dtype=dtype)
    b = torch.from_numpy(np.asarray(blocked, bool)).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    field = rayfield.make_ray_field(b, rc, cache_dir=cache_dir)
    _sync(dev)
    build_s = time.perf_counter() - t0
    h, w = b.shape
    if backend == "lut":
        desc = (f"LUT [{h}x{w}x{bins}] {dtype} = "
                f"{field.lut.numel() * field.lut.element_size() / 2**30:.2f} GiB")
    else:
        desc = (f"CDDT [{bins // 2}x{field.cddt.d}xK={field.cddt.k}] = "
                f"{field.cddt.nbytes / 2**20:.1f} MiB")
    return field, build_s, desc


def step_ms(blocked, field, backend: str, start, particles: int = 10_000, iters: int = 20,
            warmup: int = 3, device=None, bins: int = 360, dtype: str = "u8"):
    """ms per predict -> update step (`mcl.step`) from `start` against one
    scan taken there, after `warmup` steps: CUDA events on the card, the
    host clock on the CPU. Returns (ms, the final state)."""
    dev = entry_device(device)
    lidar, rc, cfg = configs(backend, particles, bins, dtype)
    b = field.blocked
    pose = Pose.create(*start, device=dev)
    scan = fake_lidar.scan(b, pose, lidar, RaycastConfig(max_dist=500.0))
    odom = Odometry.create(0.05, 1.0, 0.05)
    state = mcl_mod.init(mcl_mod.make_generator(0, dev), particles, pose)
    for _ in range(warmup):
        state = mcl_mod.step(state, odom, ALPHAS, scan, field, cfg, rc)
    _sync(dev)
    if dev.type == "cuda":
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            state = mcl_mod.step(state, odom, ALPHAS, scan, field, cfg, rc)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / iters, state
    t0 = time.perf_counter()
    for _ in range(iters):
        state = mcl_mod.step(state, odom, ALPHAS, scan, field, cfg, rc)
    return (time.perf_counter() - t0) / iters * 1e3, state


def localization_ate(blocked, field, backend: str, start, particles: int = 10_000,
                     steps: int = 60, device=None, bins: int = 360, dtype: str = "u8"):
    """The tool's closed-loop quality run: `steps` commands of a tight arc
    (trans 1.2, rot 0.25) from `start`, filter seed 1; the ATE in px."""
    lidar, rc, cfg = configs(backend, particles, bins, dtype)
    slam_cfg = SLAMConfig(mcl=cfg, lidar=lidar, motion=MotionConfig(alphas=ALPHAS), raycast=rc)
    cmds = simulate.forward_arc_commands(steps, trans=1.2, rot=0.25)
    res = simulate.run_localization(field.blocked, slam_cfg, cmds, Pose.create(*start), seed=1,
                                    field=field, device=device)
    return float(ate_rmse(res.est_xy, res.gt_xy))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--particles", type=int, default=10_000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", default="u8", choices=["u8", "bf16"])
    ap.add_argument("--backend", default="lut", choices=["lut", "cddt"])
    ap.add_argument("--bins", type=int, default=360)
    ap.add_argument("--quality-steps", type=int, default=60)
    ap.add_argument("--map", default=None, help="maze PNG (the procedural maze if absent)")
    ap.add_argument("--size", type=int, default=2400, help="procedural maze side (px)")
    ap.add_argument("--pitch", type=int, default=40, help="procedural maze wall spacing (px)")
    ap.add_argument("--cache-dir", default=None, help="cache built tables here")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = entry_device(args.device)
    if args.map:
        from slam_tpu_torch.utils.maps import load_binary_map

        blocked, name = load_binary_map(args.map) == 0, "maze"
    else:
        blocked, name = procedural_maze(args.size, args.pitch), f"synthmaze{args.size}"
    kw = dict(bins=args.bins, dtype=args.dtype, device=dev)
    field, build_s, desc = build_field(blocked, args.backend, cache_dir=args.cache_dir, **kw)
    print(f"# {desc}, built in {build_s:.1f}s on {dev}", file=sys.stderr)
    start = (*find_start(blocked, dev), 0.9)
    ms, _ = step_ms(blocked, field, args.backend, start, args.particles, args.iters, **kw)
    ate = localization_ate(blocked, field, args.backend, start, args.particles,
                           args.quality_steps, **kw)
    tag = "" if args.backend == "lut" else f"_{args.backend}"
    for metric, value, unit in (
        (f"{name}_mcl_step_ms_{args.particles // 1000}k{tag}", ms, "ms"),
        (f"{name}_localization_ate_px{tag}", ate, "px"),
        (f"{name}_{args.backend}_build_s", build_s, "s"),
    ):
        print(json.dumps({"metric": metric, "value": round(value, 3), "unit": unit,
                          "device": str(dev)}))


if __name__ == "__main__":
    main()
