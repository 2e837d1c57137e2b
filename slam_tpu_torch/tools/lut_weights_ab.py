"""The fused predict -> LUT-weigh kernel (`csrc/lut_weights.cu`) against
other builds of it, on the card: each build's poses and weights against
the package's build, then device times in turns at the four shapes the
main paths give the kernel. And the kernel's adversarial cases at a small
size, for `compute-sanitizer`.

    python -m slam_tpu_torch.tools.lut_weights_ab --other parent=PATH --rounds 4

builds each `--other NAME=PATH[::FLAGS]` (another `lut_weights.cu` with the
same C entry point, e.g. an earlier commit's, `git show REV:slam_tpu_torch/
csrc/lut_weights.cu > PATH`; `tools/_ab.py:parse_builds`) into its own library under
`slam_tpu_torch/_build/ab/`, all at once, beside the package's own build
(`new`). The shapes:
`bench` bench.py's 100k cloud after three steps on the synthetic floor
plan's bf16 table (`chip_smoke.py` phase 6), `uniform_1m` step 1 of the
1M uniform global-localization cloud (phase 15), `fleet_16x100k` a fleet
of 16 x 100k (phase 21), `maze_u8_10k` the 2400 px maze's u8 10k cloud
(phase 20). Each round times every build once a shape, the order
reversed every other round (A, B, B, A); a time is the device ms of one
launch from CUDA events around replays of a CUDA graph of ITERS launches
(`tools/_ab.py:graph_ms`).
One JSON line a shape, then one with the card's name and power limit.

    python -m slam_tpu_torch.tools.lut_weights_ab --sanitize [--other ...]

runs the adversarial cases once a build (`chip_smoke.adversarial_poses`,
so it runs from the repo's root: one robot of 1003 particles, three robots of 333, both tables of a 37 x 53 map whose
u8 table ends 8 B off a 16 B boundary, a shard at i0 = 517), synchronizes
and prints "sanitize ok": the command to run under `compute-sanitizer
--tool memcheck|racecheck|synccheck`.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from slam_tpu_torch.core.config import LidarConfig, MCLConfig, RaycastConfig, beam_bin_stride
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import fake_lidar, fleet
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.models.simulate import forward_arc_commands
from slam_tpu_torch.ops import lut_weights_cuda, measurement, motion_cuda, rayfield
from slam_tpu_torch.tools import _ab
from slam_tpu_torch.tools import fleet_bench as fb
from slam_tpu_torch.tools import global_loc_bench as glb
from slam_tpu_torch.tools import maze_bench as mb
from slam_tpu_torch.utils.maps import synthetic_floor_plan

BENCH_ODOM = (2.5, 0.02, 0.02)
BENCH_ALPHAS = (0.0005, 0.0005, 0.01, 0.01)


def _kw(cfg, rc):
    return dict(beam_stride=cfg.lut_beam_stride,
                displacement=measurement.scanner_displacement(cfg.scanner_offset),
                max_dist=rc.max_dist, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon)


def _seed(s, dev, r=1):
    return torch.arange(r, dtype=torch.int64, device=dev) + s


def shapes(dev):
    """{name: (lut, poses, scan, weigh kwargs, motion)} at the main paths'
    shapes (module docstring)."""
    blocked = torch.from_numpy(synthetic_floor_plan()).to(dev)
    out = {}
    lidar = LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="lut")
    field = rayfield.make_ray_field(blocked, rc)
    cfg = MCLConfig(n_particles=100_000, meas_stddev=5.0, scanner_offset=(0.0, 30.0, 0.0),
                    lut_beam_stride=beam_bin_stride(lidar, rc))
    pose0 = Pose.create(400.0, 400.0, math.pi, device=dev)
    scan = fake_lidar.scan(blocked, mcl_mod.MCL.sensor_position(pose0, cfg.scanner_offset),
                           lidar, RaycastConfig(max_dist=500.0))
    odom = Odometry.create(*BENCH_ODOM)
    st = mcl_mod.init(mcl_mod.make_generator(0, dev), 100_000, pose0)
    for _ in range(3):
        st = mcl_mod.step(st, odom, BENCH_ALPHAS, scan, field, cfg, rc)
    out["bench"] = (field.lut, st.particles.pose, scan, _kw(cfg, rc),
                    (_seed(12, dev), motion_cuda.odometry_rows(odom, dev), BENCH_ALPHAS))

    lidar_g, rc_g, scan_rc, cfg_g = glb.configs(1_000_000)
    cloud = mcl_mod.init_uniform(mcl_mod.make_generator(0, dev), 1_000_000,
                                 blocked).particles.pose
    cmds = forward_arc_commands(1, trans=2.5, rot=0.04)
    _, scans = glb.truth_and_scans(blocked, lidar_g, scan_rc, cfg_g, 0, cmds)
    out["uniform_1m"] = (field.lut, cloud, scans[0], _kw(cfg_g, rc_g),
                         (_seed(13, dev), motion_cuda.odometry_rows(cmds[0], dev), glb.ALPHAS))

    lidar_f, rc_f, cfg_f = fb.configs(100_000)
    poses, odoms, fscans = fb.fleet_inputs(blocked, 16, lidar_f, cfg_f, np.random.default_rng(21))
    fst = fleet.fleet_step(fleet.init_fleet(1, 16, 100_000, poses), odoms, fscans, field,
                           fb.ALPHAS, cfg_f, rc_f)
    out["fleet_16x100k"] = (field.lut, fst.particles.pose, fscans, _kw(cfg_f, rc_f),
                            (_seed(100, dev, 16), motion_cuda.odometry_rows(odoms, dev),
                             fb.ALPHAS))

    maze = mb.procedural_maze(2400, 40)
    mfield = mb.build_field(maze, "lut", device=dev)[0]
    start = (*mb.find_start(maze, dev), 0.9)  # chip_smoke.py phase 20's start
    _, mst = mb.step_ms(maze, mfield, "lut", start, 10_000, iters=2, warmup=1, device=dev)
    lidar_m, rc_m, cfg_m = mb.configs("lut", 10_000)
    mscan = fake_lidar.scan(mfield.blocked, Pose.create(*start, device=dev), lidar_m,
                            RaycastConfig(max_dist=500.0))
    modom = Odometry.create(0.05, 1.0, 0.05)
    out["maze_u8_10k"] = (mfield.lut, mst.particles.pose, mscan, _kw(cfg_m, rc_m),
                          (_seed(17, dev), motion_cuda.odometry_rows(modom, dev), mb.ALPHAS))
    return out


def compare(ref, got) -> dict:
    """Poses bit for bit, and the weights' share within a relative 1e-5 and
    largest |diff|, of `got` against `ref` (each (poses, lw))."""
    poses_equal = all(torch.equal(getattr(ref[0], f).view(torch.int32),
                                  getattr(got[0], f).view(torch.int32))
                      for f in ("x", "y", "theta"))
    diff = (got[1] - ref[1]).abs()
    return {"poses_equal": poses_equal,
            "weights_within_1e-5": float((diff <= 1e-5 * ref[1].abs()).float().mean()),
            "max_abs_diff": float(diff.max()),
            "same_best": int(torch.argmax(got[1])) == int(torch.argmax(ref[1]))}


def sanitize(dev, libs) -> dict:
    """The adversarial cases once a build (module docstring)."""
    import chip_smoke  # the repo's root script, which holds the clouds

    h, w = 37, 53
    blocked = np.zeros((h, w), bool)
    blocked[[0, -1], :] = blocked[:, [0, -1]] = True
    blocked[10:12, 5:40] = True
    blocked_t = torch.from_numpy(blocked).to(dev)
    lidar = LidarConfig(start=0.0, stop=math.pi, max_dist=60.0, n_rays=90)
    out = {}
    for dtype in ("bf16", "u8"):
        rc = RaycastConfig(step=0.5, max_dist=60.0, backend="lut", lut_dtype=dtype)
        lut = rayfield.make_ray_field(blocked_t, rc).lut
        cfg = MCLConfig(n_particles=1003, meas_stddev=5.0, scanner_offset=(0.0, 3.0, 0.0),
                        lut_beam_stride=beam_bin_stride(lidar, rc))
        scan = fake_lidar.scan(blocked_t, Pose.create(26.0, 20.0, 0.3, device=dev), lidar,
                               RaycastConfig(max_dist=60.0))
        kw = _kw(cfg, rc)
        span = cfg.lut_beam_stride * 89 + 1
        rng = np.random.default_rng(5)

        def cloud(n):
            xyz, _ = chip_smoke.adversarial_poses(h, w, 360, n, span, kw["displacement"],
                                                  float(scan.angles[0]), rng)
            return [torch.from_numpy(v).to(dev) for v in xyz]

        one = Pose(*cloud(1003))
        three = Pose(*(torch.stack(v) for v in zip(cloud(333), cloud(333), cloud(333))))
        scans3 = Scan(angles=scan.angles.expand(3, -1).contiguous(),
                      dists=scan.dists.expand(3, -1).contiguous())
        zero = Odometry.create(0.0, 0.0, 0.0)
        for name, (lib, *_) in libs.items():
            with _ab.launching(lib):
                full = lut_weights_cuda.launch(
                    lut, 360, one, scan, motion=(_seed(3, dev), motion_cuda.odometry_rows(
                        zero, dev), BENCH_ALPHAS), **kw)
                part = lut_weights_cuda.launch(
                    lut, 360, Pose(*(v[517:].contiguous() for v in (one.x, one.y, one.theta))),
                    scan, motion=(_seed(3, dev), motion_cuda.odometry_rows(zero, dev),
                                  BENCH_ALPHAS), i0=517, **kw)
                lut_weights_cuda.launch(lut, 360, three, scans3, **kw)
                lut_weights_cuda.launch(
                    lut, 360, three, scans3, motion=(_seed(7, dev, 3), motion_cuda.odometry_rows(
                        Odometry.create([0.0] * 3, [0.5] * 3, [0.1] * 3), dev), BENCH_ALPHAS),
                    **kw)
            torch.cuda.synchronize()
            shard = torch.equal(full[1][517:], part[1]) and torch.equal(full[0].x[517:],
                                                                         part[0].x)
            out[f"{name}_{dtype}"] = {"shard_equals_slice": shard,
                                      "table_bytes_mod_16": lut.numel() * lut.element_size() % 16}
            if not shard:
                raise RuntimeError(f"{name} {dtype}: the shard at i0 = 517 != the slice")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH[::FLAGS]")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--sanitize", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lut_weights_ab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    libs = {"new": _ab.own_build(),
            **_ab.build(_ab.parse_builds(args.other), "lut_weights_launch")}
    for name, (_, report, _) in libs.items():
        for line in report.splitlines():
            if "lut_weights" in line or "registers" in line:
                print(f"# {name}: {line.strip()}", flush=True)
    if args.sanitize:
        print(json.dumps(sanitize(dev, libs)), flush=True)
        print("sanitize ok", flush=True)
        return
    names = list(libs)
    for shape, (lut, poses, scan, kw, motion) in shapes(dev).items():
        def run(name):
            with _ab.launching(libs[name][0]):
                return lut_weights_cuda.launch(lut, lut.shape[-1], poses, scan, motion=motion,
                                               **kw)

        ref = run("new")
        checks = {name: compare(ref, run(name)) for name in names if name != "new"}
        ms = _ab.in_turns(names, lambda name: lambda: run(name), poses.x, args.rounds)
        print(json.dumps({"shape": shape, "particles": poses.x.numel(), "vs_new": checks,
                          "ms": ms}), flush=True)
    _ab.device_line(rounds=args.rounds)


if __name__ == "__main__":
    main()
