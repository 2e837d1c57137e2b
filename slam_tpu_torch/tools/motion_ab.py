"""The odometry motion kernel K1 (`csrc/motion_odometry.cu`) against other
builds of it, on the card: each build's poses against a reference build's
bit for bit, then device times in turns at the shapes the main paths give
the kernel.

    python -m slam_tpu_torch.tools.motion_ab --other parent=PATH \\
        [--other NAME=PATH::FLAGS ...] [--rounds 4] [--sass DIR]

builds each `--other` (another `motion_odometry.cu`, e.g. the parent
commit's, `git show HEAD:slam_tpu_torch/csrc/motion_odometry.cu > PATH`
with its `motion_odometry.cuh` beside it, or a source with `-D` flags
after `::`; `tools/_ab.py:parse_builds`) into its own library beside the
package's build (`new`). A source without the robot axis in its entry
point (`n_robots`: the kernel's earlier versions) runs a fleet shape as
one launch a robot. The
reference is the build named `parent`, else `new`. The shapes (numpy
clouds from a seed): `1m` the SLAM step's 1M particles (`chip_smoke.py`
phase 9), `100k` phase 4's, `fleet_16x100k` a fleet of 16 x 100k (the
fleet's auto step, phase 25), `fleet_16x100003` 16 rows of 100,003 (rows
12 B off 16 B, phase 4), `10k` the CDDT maze's, `1000` the RBPF's, `256`
`entry()`'s. Each build also samples shards (particles [i0, N) of a cloud
of N, 8 B off 16 B: i0 = 33,334 of 100k and 333,334 of 1M), each held to
its whole launch's slice bit for bit. A time is the device ms of one
launch (all robots) from CUDA events around replays of a CUDA graph of
launches (`tools/_ab.py:graph_ms`), beside the bytes bound (24 B a
particle over 3.35 TB/s). One JSON line a shape, one with the package
build's branch-free math checked on all 2^24 uniforms
(`motion_cuda.math_mismatches`), then one with the card's name and power
limit. `--sass DIR` writes each build's `cuobjdump -sass` there and prints
each kernel's instruction count.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from slam_tpu_torch.ops import _build, motion_cuda
from slam_tpu_torch.tools import _ab

HBM_BYTES_PER_S = 3.35e12
SLAM_ODOM = (0.02, 2.5, 0.02)
SLAM_ALPHAS = (5e-4, 5e-4, 1e-2, 1e-2)
SHAPES = {"1m": (1, 1_000_000), "100k": (1, 100_000), "fleet_16x100k": (16, 100_000),
          "fleet_16x100003": (16, 100_003), "10k": (1, 10_000), "1000": (1, 1000),
          "256": (1, 256)}
SHARDS = ((100_000, 33_334), (1_000_000, 333_334))
_P = ctypes.c_void_p
# The entry point before the robot axis: one robot a launch.
ONE_ROBOT_ARGTYPES = [_P] * 2 + [ctypes.c_float] * 4 + [_P] * 6 + [ctypes.c_longlong] * 2 + [_P]


def has_robot_axis(source: str) -> bool:
    head = source[source.index('extern "C" int motion_odometry_launch'):]
    return "n_robots" in head[:head.index("{")]


def argtypes(source: str):
    return (_build._SIGNATURES["motion_odometry_launch"] if has_robot_axis(source)
            else ONE_ROBOT_ARGTYPES)


def inputs(r: int, n: int, dev, seed: int) -> dict:
    """Poses [r, n] spread over a 1000 px map, seeds [r], odometry rows
    [r, 3] (the SLAM step's for r = 1) and outputs, on `dev`."""
    rng = np.random.default_rng(seed)
    poses = [torch.from_numpy(v).to(dev) for v in (
        rng.uniform(0, 1000, (r, n)).astype(np.float32),
        rng.uniform(0, 1000, (r, n)).astype(np.float32),
        rng.uniform(-math.pi, math.pi, (r, n)).astype(np.float32))]
    odo = (np.asarray([SLAM_ODOM], np.float32) if r == 1 else np.stack(
        [rng.uniform(-0.1, 0.1, r), rng.uniform(0.5, 3.0, r), rng.uniform(-0.1, 0.1, r)],
        axis=1).astype(np.float32))
    return {"poses": poses, "seed": torch.arange(r, dtype=torch.int64, device=dev) + 100 + seed,
            "odo": torch.from_numpy(odo).to(dev).contiguous(), "r": r, "n": n}


def launcher(lib, robot_axis: bool):
    """fn(case, out, n, i0, first) launching `lib` on `case`'s particles
    [first, first + n) of each row into `out` (three [r, n] tensors)."""
    fn = lib.motion_odometry_launch

    def run(case, out, n, i0=0, first=0):
        stream = torch.cuda.current_stream().cuda_stream
        r, row = case["r"], case["n"]
        ptr = [p.data_ptr() + 4 * first for p in case["poses"]]
        optr = [o.data_ptr() for o in out]
        rows = [(0, r)] if robot_axis else [(q, 1) for q in range(r)]
        for q, k in rows:
            code = fn(case["seed"].data_ptr() + 8 * q, case["odo"].data_ptr() + 12 * q,
                      *(float(a) for a in SLAM_ALPHAS),
                      *(p + 4 * q * row for p in ptr), *(o + 4 * q * n for o in optr),
                      n, i0, *([k] if robot_axis else []), stream)
            _build.check(code, "motion_odometry_launch")
    return run


def bits_equal(a, b) -> bool:
    return all(torch.equal(u.view(torch.int32), v.view(torch.int32)) for u, v in zip(a, b))


def sass_counts(so: Path, dest: Path, name: str) -> dict:
    """{kernel: SASS instructions} of `so`, its dump written to `dest`."""
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"{name}.sass").write_text(text)
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[fn] += 1
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH[::FLAGS]")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--sass", type=Path, default=None, metavar="DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("motion_ab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    builds = _ab.parse_builds(args.other)
    libs = {"new": _ab.own_build(), **_ab.build(builds, "motion_odometry_launch", argtypes)}
    axis = {name: True for name in libs}
    for name, (src, _) in builds.items():
        axis[name] = has_robot_axis(src.read_text())
    runs = {name: launcher(lib, axis[name]) for name, (lib, _, _) in libs.items()}
    for name, (_, report, so) in libs.items():
        for line in report.splitlines():
            if "motion_odometry" in line or "registers" in line:
                print(f"# {name}: {line.strip()}", flush=True)
        if args.sass is not None:
            print(json.dumps({"sass": name, "instructions": sass_counts(so, args.sass, name)}),
                  flush=True)
    names = list(libs)
    ref = "parent" if "parent" in libs else "new"

    # Shards against their whole launch's slices, each build.
    for n, i0 in SHARDS:
        case = inputs(1, n, dev, 4)
        shard = {}
        for name in names:
            whole = [torch.empty_like(p) for p in case["poses"]]
            part = [torch.empty((1, n - i0), device=dev) for _ in range(3)]
            runs[name](case, whole, n)
            runs[name](case, part, n - i0, i0, i0)
            shard[name] = bits_equal([w[:, i0:] for w in whole], part)
        print(json.dumps({"shard": [n, i0], "equals_slice": shard}), flush=True)
        if not all(shard.values()):
            raise RuntimeError(f"a shard at i0 = {i0} of {n} != its slice: {shard}")

    failed = []
    for k, (shape, (r, n)) in enumerate(SHAPES.items()):
        case = inputs(r, n, dev, k)
        outs = {name: [torch.empty_like(p) for p in case["poses"]] for name in names}
        for name in names:
            runs[name](case, outs[name], n)
        torch.cuda.synchronize()
        equal = {name: bits_equal(outs[ref], outs[name]) for name in names if name != ref}
        failed += [f"{shape}: {name}" for name, ok in equal.items() if not ok]
        ms = _ab.in_turns(names, lambda name: lambda: runs[name](case, outs[name], n),
                          case["poses"][0], args.rounds)
        bound = r * n * 24 / HBM_BYTES_PER_S * 1e3
        print(json.dumps({
            "shape": shape, "robots": r, "particles": n, f"bits_equal_{ref}": equal,
            "bound_ms": bound, "bound_share": {name: bound / t["median"] for name, t in ms.items()},
            "ms": ms}), flush=True)
    print(json.dumps({"branch_free_mismatches_of_2^24": motion_cuda.math_mismatches(dev)}),
          flush=True)
    _ab.device_line(rounds=args.rounds)
    if failed:
        raise RuntimeError(f"poses differ from {ref}'s: {failed}")


if __name__ == "__main__":
    main()
