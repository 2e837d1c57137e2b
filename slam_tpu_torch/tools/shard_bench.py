"""The full sharded SLAM step over a world of ranks (port of
`benchmarks/shard_bench.py`).

Runs `parallel.ShardedGridSLAM` (particles split over 'p', beams over
'b', the grid replicated, the reduce-scatter resampler) at `--particles`
on `--world` ranks and reports each rank's step time and the overhead of
sharding: the sharded step minus the same step on ONE rank at N / |p|
particles (perfect weak scaling), which rank 0 times alone after the
sharded run. The configuration is the JAX tool's: the synthetic floor
plan, 90 beams over pi, max_dist 500, `likelihood_field_table` with
`--table-box` (128 by default), the capped EDT rebuilt in every step.

    python -m slam_tpu_torch.tools.shard_bench --world 2
    python -m slam_tpu_torch.tools.shard_bench --world 2 --particles 4096 --iters 2 \\
        --device cpu     # a functional check over gloo on the CPU

The ranks are subprocesses of this command (`parallel.distributed.
launch_world`) under a wall-clock limit. With one GPU a rank each they
meet over NCCL; with more ranks than GPUs they share the cards over gloo,
and the output says so: their times then measure sharing a card, not
multi-GPU scaling. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import tempfile
import time

import torch


def _configs(n: int, measurement: str, box: int):
    from slam_tpu_torch.core.config import LidarConfig, MCLConfig, MotionConfig
    from slam_tpu_torch.core.config import RaycastConfig, SLAMConfig

    return SLAMConfig(
        mcl=MCLConfig(n_particles=n, meas_stddev=5.0, measurement=measurement,
                      lf_table_box=box or None),
        lidar=LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90),
        motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
        raycast=RaycastConfig(step=0.5, max_dist=500.0, backend="sdf"),
    )


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_steps(step, state, iters: int, dev):
    """(ms per step over `iters` steps, the state after them)."""
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / iters, state


def rank_main(args) -> None:
    import torch.distributed as dist

    from slam_tpu_torch.core.types import Odometry, Pose
    from slam_tpu_torch.models import fake_lidar
    from slam_tpu_torch.models import slam as slam_mod
    from slam_tpu_torch.core.config import RaycastConfig
    from slam_tpu_torch.parallel import ShardedGridSLAM, distributed, make_mesh
    from slam_tpu_torch.utils.maps import synthetic_floor_plan

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    dev = torch.device(args.device if args.device == "cpu" else "cuda",
                       None if args.device == "cpu" else rank % torch.cuda.device_count())
    distributed.initialize(args.init, world, rank, backend=args.backend, device=dev)
    mesh = make_mesh(beam_axis=args.beam_axis)
    p = mesh.shape["p"]
    n = max(p, args.particles - args.particles % p)
    blocked = torch.from_numpy(synthetic_floor_plan()).to(dev)
    cfg = _configs(n, args.measurement, args.table_box)
    pose = Pose.create(400.0, 400.0, math.pi, device=dev)
    scan = fake_lidar.scan(blocked, pose, cfg.lidar, RaycastConfig(max_dist=500.0))
    odom = Odometry.create(2.5, 0.02, 0.02)

    engine = ShardedGridSLAM(mesh, cfg)
    state = engine.init(pose)
    step = lambda s: engine.step(s, odom, scan)  # noqa: E731
    for _ in range(args.warmup):
        state = step(state)
    times = []
    for _ in range(args.repeats):
        dist.barrier()
        ms, state = _time_steps(step, state, args.iters, dev)
        times.append(ms)
    out = {"rank": rank, "step_ms": statistics.median(times), "step_ms_repeats": times,
           "particles": n, "n_local": state.mcl.particles.n}
    dist.barrier()
    if rank == 0:  # the weak-scaling reference, alone: one rank at N / |p|
        cfg_l = _configs(n // p, args.measurement, args.table_box)
        ref = slam_mod.GridSLAM(cfg_l, seed=0, device=dev)
        st = ref.init(pose)
        step_l = lambda s: ref.step(s, odom, scan)  # noqa: E731
        for _ in range(args.warmup):
            st = step_l(st)
        out["one_rank_ms"] = statistics.median(
            _time_steps(step_l, st, args.iters, dev)[0] for _ in range(args.repeats))
    dist.barrier()
    print(json.dumps(out), flush=True)
    distributed.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--world", type=int, default=2, help="ranks (processes)")
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--beam-axis", type=int, default=1)
    ap.add_argument("--measurement", default="likelihood_field_table",
                    choices=["likelihood_field", "likelihood_field_table"])
    ap.add_argument("--table-box", type=int, default=128,
                    help="lf_table_box of the table measurement (0: the dense build)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=600.0, help="the world's wall clock (s)")
    ap.add_argument("--rank-of", dest="init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.init is not None:
        rank_main(args)
        return

    from slam_tpu_torch.parallel import distributed

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("shard_bench: no CUDA device (pass --device cpu for a CPU check)")
    n_gpus = torch.cuda.device_count() if args.device == "cuda" else 0
    sharing = args.device == "cuda" and args.world > n_gpus
    backend = "nccl" if args.device == "cuda" and not sharing else "gloo"
    store = tempfile.mkdtemp(prefix="shard_bench_")
    argv_rank = [sys.executable, "-m", "slam_tpu_torch.tools.shard_bench",
                 *(argv if argv is not None else sys.argv[1:]),
                 "--rank-of", f"file://{store}/store", "--backend", backend]
    rcs, outs, errs, secs = distributed.launch_world(argv_rank, args.world,
                                                     timeout_s=args.timeout)
    if rcs != [0] * args.world:
        for r, (rc, e) in enumerate(zip(rcs, errs)):
            if rc != 0:
                print(f"rank {r} rc {rc}:\n{e[-3000:]}", file=sys.stderr)
        raise SystemExit(f"shard_bench: ranks exited {rcs}")
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    step = max(r["step_ms"] for r in ranks)
    local = ranks[0]["one_rank_ms"]
    device = (torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu")
    print(json.dumps({
        "metric": "shard_slam_step_ms", "value": step, "world": args.world,
        "beam_axis": args.beam_axis, "backend": backend, "particles": ranks[0]["particles"],
        "n_local": ranks[0]["n_local"], "step_ms_per_rank": [r["step_ms"] for r in ranks],
        "one_rank_n_over_p_ms": local, "overhead_ms": step - local,
        "efficiency": local / step, "device": device, "devices": n_gpus,
        "note": ("ranks on the CPU: a functional check, no device time" if n_gpus == 0 else
                 f"{args.world} ranks sharing {n_gpus} card(s) over gloo: not a multi-GPU "
                 "result" if sharing else "one GPU per rank"),
        "seconds": secs,
    }), flush=True)


if __name__ == "__main__":
    main()
