"""The port's top-level entry points: the counterpart of the JAX
package's `__graft_entry__.py`.

`entry(device=None)` returns the flagship step, one full grid-SLAM step
(predict, weight, estimate, map, resample), with example arguments at the
JAX entry's tiny shapes (`__graft_entry__.py:15-50`): 256 particles, 32
beams, a 64x64 `synthetic_room`. `dryrun_multichip(n)` runs one step of
each sharded layout of `__graft_entry__.py:53-173` over a world of n
ranks, one process a rank (`parallel/distributed.py:start_world`).

Where the JAX entry compiles the step (`jax.jit(fn)(*args)`), the port
runs it as one CUDA graph replay (`models/_graph.py:StepGraphs`):

    python -m slam_tpu_torch.entry              # entry() on the card: graph == eager
    python -m slam_tpu_torch.entry --dryrun-rank DIR [--cpu]   # one dryrun rank

Both run on the CUDA card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile

import torch

from slam_tpu_torch.core.config import (
    HybridAStarConfig, LidarConfig, MapConfig, MCLConfig, RaycastConfig, SLAMConfig,
)
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import fake_lidar
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.models import slam as slam_mod
from slam_tpu_torch.models._graph import StepGraphs, _flatten, generators
from slam_tpu_torch.models.simulate import synthetic_room

# The wall clock of a dryrun world, its imports included; ranks left then
# are killed.
DRYRUN_LIMIT_S = 600.0
# The fleet layout's motion noise (`__graft_entry__.py:134`).
FLEET_ALPHAS = (1e-3, 1e-3, 5e-3, 5e-3)


def tiny_setup(n_particles: int, n_beams: int, h: int = 64, w: int = 64, device=None):
    """(cfg, pose, scan, odometry) of `__graft_entry__.py:_tiny_setup` on
    `device`: the room's scan from its center, heading pi / 2."""
    cfg = SLAMConfig(
        mcl=MCLConfig(n_particles=n_particles),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(n_rays=n_beams, max_dist=80.0),
        raycast=RaycastConfig(max_dist=80.0, chunk=32),
    )
    blocked = torch.from_numpy(synthetic_room(h, w)).to(device)
    pose = Pose.create(w / 2.0, h / 2.0, math.pi / 2, device=device)
    scan = fake_lidar.scan(blocked, pose, cfg.lidar, cfg.raycast)
    return cfg, pose, scan, Odometry.create(0.05, 2.0, 0.05)


def entry(device=None):
    """(step_fn, (state, odom, scan)): one full SLAM step on one device, the
    card unless `device="cpu"`. `step_fn` is `slam.step` with the entry's
    config, its beam march run to the whole count (no host read, so a CUDA
    graph can hold it); keyword arguments pass on (`noise=`, `u0=`)."""
    dev = entry_device(device)
    cfg, pose, scan, odom = tiny_setup(256, 32, device=dev)
    state = slam_mod.init(mcl_mod.make_generator(0, dev), cfg, pose)

    def step_fn(state, odom, scan, **draws):
        return slam_mod.step(state, odom, scan, cfg, early_exit=False, **draws)

    return step_fn, (state, odom, scan)


def clone_state(state):
    """A copy of a state (or a tuple of them): its tensors cloned, its
    generators copied with their states; other fields kept."""
    if isinstance(state, tuple):
        return tuple(clone_state(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, torch.Generator):
        g = torch.Generator(device=state.device)
        g.set_state(state.get_state())
        return g
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{f.name: clone_state(getattr(state, f.name))
                                             for f in dataclasses.fields(state)})
    return state


def _bits(t: torch.Tensor) -> torch.Tensor:
    """`t` as integers of its width, so that equality is bit for bit (NaN
    equal to itself)."""
    as_int = {torch.float32: torch.int32, torch.float64: torch.int64,
              torch.bfloat16: torch.int16, torch.float16: torch.int16}.get(t.dtype)
    return t if as_int is None else t.view(as_int)


def state_difference(a, b):
    """The first field where two states differ (tensors bit for bit, host
    fields, generator states), or None."""
    la, ha, lb, hb = {}, {}, {}, {}
    _flatten(a, "", la, ha)
    _flatten(b, "", lb, hb)
    if la.keys() != lb.keys() or ha.keys() != hb.keys():
        return "layout"
    for k, x in la.items():
        y = lb[k]
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(_bits(x), _bits(y)):
            return k
    for k, v in ha.items():
        if not generators({k: v}) and hb[k] != v:
            return k
    for g, h in zip(generators(ha), generators(hb)):
        if not torch.equal(g.get_state(), h.get_state()):
            return "generator state"
    return None


def _finite(state) -> bool:
    """The particles, their estimates and the grid are finite (the weight
    EMAs start as NaN by design)."""
    m = getattr(state, "mcl", state)
    p = m.particles
    ts = [p.pose.x, p.pose.y, p.pose.theta, p.log_weight]
    ts += [getattr(m.best_pose, f) for f in ("x", "y", "theta")]
    if hasattr(state, "grid"):
        ts.append(state.grid)
    return all(bool(torch.isfinite(t).all()) for t in ts)


def _rank_main(outdir: str, cpu: bool) -> None:
    """One rank of `dryrun_multichip`'s world: the JAX dryrun's layouts at
    its shapes over this world's mesh; writes `rank{r}.json` to `outdir`."""
    from slam_tpu_torch.ops import rayfield
    from slam_tpu_torch.parallel import ShardedGridSLAM, ShardedMCLFleet, distributed, make_mesh
    from slam_tpu_torch.parallel.mapshard import MapShardedGridSLAM
    from slam_tpu_torch.parallel.sharded import particle_sharding
    from slam_tpu_torch.planners import HybridAStar

    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if cpu:
        torch.set_num_threads(1)
    dev = distributed.initialize(f"file://{os.path.join(outdir, 'store')}", n, rank,
                                 device="cpu" if cpu else None)
    beam_axis = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n, beam_axis=beam_axis)
    cfg, pose, scan, odom = tiny_setup(16 * n, 16, device=dev)
    table = dict(measurement="likelihood_field_table", lf_table_box=24)
    finite = {}

    def one_step(name, engine, p, z, o):
        finite[name] = _finite(engine.step(engine.init(p), o, z))

    one_step("sharded_slam", ShardedGridSLAM(mesh, cfg), pose, scan, odom)
    if 64 % beam_axis == 0:
        one_step("mapsharded_slam", MapShardedGridSLAM(mesh, cfg), pose, scan, odom)
    if beam_axis == 2:
        # The distributed capped EDT needs blocks of at least its halo: a
        # 128-row map (`__graft_entry__.py:79-87`).
        c128, p128, s128, o128 = tiny_setup(16 * n, 16, h=128, w=128, device=dev)
        c128 = dataclasses.replace(c128, mcl=dataclasses.replace(c128.mcl, **table),
                                   raycast=dataclasses.replace(c128.raycast, backend="sdf"))
        one_step("mapsharded_slam_table128", MapShardedGridSLAM(mesh, c128), p128, s128, o128)
    cfg_t = dataclasses.replace(cfg, mcl=dataclasses.replace(cfg.mcl, **table),
                                raycast=dataclasses.replace(cfg.raycast, backend="sdf"))
    one_step("sharded_slam_table", ShardedGridSLAM(mesh, cfg_t), pose, scan, odom)

    # The fleet: robots over 'p', R = n, each at the room's center.
    blocked = torch.from_numpy(synthetic_room(64, 64)).to(dev)
    field = rayfield.make_ray_field(blocked, cfg.raycast)
    fleet = ShardedMCLFleet(mesh, n, cfg.mcl, cfg.raycast)
    fstates = fleet.init(Pose.create(torch.full((n,), 32.0), torch.full((n,), 32.0),
                                     torch.zeros(n)))
    scans = Scan(angles=scan.angles.expand(n, -1), dists=scan.dists.expand(n, -1))
    odoms = Odometry(*(torch.full((n,), float(v)) for v in (odom.rot1, odom.trans, odom.rot2)))
    fstates = fleet.step(fstates, odoms, scans, field, FLEET_ALPHAS)
    finite["sharded_fleet"] = _finite(fstates)

    # Lattice HA* queries over 'p'.
    hcfg = HybridAStarConfig(velocity=4.0, theta_res=24, branching_factor=3, tol=4.0, batch=32,
                             max_rounds=256, mode="lattice")
    planner = HybridAStar(~synthetic_room(64, 64), Pose.create(12.0, 32.0, 0.0),
                          Pose.create(52.0, 32.0, 0.0), hcfg, device=dev)
    results = planner.solve_many(hastar_queries(n), query_sharding=particle_sharding(mesh))
    if len(results) != n:
        raise RuntimeError(f"solve_many returned {len(results)} results for {n} queries")
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "backend": mesh.backend, "beam_axis": beam_axis,
                   "finite": finite, "hastar": [[bool(s), float(c)] for s, c in results]}, f)
    distributed.shutdown()


def hastar_queries(n: int):
    """The dryrun's n lattice HA* queries (`__graft_entry__.py:163-166`)."""
    return [(Pose.create(12.0, 20.0 + 3.0 * q, 0.0), Pose.create(52.0, 32.0, 0.0))
            for q in range(n)]


def dryrun_multichip(n: int, device=None, timeout_s: float = DRYRUN_LIMIT_S) -> dict:
    """One step of each sharded layout over a world of n ranks, one process
    a rank, as `__graft_entry__.py:dryrun_multichip` runs them over an
    n-device mesh: `ShardedGridSLAM` (march), `MapShardedGridSLAM` (64-row
    map), with |b| = 2 the map-sharded boxed table on a 128-row map, the
    boxed-table `ShardedGridSLAM`, `ShardedMCLFleet` of n robots and n
    lattice HA* queries over 'p'. The ranks run on the card (NCCL when each
    has one of its own, gloo when they share one) unless `device="cpu"`
    (gloo on the CPU). Raises unless every rank exits 0 with finite
    states; returns each rank's report and the HA* (success, cost)."""
    cpu = entry_device(device).type == "cpu"
    from slam_tpu_torch.parallel import distributed

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    tmp = tempfile.mkdtemp(prefix="slam_tpu_torch_dryrun_")
    try:
        argv = [sys.executable, "-m", "slam_tpu_torch.entry", "--dryrun-rank", tmp]
        rcs, _, errs, secs = distributed.launch_world(argv + (["--cpu"] if cpu else []), n,
                                                      timeout_s=timeout_s, env=env, cwd=root)
        if rcs != [0] * n:
            tails = "\n".join(f"rank {r} rc {rc}:\n{e[-3000:]}"
                              for r, (rc, e) in enumerate(zip(rcs, errs)) if rc != 0)
            raise RuntimeError(f"dryrun world of {n} ranks failed: {rcs}\n{tails}")
        ranks = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = {r["rank"]: k for r in ranks for k, ok in r["finite"].items() if not ok}
    if bad:
        raise RuntimeError(f"dryrun: non-finite states (rank: layout) {bad}")
    return {"world": n, "seconds": secs, "ranks": ranks,
            "hastar": [tuple(v) for v in ranks[0]["hastar"]]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun-rank", metavar="DIR",
                    help="run one rank of dryrun_multichip's world (RANK, WORLD_SIZE set)")
    ap.add_argument("--cpu", action="store_true", help="the dryrun rank runs on the CPU")
    args = ap.parse_args(argv)
    if args.dryrun_rank:
        _rank_main(args.dryrun_rank, args.cpu)
        return
    fn, ex = entry()
    eager = fn(*clone_state(ex))
    graphed = StepGraphs().run(fn, *clone_state(ex))
    diff = state_difference(graphed, eager)
    if diff is not None or not _finite(graphed):
        raise SystemExit(f"entry(): the graphed step != the eager step ({diff})")
    print("entry() ok")


if __name__ == "__main__":
    main()
