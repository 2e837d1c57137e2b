"""One rank of the parallel tests' worlds (tests/test_torch_parallel.py,
tests/test_torch_mapshard.py, tests/test_torch_distributed.py).

    RANK=r WORLD_SIZE=d python tests/torch_parallel_worker.py SUITE INPUTS OUTDIR

joins a gloo world through a `file://` store in OUTDIR, runs every
scenario of SUITE on the inputs the test module wrote (an .npz made with
numpy from a seed, JAX's draws among them) and writes this rank's results
to OUTDIR/out_r{rank}.npz. It imports torch and the port only; the test
module computes the JAX side and compares. Particle arrays come back
whole (all-gathered over 'p'), so rank 0's file holds the global values;
each rank's own copies of replicated state are kept where a test holds
the ranks to one another.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slam_tpu_torch.core import config as tc  # noqa: E402
from slam_tpu_torch.core.types import Odometry, Particles, Pose, Scan  # noqa: E402
from slam_tpu_torch.models import fake_lidar, mcl, slam  # noqa: E402
from slam_tpu_torch.ops import edt as tedt  # noqa: E402
from slam_tpu_torch.ops import motion, rayfield  # noqa: E402
from slam_tpu_torch.parallel import (  # noqa: E402
    ShardedGridSLAM, ShardedMCL, ShardedMCLFleet, _collectives, distributed, make_mesh,
)
from slam_tpu_torch.parallel import edt as pedt  # noqa: E402
from slam_tpu_torch.parallel import mapshard  # noqa: E402
from slam_tpu_torch.parallel.resample import systematic_resample_sharded  # noqa: E402
from slam_tpu_torch.parallel.sharded import gather_particles  # noqa: E402
from slam_tpu_torch.utils import checkpoint  # noqa: E402

H = W = 64
N = 64


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def scan_of(inp, key="scan"):
    return Scan(angles=t(inp[key + ".angles"]), dists=t(inp[key + ".dists"]))


def local(mesh, a):
    """This rank's shard of a whole [N, ...] array (the 'p' slice)."""
    ax = mesh.axis("p")
    n = a.shape[-1] // ax.size
    return a[..., ax.index * n:(ax.index + 1) * n]


def noise_of(mesh, a):
    return tuple(t(local(mesh, a[k])) for k in range(3))


def cloud(mesh, state, prefix):
    g = gather_particles(mesh, state).numpy()
    m = getattr(state, "mcl", state)
    out = {f"{prefix}.{k}": g[i] for i, k in enumerate(("x", "y", "theta", "lw"))}
    for name in ("best_pose", "mode_pose"):
        p = getattr(m, name)
        out[f"{prefix}.{name}"] = np.array([float(p.x), float(p.y), float(p.theta)])
    out[f"{prefix}.n_local"] = np.array(m.particles.n)
    return out


def slam_cfg(backend="march", **mcl_kw):
    """tests/test_parallel.py's SLAM configuration on the 64 px room."""
    return tc.SLAMConfig(
        mcl=tc.MCLConfig(n_particles=N, **mcl_kw), map=tc.MapConfig(height=H, width=W),
        lidar=tc.LidarConfig(n_rays=16, max_dist=100.0),
        raycast=tc.RaycastConfig(max_dist=100.0, chunk=32, backend=backend),
    )


ODOM_MCL = (0.1, 2.0, 0.1)
ODOM_SLAM = (0.05, 2.0, 0.05)
ALPHAS = (1e-3, 1e-3, 1e-3, 1e-3)


# ---------------------------------------------------------------------------
# suite "parallel": tests/test_torch_parallel.py
# ---------------------------------------------------------------------------


def sc_mcl(inp, world):
    out = {}
    blocked = t(inp["blocked"], torch.bool)
    rc = tc.RaycastConfig(max_dist=100.0, chunk=32)
    cfg = tc.MCLConfig(n_particles=N, ess_threshold=0.0)
    for ba in (1, 2):
        mesh = make_mesh(beam_axis=ba)
        m = ShardedMCL(mesh, cfg, rc)
        st = m.init(H, W)
        st = mcl.predict(st, Odometry.create(*ODOM_MCL), ALPHAS,
                         noise=noise_of(mesh, inp["mcl.noise"]), ray_sharding=m.sharding)
        st = m.update(st, scan_of(inp), blocked)
        out.update(cloud(mesh, st, f"mcl_b{ba}"))
    return out


def sc_slam_table(inp, world):
    out = {}
    mesh = make_mesh(beam_axis=2)
    pose = Pose.create(W / 2.0, H / 2.0, math.pi / 2)
    for box in (0, 40):
        cfg = slam_cfg("sdf", measurement="likelihood_field_table", lf_table_box=box or None,
                       ess_threshold=0.0)
        eng = ShardedGridSLAM(mesh, cfg)
        st = eng.init(pose)
        st = slam.step(st, Odometry.create(*ODOM_SLAM), scan_of(inp), cfg,
                       ray_sharding=eng.sharding, noise=noise_of(mesh, inp["slam.noise"]),
                       u0=t(inp["slam.u0"]))
        out.update(cloud(mesh, st, f"table{box}"))
        out[f"table{box}.grid"] = st.grid.numpy()
    # auto tier == forced table, one converged step each (the engine's own
    # draws: the same generator state on both).
    auto_cfg = slam_cfg("sdf", measurement="likelihood_field_auto", lf_table_box=40,
                        ess_threshold=0.0)
    forced_cfg = dataclasses.replace(
        auto_cfg, mcl=dataclasses.replace(auto_cfg.mcl, measurement="likelihood_field_table"))
    auto = ShardedGridSLAM(mesh, auto_cfg)
    st_a = auto.step(auto.init(pose), Odometry.create(*ODOM_SLAM), scan_of(inp))
    forced = ShardedGridSLAM(mesh, forced_cfg)
    st_f = forced.step(forced.init(pose), Odometry.create(*ODOM_SLAM), scan_of(inp))
    out["auto.converged"] = np.array(bool(auto._auto.converged))
    out.update(cloud(mesh, st_a, "auto"))
    out.update(cloud(mesh, st_f, "forced"))
    # The table's heading bins over 'b' (|b| = 2) for bin counts it divides
    # and does not (1 bin: one rank builds none), against one rank's build.
    from slam_tpu_torch.ops import measurement
    from slam_tpu_torch.parallel.sharded import ray_sharding

    edt = tedt.edt_capped(t(inp["blocked"], torch.bool), 27.0)
    lf = dict(rc=tc.RaycastConfig(max_dist=100.0), stddev=5.0, z_hit=0.9, z_rand=0.1)
    for bins in (1, 5, 8):
        heads = torch.linspace(-math.pi, math.pi, bins + 1)[:bins]
        want = measurement.lf_score_table(edt, scan_of(inp), heads, **lf)
        got = measurement.lf_score_table(edt, scan_of(inp), heads, **lf,
                                         bin_sharding=ray_sharding(mesh))
        out[f"bins{bins}.same"] = np.array(bool(torch.equal(got, want)))
    # Two steps of the march beam model on a (D/2, 2) mesh: the grid moves,
    # the particles stay split over 'p'.
    eng = ShardedGridSLAM(mesh, slam_cfg())
    st = eng.init(pose)
    for _ in range(2):
        st = eng.step(st, Odometry.create(0.0, 2.0, 0.0), scan_of(inp))
    out["beam.grid_abs"] = np.array(float(st.grid.abs().sum()))
    out["beam.n_local"] = np.array(st.mcl.particles.n)
    return out


def sc_resample(inp, world):
    out = {}
    for ba in (1, 2):
        mesh = make_mesh(beam_axis=ba)
        for k in range(int(inp["rs.cases"])):
            lw = inp[f"rs.lw{k}"]
            n = lw.shape[0]
            ar = np.arange(n, dtype=np.float32)
            p = Particles(pose=Pose(x=t(local(mesh, ar)), y=t(local(mesh, ar * 2.0)),
                                    theta=t(local(mesh, ar * 1e-3))),
                          log_weight=t(local(mesh, lw)))
            got = systematic_resample_sharded(mesh, p, u0=t(inp[f"rs.u0{k}"]))
            g = mesh.axis("p").all_gather(torch.stack([got.pose.x, got.pose.y,
                                                       got.pose.theta]))
            out[f"rs_b{ba}.{k}"] = g.permute(1, 0, 2).reshape(3, -1).numpy()
            out[f"rs_b{ba}.{k}.n_local"] = np.array(got.pose.x.shape[0])
    # The sharded MCL update at 4096 particles: what its collectives move.
    mesh = make_mesh(beam_axis=1)
    n = 4096
    m = ShardedMCL(mesh, tc.MCLConfig(n_particles=n), tc.RaycastConfig(max_dist=100.0, chunk=32))
    st = m.init(H, W)
    st = m.predict(st, Odometry.create(*ODOM_MCL), ALPHAS)
    _collectives.reset_counts()
    st = m.update(st, scan_of(inp), t(inp["blocked"], torch.bool))
    c = _collectives.counts()
    for k, v in c.items():
        out[f"counts.{k}"] = np.array(v)
    return out


def sc_lut(inp, world):
    mesh = make_mesh(beam_axis=2)
    rc = tc.RaycastConfig(max_dist=100.0, backend="lut", lut_bins=64)
    field = rayfield.make_ray_field(t(inp["blocked"], torch.bool), rc)
    m = ShardedMCL(mesh, tc.MCLConfig(n_particles=N), rc)
    st = m.init(H, W)
    st = mcl.update(st, scan_of(inp, "lutscan"), field, m.cfg, rc, ray_sharding=m.sharding,
                    resample_fn=m._rfn, u0=t(inp["lut.u0"]))
    return cloud(mesh, st, "lut")


def sc_fleet(inp, world):
    mesh = make_mesh(beam_axis=1)
    r = 8
    rc = tc.RaycastConfig(max_dist=100.0, chunk=32)
    cfg = tc.MCLConfig(n_particles=32, meas_stddev=3.0)
    field = rayfield.make_ray_field(t(inp["blocked"], torch.bool), rc)
    alphas = (1e-3, 1e-3, 5e-3, 5e-3)
    poses = Pose(x=t(inp["fleet.x"]), y=t(inp["fleet.y"]), theta=t(inp["fleet.theta"]))
    scans = Scan(angles=t(inp["fleet.angles"]), dists=t(inp["fleet.dists"]))
    odoms = Odometry(*(torch.full((r,), v) for v in (0.05, 1.0, 0.05)))
    sf = ShardedMCLFleet(mesh, r, cfg, rc, seed=3)
    st = sf.init(poses)
    _collectives.reset_counts()
    for _ in range(2):
        st = sf.step(st, odoms, scans, field, alphas)
    out = {"fleet.calls": np.array(_collectives.counts()["calls"])}
    g = mesh.axis("p").all_gather(torch.stack([st.particles.pose.x, st.particles.pose.y,
                                               st.particles.pose.theta]))  # [D, 3, R/D, n]
    out["fleet.pose"] = g.permute(1, 0, 2, 3).reshape(3, r, -1).numpy()
    out["fleet.n_local"] = np.array(st.particles.pose.x.shape[0])
    return out


def sc_checkpoint(inp, world, outdir):
    mesh = make_mesh(beam_axis=2)
    cfg = slam_cfg()
    pose = Pose.create(W / 2.0, H / 2.0, math.pi / 2)
    eng = ShardedGridSLAM(mesh, cfg)
    st = eng.step(eng.init(pose), Odometry.create(*ODOM_SLAM), scan_of(inp))
    path = os.path.join(outdir, f"ckpt_r{torch.distributed.get_rank()}")
    checkpoint.save(path, st)
    restored = checkpoint.restore(path, eng.init(pose))
    same = all(_same(a, b) for a, b in _tensors(st, restored))
    same &= torch.equal(st.mcl.generator.get_state(), restored.mcl.generator.get_state())
    a = eng.step(st, Odometry.create(*ODOM_SLAM), scan_of(inp))
    b = eng.step(restored, Odometry.create(*ODOM_SLAM), scan_of(inp))
    same_next = all(_same(x, y) for x, y in _tensors(a, b))
    return {"ckpt.same": np.array(bool(same)), "ckpt.same_next": np.array(bool(same_next)),
            "ckpt.n_local": np.array(restored.mcl.particles.n)}


def _same(a, b):
    """Equal values, NaN where NaN (the weight EMAs before their first
    update)."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.all((a == b) | (torch.isnan(a) & torch.isnan(b))))


def _tensors(a, b):
    if isinstance(a, torch.Tensor):
        yield a, b
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            yield from _tensors(getattr(a, f.name), getattr(b, f.name))


def sc_kidnap(inp, world):
    """torch_port.kidnap_errors('torch', seed) through ShardedMCL."""
    seed = int(inp["kidnap.seed"])
    mesh = make_mesh(beam_axis=2 if world == 4 else 1)
    blocked = torch.from_numpy(inp["room128"])
    rc = tc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    field = rayfield.RayField(blocked=blocked, edt=tedt.edt_jfa(blocked))
    cfg = tc.MCLConfig(n_particles=1024, meas_stddev=3.0, measurement="likelihood_field",
                       adaptive=tc.AdaptiveConfig(max_ratio=0.1))
    lidar = tc.LidarConfig(max_dist=60.0, n_rays=36)
    m = ShardedMCL(mesh, cfg, rc)
    gt = Pose.create(40.0, 40.0, 0.3)
    from slam_tpu_torch.parallel.sharded import shard_state
    st = shard_state(mcl.init(seed, 1024, gt), mesh, 1024)
    odom, g, errs = Odometry.create(0.03, 1.2, 0.03), mcl.make_generator(seed + 100), []
    for k in range(50):
        if k == 10:
            gt = Pose.create(90.0, 90.0, -0.8)
        gt = motion.sample_motion_model_odometry(odom, gt, (0.002,) * 4, generator=g)
        st = m.update(m.predict(st, odom, (0.002,) * 4),
                      fake_lidar.scan(blocked, gt, lidar, rc), field)
        errs.append(math.hypot(float(st.mode_pose.x - gt.x), float(st.mode_pose.y - gt.y)))
    return {"kidnap.errs": np.array(errs), "kidnap.n_local": np.array(st.particles.n)}


def sc_edt_box(inp, world):
    hh = 128
    mesh = make_mesh(beam_axis=2)
    cfg = tc.SLAMConfig(
        mcl=tc.MCLConfig(n_particles=64, meas_stddev=1.0, measurement="likelihood_field_table"),
        map=tc.MapConfig(height=hh, width=hh), lidar=tc.LidarConfig(n_rays=16, max_dist=50.0),
        raycast=tc.RaycastConfig(step=1.0, max_dist=50.0, backend="sdf"), edt_box=72)
    eng = ShardedGridSLAM(mesh, cfg)
    st = eng.init(Pose.create(hh / 2.0, hh / 2.0, math.pi / 2))
    for k in range(3):
        st = slam.step(st, Odometry.create(0.05, 1.5, 0.05), scan_of(inp, "ebscan"), cfg,
                       ray_sharding=eng.sharding, resample_fn=_rfn(eng),
                       noise=noise_of(mesh, inp[f"eb.noise{k}"]),
                       u0=t(inp[f"eb.u0{k}"]))
    out = cloud(mesh, st, "eb")
    out["eb.grid"] = st.grid.numpy()
    out["eb.edt"] = st.edt.numpy()
    return out


def _rfn(eng):
    from slam_tpu_torch.parallel.sharded import _resample_fn
    return _resample_fn(eng.mesh, eng.cfg.mcl)


def sc_scanmatch(inp, world):
    mesh = make_mesh(beam_axis=2)
    cfg = dataclasses.replace(slam_cfg(ess_threshold=0.0), scanmatch=tc.ScanMatchConfig())
    eng = ShardedGridSLAM(mesh, cfg)
    st = eng.init(Pose.create(W / 2.0, H / 2.0, math.pi / 2))
    st = slam.step(st, Odometry.create(*ODOM_SLAM), scan_of(inp), cfg, ray_sharding=eng.sharding,
                   noise=noise_of(mesh, inp["slam.noise"]), u0=t(inp["slam.u0"]))
    out = cloud(mesh, st, "sm")
    e = st.est_pose
    out["sm.est"] = np.array([float(e.x), float(e.y), float(e.theta)])
    return out


def sc_block_routes(inp, world):
    """Each engine's block route (`StepGraphs`: eager blocks over gloo,
    one CUDA graph replay a step over NCCL) against the eager free
    functions from cloned states, two steps: equal bit for bit (tensors,
    counters, generators), with the same collectives counted a step."""
    from slam_tpu_torch.entry import clone_state, state_difference
    from slam_tpu_torch.models import fleet as fleet_mod
    from slam_tpu_torch.parallel.sharded import _resample_fn

    out = {}
    mesh = make_mesh(beam_axis=2)
    blocked = t(inp["blocked"], torch.bool)
    scan = scan_of(inp)
    pose = Pose.create(W / 2.0, H / 2.0, math.pi / 2)
    rc = tc.RaycastConfig(max_dist=100.0, chunk=32)
    mcfg = tc.MCLConfig(n_particles=N, ess_threshold=0.5)
    m = ShardedMCL(mesh, mcfg, rc)
    odom = Odometry.create(*ODOM_MCL)
    scfg = slam_cfg()
    eng = ShardedGridSLAM(mesh, scfg)
    ms = mapshard.MapShardedGridSLAM(mesh, scfg)
    fcfg = tc.MCLConfig(n_particles=32, meas_stddev=3.0)
    field = rayfield.make_ray_field(blocked, rc)
    r = 8
    sf = ShardedMCLFleet(mesh, r, fcfg, rc, seed=3)
    poses = Pose(x=t(inp["fleet.x"]), y=t(inp["fleet.y"]), theta=t(inp["fleet.theta"]))
    scans = Scan(angles=t(inp["fleet.angles"]), dists=t(inp["fleet.dists"]))
    odoms = Odometry(*(torch.full((r,), v) for v in (0.05, 1.0, 0.05)))
    mine = Scan(angles=scans.angles[sf.robots], dists=scans.dists[sf.robots])
    alphas = (1e-3, 1e-3, 5e-3, 5e-3)
    cases = {
        "mcl_step": (m.init(H, W),
                     lambda s: m.step(s, odom, ALPHAS, scan, blocked),
                     lambda s: mcl.step(s, odom, ALPHAS, scan, blocked, mcfg, rc,
                                        ray_sharding=m.sharding, resample_fn=m._rfn)),
        "mcl_predict_update": (
            m.init(H, W),
            lambda s: m.update(m.predict(s, odom, ALPHAS), scan, blocked),
            lambda s: mcl.update(mcl.predict(s, odom, ALPHAS, ray_sharding=m.sharding), scan,
                                 blocked, mcfg, rc, ray_sharding=m.sharding, resample_fn=m._rfn)),
        "slam": (eng.init(pose),
                 lambda s: eng.step(eng.predict(s, odom), Odometry.create(*ODOM_SLAM), scan),
                 lambda s: slam.step(slam.predict_only(s, odom, scfg, ray_sharding=eng.sharding),
                                     Odometry.create(*ODOM_SLAM), scan, scfg,
                                     ray_sharding=eng.sharding, resample_fn=_rfn(eng))),
        "mapshard": (ms.init(pose),
                     lambda s: ms.step(ms.predict(s, odom), Odometry.create(*ODOM_SLAM), scan),
                     lambda s: ms.eager_step(
                         slam.predict_only(s, odom, scfg, ray_sharding=ms.sharding),
                         Odometry.create(*ODOM_SLAM), scan)),
        "fleet": (sf.init(poses),
                  lambda s: sf.step(s, odoms, scans, field, alphas),
                  lambda s: fleet_mod.fleet_step(s, Odometry(*(v[sf.robots] for v in (
                      odoms.rot1, odoms.trans, odoms.rot2))), mine, field, alphas, fcfg, rc)),
    }
    for name, (st, block, eager) in cases.items():
        a, b = st, clone_state(st)
        same = counts_same = True
        for _ in range(2):
            _collectives.reset_counts()
            a = block(a)
            ca = _collectives.counts()
            _collectives.reset_counts()
            b = eager(b)
            same &= state_difference(a, b) is None
            counts_same &= ca == _collectives.counts()
        out[f"routes.{name}.same"] = np.array(same)
        out[f"routes.{name}.counts_same"] = np.array(counts_same)
        out[f"routes.{name}.calls"] = np.array(ca["calls"])
    return out


# ---------------------------------------------------------------------------
# suite "mapshard": tests/test_torch_mapshard.py
# ---------------------------------------------------------------------------


def _block_of(mesh, a):
    return a[mapshard.grid_rows(mesh, a.shape[0])]


def _gather_rows(mesh, blk):
    """The whole map from the row blocks over 'b'."""
    g = mesh.axis("b").all_gather(blk.contiguous())
    return g.reshape((-1,) + tuple(blk.shape[1:]))


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def sc_map_ops(inp, world):
    out = {}
    mesh = make_mesh(beam_axis=world)  # every rank a row block
    blocked = t(inp["blocked"], torch.bool)
    d, hit = mapshard.raycast_march_sharded(
        mesh, _block_of(mesh, blocked), t(inp["rays.x"]), t(inp["rays.y"]), t(inp["rays.th"]),
        full_h=blocked.shape[0], step=0.7, max_dist=90.0)
    out["march.dist"], out["march.hit"] = d.numpy(), hit.numpy()
    cfg = map_cfg()
    pose = Pose.create(30.0, 30.0, 0.8)
    g = mapshard.scan_logodds_update_sharded(
        mesh, torch.zeros((H // world, W)), pose, scan_of(inp, "mapscan"), cfg=cfg, full_h=H)
    out["mapping.grid"] = _gather_rows(mesh, g).numpy()
    for k in range(int(inp["edt.cases"])):
        b = t(inp[f"edt.blocked{k}"], torch.bool)
        cap = float(inp[f"edt.cap{k}"])
        jfa = pedt.edt_jfa_sharded(mesh, _block_of(mesh, b), max_dist=cap, full_shape=b.shape)
        cap_e = pedt.edt_capped_sharded(mesh, _block_of(mesh, b), max_dist=cap,
                                        full_shape=b.shape)
        out[f"edt.jfa{k}"] = _gather_rows(mesh, jfa).numpy()
        out[f"edt.capped{k}"] = _gather_rows(mesh, cap_e).numpy()
    small = torch.zeros((32, 64), dtype=torch.bool)
    out["refuse.jfa"] = np.array(_refusal(lambda: pedt.edt_jfa_sharded(
        mesh, _block_of(mesh, small), max_dist=30.0, full_shape=small.shape)))
    out["refuse.capped"] = np.array(_refusal(lambda: pedt.edt_capped_sharded(
        mesh, _block_of(mesh, small), max_dist=30.0, full_shape=small.shape)))
    # The LF window of a box partly off the map, and the direct LF.
    edt = t(inp["lfw.edt"])
    pad = int(inp["lfw.pad"])
    si, i0, j0 = 24, 5, 60
    win = pedt.lf_window_sharded(
        mesh, _block_of(mesh, edt), i0 - pad, j0 - pad, out_shape=(si + 2 * pad, si + 2 * pad),
        full_shape=edt.shape, stddev=2.0, z_hit=0.95, z_rand=0.05, max_dist=30.0)
    out["lfw.window"] = win.numpy()
    edt64 = t(inp["dlf.edt"])
    poses = Pose(x=t(inp["dlf.x"]), y=t(inp["dlf.y"]), theta=t(inp["dlf.th"]))
    out["dlf.lw"] = pedt.lf_log_weights_sharded(
        mesh, _block_of(mesh, edt64), poses, scan_of(inp, "mapscan"), rc=cfg.raycast,
        full_shape=edt64.shape, scanner_offset=cfg.mcl.scanner_offset,
        stddev=cfg.mcl.meas_stddev).numpy()
    return out


def map_cfg(size=H, measurement="beam", box=None, backend="march"):
    return tc.SLAMConfig(
        mcl=tc.MCLConfig(n_particles=N, meas_stddev=3.0, measurement=measurement,
                         lf_table_box=box),
        map=tc.MapConfig(height=size, width=size),
        lidar=tc.LidarConfig(n_rays=16, max_dist=60.0),
        motion=tc.MotionConfig(alphas=(1e-3, 1e-3, 1e-3, 1e-3)),
        raycast=tc.RaycastConfig(step=1.0, max_dist=60.0, chunk=16, backend=backend),
    )


def sc_map_slam(inp, world):
    out = {}
    mesh = make_mesh(beam_axis=2)  # (D / 2) particle shards x 2 row blocks
    for name, size, meas, box, backend, steps in (
            ("beam", H, "beam", None, "march", 2),
            ("lf", 128, "likelihood_field", None, "sdf", 3),
            ("lft", 128, "likelihood_field_table", 32, "sdf", 3)):
        cfg = map_cfg(size, meas, box, backend)
        eng = mapshard.MapShardedGridSLAM(mesh, cfg)
        st = eng.init(Pose.create(size / 2.0, size / 2.0, math.pi / 2))
        for k in range(steps):
            st = eng.eager_step(st, Odometry.create(0.05, 1.5, 0.05),
                                scan_of(inp, f"ms.{name}.scan"),
                                noise=noise_of(mesh, inp[f"ms.noise{k}"]),
                                u0=t(inp[f"ms.u0{k}"]))
        out.update(cloud(mesh, st, f"ms.{name}"))
        out[f"ms.{name}.grid"] = _gather_rows(mesh, st.grid).numpy()
        out[f"ms.{name}.block_rows"] = np.array(st.grid.shape[0])
    sm = dataclasses.replace(map_cfg(), scanmatch=tc.ScanMatchConfig())
    out["refuse.scanmatch"] = np.array(_refusal(lambda: mapshard.MapShardedGridSLAM(mesh, sm)))
    out["refuse.auto"] = np.array(_refusal(lambda: mapshard.MapShardedGridSLAM(
        mesh, map_cfg(128, "likelihood_field_auto", 32, "sdf"))))
    out["refuse.nobox"] = np.array(_refusal(lambda: mapshard.MapShardedGridSLAM(
        mesh, map_cfg(128, "likelihood_field_table", None, "sdf"))))
    out["refuse.edt_box"] = np.array(_refusal(lambda: mapshard.MapShardedGridSLAM(
        mesh, dataclasses.replace(map_cfg(128, "likelihood_field_table", 32, "sdf"),
                                  edt_box=72))))
    return out


# ---------------------------------------------------------------------------
# suite "distributed": tests/test_torch_distributed.py
# ---------------------------------------------------------------------------


def sc_distributed(inp, world):
    rank = torch.distributed.get_rank()
    sl = distributed.host_local_slice(64)
    got = distributed.replicate_to_all_hosts(
        {"a": torch.arange(3) + 10 * rank, "b": 1.5 + rank, "c": [rank, "x"]})
    out = {"dist.multihost": np.array(distributed.is_multihost()),
           "dist.slice": np.array([sl.start, sl.stop]),
           "dist.a": got["a"].numpy(), "dist.b": np.array(got["b"]),
           "dist.c0": np.array(got["c"][0]),
           "dist.refuse_mesh": np.array(_refusal(lambda: make_mesh(beam_axis=3)))}
    # A ShardedMCL predict -> update over the world against one process
    # running the unsharded filter on every particle, held on each rank.
    mesh = make_mesh()
    blocked = t(inp["blocked"], torch.bool)
    rc = tc.RaycastConfig(max_dist=100.0, chunk=32)
    cfg = tc.MCLConfig(n_particles=N)
    m = ShardedMCL(mesh, cfg, rc)
    st = m.update(m.predict(m.init(H, W), Odometry.create(*ODOM_MCL), ALPHAS),
                  scan_of(inp), blocked)
    one = mcl.init(0, N, mcl.starting_pose(H, W))
    one = mcl.update(mcl.predict(one, Odometry.create(*ODOM_MCL), ALPHAS), scan_of(inp),
                     blocked, cfg, rc)
    whole = gather_particles(mesh, st)
    p = one.particles
    want = torch.stack([p.pose.x, p.pose.y, p.pose.theta, p.log_weight])
    out["dist.step_max_diff"] = np.array(float((whole - want).abs().max()))
    out["dist.best_diff"] = np.array(max(abs(float(getattr(st.best_pose, f)
                                                   - getattr(one.best_pose, f)))
                                         for f in ("x", "y", "theta")))
    out["dist.n_local"] = np.array(st.particles.n)
    # Multinomial resampling keeps the plain resampler over the gathered
    # cloud: the same draws as one process.
    mcfg = tc.MCLConfig(n_particles=N, resample="multinomial")
    mm = ShardedMCL(mesh, mcfg, rc)
    st = mm.update(mm.predict(mm.init(H, W), Odometry.create(*ODOM_MCL), ALPHAS),
                   scan_of(inp), blocked)
    one = mcl.init(0, N, mcl.starting_pose(H, W))
    one = mcl.update(mcl.predict(one, Odometry.create(*ODOM_MCL), ALPHAS), scan_of(inp),
                     blocked, mcfg, rc)
    p = one.particles
    want = torch.stack([p.pose.x, p.pose.y, p.pose.theta, p.log_weight])
    out["dist.multinomial_max_diff"] = np.array(
        float((gather_particles(mesh, st) - want).abs().max()))

    # Lattice HA* queries spread over the ranks against all of them on one.
    from slam_tpu_torch.core.config import HybridAStarConfig
    from slam_tpu_torch.planners import HybridAStar
    from slam_tpu_torch.parallel.sharded import particle_sharding

    q = inp["ha.queries"]
    cfg = HybridAStarConfig(velocity=4.0, length=4.0 / math.tan(40 * math.pi / 180) * 2,
                            theta_res=12, branching_factor=3, tol=4.0, batch=64,
                            mode="lattice")
    queries = [(Pose.create(*a), Pose.create(*b)) for a, b in q]
    hp = HybridAStar(inp["ha.free"], queries[0][0], queries[0][1], cfg, device="cpu")
    want = hp.solve_many(queries, 400)
    want_paths = [hp.recover_path_for(k) for k in range(len(q))]
    got = hp.solve_many(queries, 400, query_sharding=particle_sharding(mesh))
    out["ha.same"] = np.array(got == want and all(
        hp.recover_path_for(k) == want_paths[k] for k in range(len(q))))
    out["ha.solved"] = np.array(sum(s for s, _ in got))
    return out


SUITES = {
    "distributed": [sc_distributed],
    "mapshard": [sc_map_ops, sc_map_slam],
    "parallel": [sc_mcl, sc_slam_table, sc_resample, sc_lut, sc_fleet, sc_checkpoint,
                 sc_kidnap, sc_edt_box, sc_scanmatch, sc_block_routes],
}


def main():
    suite, inputs, outdir = sys.argv[1:4]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    distributed.initialize(f"file://{os.path.join(outdir, 'store')}", world, rank,
                           device="cpu")
    inp = dict(np.load(inputs))
    out = {}
    for fn in SUITES[suite]:
        if fn.__code__.co_argcount == 3:
            out.update(fn(inp, world, outdir))
        else:
            out.update(fn(inp, world))
    np.savez(os.path.join(outdir, f"out_r{rank}.npz"), **out)
    distributed.shutdown()


if __name__ == "__main__":
    main()
