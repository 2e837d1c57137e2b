"""slam_tpu_torch's multi-robot fleet (`models/fleet.py`) against
`slam_tpu.models.fleet` with JAX's draws injected (tests/test_fleet.py's
two cases), against R independent port filters bit for bit, and the
batched systematic resampler against the 1-D one and JAX's."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import LidarConfig as JLidar
from slam_tpu.core.config import MCLConfig as JMCLConfig
from slam_tpu.core.config import RaycastConfig as JRaycast
from slam_tpu.core.types import Odometry as JOdometry
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.models import fleet as jfleet
from slam_tpu.ops import motion as jmotion
from slam_tpu.ops import rayfield as jrf
from slam_tpu.ops import resample as jres
from slam_tpu.ops.measurement import sensor_pose as jsensor_pose
from slam_tpu_torch.core import config as tcfg
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import fake_lidar as tfake
from slam_tpu_torch.models import fleet as tfleet
from slam_tpu_torch.models import mcl as tmcl
from slam_tpu_torch.ops import rayfield as trf
from slam_tpu_torch.ops import resample as tres
from slam_tpu_torch.utils import convert
from torch_port import jax_noise, np_, room

ALPHAS = (1e-3, 1e-3, 5e-3, 5e-3)
KW = dict(step=1.0, max_dist=60.0, backend="sdf")


def _jax_setup(n_particles):
    blocked = jnp.asarray(room(96, 96))
    rc = JRaycast(**KW)
    cfg = JMCLConfig(n_particles=n_particles, meas_stddev=3.0)
    return blocked, rc, JLidar(n_rays=24, max_dist=60.0), cfg, jrf.make_ray_field(blocked, rc)


def _port_setup(n_particles):
    rc = tcfg.RaycastConfig(**KW)
    field = trf.make_ray_field(torch.from_numpy(room(96, 96)), rc)
    return rc, tcfg.MCLConfig(n_particles=n_particles, meas_stddev=3.0), field


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _t_scans(scans):
    return Scan(angles=torch.stack([convert.tensor(np.asarray(s.angles)) for s in scans]),
                dists=torch.stack([convert.tensor(np.asarray(s.dists)) for s in scans]))


def _jax_draws(states, n):
    """Each robot's predict noise and resampler draw, as `mcl.predict` and
    `mcl.update` take them from its key: (noise per robot, u0 [R])."""
    noise, u0 = [], []
    for q in range(states.key.shape[0]):
        key, sub = jax.random.split(states.key[q])
        noise.append(jax_noise(sub, (n,)))
        _, k_rs, _ = jax.random.split(key, 3)
        u0.append(float(jax.random.uniform(k_rs, ())))
    return noise, torch.tensor(u0)


def _t_state(jstates, seed=0):
    """A JAX fleet state as a port fleet state (through utils.convert)."""
    p = jstates.particles
    r = p.log_weight.shape[0]
    st = tfleet.init_fleet(seed, r, p.log_weight.shape[1], convert.pose(
        jstates.best_pose.x, jstates.best_pose.y, jstates.best_pose.theta))
    return st.replace(
        particles=convert.particles(p.pose.x, p.pose.y, p.pose.theta, p.log_weight),
        mode_pose=convert.pose(jstates.mode_pose.x, jstates.mode_pose.y, jstates.mode_pose.theta),
        step=int(jstates.step[0]), updates=int(jstates.updates[0]))


def test_fleet_matches_jax_fleet():
    """tests/test_fleet.py::test_fleet_matches_independent_filters through
    the port: 3 robots x 128 particles, 3 steps, each step from the JAX
    fleet's carried state with its draws injected; poses and log weights
    within that test's tolerances (rtol 1e-5, atol 1e-4)."""
    blocked, rc, lidar, cfg, field = _jax_setup(128)
    trc, tc, tfield = _port_setup(128)
    starts = [JPose.create(30.0, 30.0, 0.3), JPose.create(60.0, 40.0, 2.0),
              JPose.create(45.0, 60.0, -1.2)]
    odom = JOdometry.create(0.05, 1.5, 0.05)
    scans = [jfake.scan(blocked, jsensor_pose(p, cfg.scanner_offset), lidar, rc) for p in starts]
    fl = jfleet.MCLFleet(3, cfg, rc, seed=7)
    states = fl.init(_stack(starts))
    odoms = Odometry.create([0.05] * 3, [1.5] * 3, [0.05] * 3)
    for _ in range(3):
        noise, u0 = _jax_draws(states, 128)
        tstates = tfleet.fleet_step(_t_state(states), odoms, _t_scans(scans), tfield, ALPHAS,
                                    tc, trc, u0=u0, noise=noise)
        states = fl.step(states, _stack([odom] * 3), _stack(scans), field, jnp.asarray(ALPHAS))
        p, tp = states.particles, tstates.particles
        for jv, tv in ((p.pose.x, tp.pose.x), (p.pose.y, tp.pose.y),
                       (p.log_weight, tp.log_weight)):
            np.testing.assert_allclose(np_(tv), np.asarray(jv), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(np_(tfleet.mean_poses(tstates).x),
                                   np.asarray(jfleet.mean_poses(states).x), rtol=1e-5)


def test_fleet_localizes_all_robots_like_jax():
    """tests/test_fleet.py::test_fleet_localizes_all_robots through the
    port: 2 robots x 192 particles, 10 steps of JAX's ground truth, the
    port's fleet fed JAX's draws from its own keys; both fleets end within
    the test's 6 px of the truth and within 0.5 px of each other."""
    blocked, rc, lidar, cfg, field = _jax_setup(192)
    trc, tc, tfield = _port_setup(192)
    gt = [JPose.create(30.0, 30.0, 0.3), JPose.create(60.0, 50.0, 2.0)]
    fl = jfleet.MCLFleet(2, cfg, rc, seed=1)
    states = fl.init(_stack(gt))
    tstates = _t_state(states)
    key = jax.random.key(5)
    odom = JOdometry.create(0.05, 1.2, 0.05)
    odoms = Odometry.create([0.05] * 2, [1.2] * 2, [0.05] * 2)
    for _ in range(10):
        key, *ks = jax.random.split(key, 3)
        gt = [jmotion.sample_motion_model_odometry(ks[q], odom, gt[q], jnp.asarray(ALPHAS))
              for q in range(2)]
        scans = [jfake.scan(blocked, jsensor_pose(p, cfg.scanner_offset), lidar, rc) for p in gt]
        noise, u0 = _jax_draws(states, 192)
        tstates = tfleet.fleet_step(tstates, odoms, _t_scans(scans), tfield, ALPHAS, tc, trc,
                                    u0=u0, noise=noise)
        states = fl.step(states, _stack([odom] * 2), _stack(scans), field, jnp.asarray(ALPHAS))
    jmp, tmp = jfleet.mean_poses(states), tfleet.mean_poses(tstates)
    for q in range(2):
        terr = math.hypot(float(tmp.x[q]) - float(gt[q].x), float(tmp.y[q]) - float(gt[q].y))
        jerr = math.hypot(float(jmp.x[q]) - float(gt[q].x), float(jmp.y[q]) - float(gt[q].y))
        assert terr < 6.0 and jerr < 6.0, (q, terr, jerr)
        assert math.hypot(float(tmp.x[q]) - float(jmp.x[q]),
                          float(tmp.y[q]) - float(jmp.y[q])) < 0.5


@pytest.mark.parametrize("backend", ["sdf", "lut"])
def test_fleet_equals_independent_port_filters(backend):
    """Three fleet steps equal three `mcl.step`s of R independent filters
    seeded like the robots (`fleet_seeds`), bit for bit on the CPU: poses,
    weights, the estimates and the EMAs, with adaptive injection on the
    sdf route and the fused LUT route's beam stride on the lut one."""
    blocked = torch.from_numpy(room(96, 96))
    rc = tcfg.RaycastConfig(step=1.0, max_dist=60.0, backend=backend, lut_bins=96)
    lidar = tcfg.LidarConfig(n_rays=24, max_dist=60.0, start=0.0, stop=2 * math.pi)
    cfg = tcfg.MCLConfig(
        n_particles=128, meas_stddev=3.0,
        lut_beam_stride=tcfg.beam_bin_stride(lidar, rc) if backend == "lut" else None,
        adaptive=tcfg.AdaptiveConfig(max_ratio=0.1) if backend == "sdf" else None)
    field = trf.make_ray_field(blocked, rc)
    starts = [Pose.create(30.0, 30.0, 0.3), Pose.create(60.0, 40.0, 2.0),
              Pose.create(45.0, 60.0, -1.2)]
    scans = [tfake.scan(blocked, p, lidar, rc) for p in starts]
    fl = tfleet.MCLFleet(3, cfg, rc, seed=7, device="cpu")
    states = fl.init(Pose.create(*([float(getattr(p, f)) for p in starts]
                                   for f in ("x", "y", "theta"))))
    odoms = Odometry.create([0.05, 0.0, -0.1], [1.5, 1.0, 0.5], [0.05, 0.1, 0.0])
    for _ in range(3):
        states = fl.step(states, odoms, Scan(angles=torch.stack([s.angles for s in scans]),
                                             dists=torch.stack([s.dists for s in scans])),
                         field, ALPHAS)
    for q, seed in enumerate(tfleet.fleet_seeds(7, 3)):
        st = tmcl.init(seed, 128, starts[q])
        odom = Odometry.create(float(odoms.rot1[q]), float(odoms.trans[q]), float(odoms.rot2[q]))
        for _ in range(3):
            st = tmcl.step(st, odom, ALPHAS, scans[q], field, cfg, rc)
        rq = tfleet.robot(states, q)
        for a, b in ((rq.particles.pose.x, st.particles.pose.x),
                     (rq.particles.pose.theta, st.particles.pose.theta),
                     (rq.particles.log_weight, st.particles.log_weight),
                     (rq.best_pose.x, st.best_pose.x), (rq.mode_pose.y, st.mode_pose.y),
                     (rq.log_w_slow, st.log_w_slow), (rq.log_w_fast, st.log_w_fast)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    mp = tfleet.mean_poses(states)
    for q in range(3):
        single = tmcl.mean_pose(tfleet.robot(states, q))
        assert torch.equal(mp.theta[q], single.theta) and torch.equal(mp.x[q], single.x)


@pytest.mark.parametrize("kind", ["spread", "peaked"])
def test_batched_systematic_resampler_matches_1d_and_jax(kind):
    """The systematic resampler on [R, N] log weights (one u0 per row)
    equals the 1-D one row by row on the CPU, and JAX's on each row within
    test_torch_resample.py's bin-edge share (0.1% of slots): the port sums
    in f64 and meets the exact indices, JAX's f32 prefix sum strays at a
    bin edge (here one slot in 4096 on 3 of the 8 rows, one of them by
    two). Its empty ranges offer -1 at their own start, so no slot
    collects them."""
    rng = np.random.default_rng(3)
    r, n = 4, 4096
    scale = {"spread": 5.0, "peaked": 60.0}[kind]
    lw = (rng.standard_normal((r, n)) * scale - 400.0).astype(np.float32)
    keys = jax.random.split(jax.random.key(11), r)
    u0 = torch.tensor([float(jax.random.uniform(k, ())) for k in keys])
    got = tres.systematic_indices(torch.from_numpy(lw), u0=u0)
    assert got.shape == (r, n) and got.dtype == torch.int32
    for q in range(r):
        one = tres.systematic_indices(torch.from_numpy(lw[q]), u0=u0[q])
        assert torch.equal(got[q], one)
        want = np.asarray(jres.systematic_indices(keys[q], jnp.asarray(lw[q])))
        d = got[q].numpy().astype(np.int64) - want
        assert (d != 0).mean() <= 0.001
    # The batched resample gathers each row's poses from its own row.
    pose = Pose(*(torch.from_numpy(rng.standard_normal((r, n)).astype(np.float32))
                  for _ in range(3)))
    parts = tres.resample(convert.particles(*(p.numpy() for p in (pose.x, pose.y, pose.theta)),
                                            lw), u0=u0)
    for q in range(r):
        assert torch.equal(parts.pose.x[q], pose.x[q][got[q].long()])
    assert torch.allclose(parts.log_weight, torch.full((r, n), -math.log(n)))
