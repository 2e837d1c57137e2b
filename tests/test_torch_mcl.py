"""The slice as a whole: slam_tpu_torch's MCL step (predict -> update with
the fused LUT measurement and systematic resampling) against
`slam_tpu.models.mcl`, with JAX's own draws injected."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import LidarConfig as JLidar
from slam_tpu.core.config import MCLConfig as JMCLConfig
from slam_tpu.core.config import RaycastConfig as JRaycast
from slam_tpu.core.config import beam_bin_stride
from slam_tpu.core.types import Odometry as JOdometry
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.models import mcl as jmcl
from slam_tpu.ops import rayfield as jrf
from slam_tpu_torch.core import config as tcfg
from slam_tpu_torch.core.types import Odometry
from slam_tpu_torch.models import fake_lidar as tfake
from slam_tpu_torch.models import mcl as tmcl
from slam_tpu_torch.ops import measurement as tmeas
from slam_tpu_torch.ops import rayfield as trf
from slam_tpu_torch.ops import resample as tres
from slam_tpu_torch.utils import convert
from torch_port import (
    assert_angles_close, jax_noise, np_, one_rank_sharding, room, t_field, t_pose, t_scan,
)

H, W, MAX_DIST, N = 96, 128, 80.0, 2048
ALPHAS = (0.0005, 0.0005, 0.01, 0.01)
ODOM = (0.02, 1.5, 0.01)
START = (50.0, 30.0, 0.4)


def _configs(**over):
    lidar = JLidar(start=0.0, stop=math.pi, max_dist=MAX_DIST, n_rays=90)
    jrc = JRaycast(step=0.5, max_dist=MAX_DIST, backend="lut")
    base = dict(n_particles=N, meas_stddev=5.0, scanner_offset=(0.0, 10.0, 0.0),
                lut_beam_stride=beam_bin_stride(lidar, jrc))
    base.update(over)
    jcfg = JMCLConfig(**base)
    tc = tcfg.MCLConfig(**base)
    trc = tcfg.RaycastConfig(**dataclasses.asdict(jrc))
    return lidar, jrc, trc, jcfg, tc


@functools.cache
def _fields():
    """The room's JAX-built 360-bin table and its port counterpart."""
    _, jrc, _, _, _ = _configs()
    jfield = jrf.make_ray_field(jnp.asarray(room(H, W)), jrc)
    return jfield, t_field(jfield)


def _carry(jstate):
    """A JAX MCLState as a port MCLState (through utils.convert)."""
    p = jstate.particles
    return convert.mcl_state(
        convert.particles(p.pose.x, p.pose.y, p.pose.theta, p.log_weight),
        t_pose(jstate.best_pose), t_pose(jstate.mode_pose),
        int(jstate.step), int(jstate.updates), seed=0)


def _run_both(call, steps=3, sync=False, **over):
    """`steps` predict -> update steps of both filters from the same start,
    the torch side fed the draws JAX takes from its key, through
    `predict` then `update` or through `step` (`call`). With `sync`, each
    torch step starts from the JAX state carried across. Returns the
    state pairs after each step."""
    lidar, jrc, trc, jcfg, tc = _configs(**over)
    blocked = room(H, W)
    jfield, tfield = _fields()
    jstate = jmcl.init(jax.random.key(0), N, JPose.create(*START))
    tstate = tmcl.init(0, N, convert.pose(*START))
    truth = list(START)
    out = []
    for _ in range(steps):
        if sync:
            tstate = _carry(jstate)
        r1, t, r2 = ODOM
        truth = [truth[0] + t * math.cos(truth[2] + r1),
                 truth[1] + t * math.sin(truth[2] + r1), truth[2] + r1 + r2]
        sensor = jmcl.MCL.sensor_position(JPose.create(*truth), jcfg.scanner_offset)
        scan = jfake.scan(jnp.asarray(blocked), sensor, lidar, JRaycast(max_dist=MAX_DIST))

        _, sub = jax.random.split(jstate.key)
        noise = jax_noise(sub, (N,))
        jstate = jmcl.predict(jstate, JOdometry.create(*ODOM), jnp.asarray(ALPHAS))
        _, k_rs, _ = jax.random.split(jstate.key, 3)
        u0 = convert.tensor(jax.random.uniform(k_rs, ()))
        jstate = jmcl.update(jstate, scan, jfield, jcfg, jrc)

        odom = Odometry.create(*ODOM)
        if call == "step":
            tstate = tmcl.step(tstate, odom, ALPHAS, t_scan(scan), tfield, tc, trc,
                               u0=u0, noise=noise)
        else:
            tstate = tmcl.predict(tstate, odom, ALPHAS, noise=noise)
            tstate = tmcl.update(tstate, t_scan(scan), tfield, tc, trc, u0=u0)
        out.append((jstate, tstate))
    return out


def _assert_pose_close(tp, jp, atol):
    np.testing.assert_allclose(np_(tp.x), np_(jp.x), rtol=1e-6, atol=atol)
    np.testing.assert_allclose(np_(tp.y), np_(jp.y), rtol=1e-6, atol=atol)
    assert_angles_close(np_(tp.theta), np_(jp.theta), atol=atol)


def _moments(p):
    pose = p.pose
    return np.array([np_(v).astype(np.float64).mean() for v in (pose.x, pose.y)]
                    + [np_(v).astype(np.float64).std() for v in (pose.x, pose.y, pose.theta)])


OVERRIDES = [{}, {"resample_every": 2}, {"ess_threshold": 0.3}, {"lut_beam_stride": None}]
IDS = ["every_update", "every_2nd", "ess_gate", "general_route"]
# The port's two ways through a step: predict then update, or mcl.step.
CALLS = ["predict_update", "step"]


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("over", OVERRIDES, ids=IDS)
def test_mcl_step_matches_jax_from_shared_state(over, call):
    """Each step from the same (carried-over) state: best_pose and
    mode_pose to 1e-3 px/rad; particle poses to 1e-3 px on >= 99.5% of
    particles, their log weights to rtol 1e-5, atol 1e-3. The rest is the
    systematic resampler's one-slot allowance (test_torch_resample.py):
    the two cumulative sums round differently, and on the peaked weights
    the ESS gate lets accumulate, draws on a bin edge land one slot over
    (measured: at most 5 of 2048 in a step, 0.24%)."""
    for jstate, tstate in _run_both(call, sync=True, **over):
        _assert_pose_close(tstate.best_pose, jstate.best_pose, 1e-3)
        _assert_pose_close(tstate.mode_pose, jstate.mode_pose, 1e-3)
        jp, tp = jstate.particles, tstate.particles
        close = (np.isclose(np_(tp.pose.x), np_(jp.pose.x), rtol=1e-6, atol=1e-3)
                 & np.isclose(np_(tp.pose.y), np_(jp.pose.y), rtol=1e-6, atol=1e-3))
        assert close.mean() >= 0.995, f"{(~close).sum()} particles differ"
        np.testing.assert_allclose(np_(tp.log_weight)[close], np_(jp.log_weight)[close],
                                   rtol=1e-5, atol=1e-3)
        assert tstate.updates == int(jstate.updates) and tstate.step == int(jstate.step)


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("over", OVERRIDES, ids=IDS)
def test_mcl_chained_steps_match_jax(over, call):
    """Three chained steps. An index the resampler sets one slot over
    picks a neighbour with other noise, and later resamples spread that,
    so particle sets are compared by their moments (1e-2 px/rad; measured
    <= 6e-3). best_pose to 1e-3 (measured: equal) and mode_pose to 5e-2
    (measured <= 3e-2) px/rad."""
    for jstate, tstate in _run_both(call, **over):
        _assert_pose_close(tstate.best_pose, jstate.best_pose, 1e-3)
        _assert_pose_close(tstate.mode_pose, jstate.mode_pose, 5e-2)
        np.testing.assert_allclose(_moments(tstate.particles), _moments(jstate.particles),
                                   rtol=0, atol=1e-2)
    assert tstate.updates == 3 and tstate.step == 3


def test_uninformative_update_falls_back_to_mode_pose():
    """All particles at one pose score identically (a majority tie), so
    best_pose is the sharpened mean in both packages."""
    lidar, jrc, trc, jcfg, tc = _configs()
    blocked = room(H, W)
    jfield, tfield = _fields()
    scan = jfake.scan(jnp.asarray(blocked), JPose.create(*START), lidar,
                      JRaycast(max_dist=MAX_DIST))
    jstate = jmcl.update(jmcl.init(jax.random.key(0), N, JPose.create(*START)),
                         scan, jfield, jcfg, jrc)
    tstate = tmcl.update(tmcl.init(0, N, convert.pose(*START)), t_scan(scan),
                         tfield, tc, trc, u0=torch.tensor(0.5))
    _assert_pose_close(tstate.best_pose, tstate.mode_pose, 0.0)
    _assert_pose_close(tstate.best_pose, jstate.best_pose, 1e-4)


def test_mcl_wrapper_and_mean_pose():
    """The MCL class runs the step on its device, and mean_pose matches
    the JAX circular mean; adaptive injection runs and the unported hooks
    raise."""
    lidar, jrc, trc, jcfg, tc = _configs(n_particles=512)
    blocked = room(H, W)
    m = tmcl.MCL(tc, trc, seed=3, device="cpu")
    state = m.init(H, W)
    j0 = jmcl.starting_pose(H, W)
    _assert_pose_close(state.best_pose, j0, 0.0)
    field = trf.make_ray_field(torch.from_numpy(blocked), trc)
    sensor = m.sensor_position(convert.pose(*START), tc.scanner_offset)
    scan = tfake.scan(torch.from_numpy(blocked), sensor, tcfg.LidarConfig(
        start=0.0, stop=math.pi, max_dist=MAX_DIST, n_rays=90),
        tcfg.RaycastConfig(max_dist=MAX_DIST))
    state = m.update(m.predict(state, Odometry.create(*ODOM), ALPHAS), scan, field)
    assert state.updates == 1 and torch.isfinite(state.particles.log_weight).all()
    p = state.particles.pose
    jm = jmcl.mean_pose(jmcl.MCLState(
        particles=jmcl.Particles(pose=JPose.create(np_(p.x), np_(p.y), np_(p.theta)),
                                 log_weight=jnp.zeros(512)),
        key=jax.random.key(0), best_pose=j0, mode_pose=j0,
        log_w_slow=jnp.float32(0), log_w_fast=jnp.float32(0),
        step=jnp.int32(0), updates=jnp.int32(0)))
    _assert_pose_close(tmcl.mean_pose(state), jm, 1e-4)

    # Adaptive injection runs now (tests/test_torch_globalloc.py), and so
    # do the sharded engines' hooks (tests/test_torch_parallel.py runs them
    # over worlds of ranks): a custom resampler and measurement are called
    # in their place, and a sharding of one rank changes nothing.
    st = tmcl.update(state, scan, field, dataclasses.replace(tc, adaptive=tcfg.AdaptiveConfig()),
                     trc)
    assert torch.isfinite(st.log_w_slow) and torch.isfinite(st.log_w_fast)
    calls = []

    def resample_fn(p, *, u0=None, generator=None):
        calls.append("resample_fn")
        return tres.resample(p, u0=u0)

    def measurement_fn(poses, z):
        calls.append("measurement_fn")
        return tmeas.particle_log_weights(field, poses, z, rc=trc,
                                          scanner_offset=tc.scanner_offset,
                                          stddev=tc.meas_stddev, eps=tc.meas_epsilon)

    u0 = torch.tensor(0.5)
    want = tmcl.update(state, scan, field, tc, trc, u0=u0)
    for hook, fn in (("resample_fn", resample_fn), ("measurement_fn", measurement_fn),
                     ("ray_sharding", one_rank_sharding())):
        got = tmcl.update(state, scan, field, tc, trc, u0=u0, **{hook: fn})
        for a, b in ((got.particles.pose.x, want.particles.pose.x),
                     (got.particles.log_weight, want.particles.log_weight),
                     (got.best_pose.x, want.best_pose.x)):
            np.testing.assert_array_equal(np_(a), np_(b))
    assert calls == ["resample_fn", "measurement_fn"]
