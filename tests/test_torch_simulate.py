"""slam_tpu_torch.models.simulate and the motion / beam models it builds
on, against the JAX package: the room (bit for bit), the command list,
the velocity sampler with JAX's draws injected, the inverse odometry
model and its density, the probabilistic beam model (each within 1e-5),
and the closed loops (`run_localization`, `run_slam`,
`run_slam_deterministic`) with the port's own noise, held to the JAX
tests' bounds (tests/test_mcl.py, tests/test_scanmatch.py)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.types import Odometry as JOdometry
from slam_tpu.core.types import Pose as JPose
from slam_tpu.core.types import Velocity as JVelocity
from slam_tpu.models import simulate as jsim
from slam_tpu.ops import measurement as jmeas
from slam_tpu.ops import motion as jmotion
import slam_tpu_torch.core.config as tc
from slam_tpu_torch.core.types import Odometry, Pose, Velocity
from slam_tpu_torch.models import simulate as tsim
from slam_tpu_torch.ops import measurement as tmeas
from slam_tpu_torch.ops import motion as tmotion
from slam_tpu_torch.utils import convert
from slam_tpu_torch.utils.metrics import ate_rmse
from torch_port import jax_noise, np_


@pytest.mark.parametrize("shape", [(128, 128), (96, 128), (64, 64), (37, 53)])
def test_synthetic_room_equal(shape):
    np.testing.assert_array_equal(tsim.synthetic_room(*shape), jsim.synthetic_room(*shape))


def test_forward_arc_commands_equal():
    t, j = tsim.forward_arc_commands(4, trans=2.5, rot=0.04), jsim.forward_arc_commands(4, 2.5, 0.04)
    assert len(t) == len(j) == 4
    for a, b in zip(t, j):
        assert [float(a.rot1), float(a.trans), float(a.rot2)] == \
               [float(b.rot1), float(b.trans), float(b.rot2)]
        assert a.trans.device.type == "cpu"


def _poses(rng, n):
    return tuple(v.astype(np.float32) for v in (
        rng.uniform(10, 90, n), rng.uniform(10, 90, n), rng.uniform(-np.pi, np.pi, n)))


@pytest.mark.parametrize("vel", [(1.5, 0.3), (2.0, 0.0), (0.0, -0.7)])
def test_velocity_model_matches_jax(rng, vel):
    """The velocity sampler with JAX's three normal draws injected, w == 0
    guarded: poses within 1e-5 (relative 1e-5)."""
    x, y, th = _poses(rng, 1000)
    alphas = (0.01, 0.02, 0.01, 0.03, 0.005, 0.004)
    key = jax.random.key(8)
    want = jmotion.sample_motion_model_velocity(
        key, JVelocity.create(*vel), JPose(*(jnp.asarray(v) for v in (x, y, th))), 0.5,
        jnp.asarray(alphas))
    got = tmotion.sample_motion_model_velocity(
        Velocity.create(*vel), convert.pose(x, y, th), 0.5, alphas,
        noise=jax_noise(key, (1000,)))
    for f in ("x", "y", "theta"):
        np.testing.assert_allclose(np_(getattr(got, f)), np_(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5)
    own = tmotion.sample_motion_model_velocity(Velocity.create(*vel), convert.pose(x, y, th),
                                               0.5, alphas, generator=torch.Generator())
    assert torch.isfinite(own.x).all() and own.theta.abs().max() <= math.pi


def test_odometry_inverse_and_density_match(rng):
    """odometry_from_poses and motion_model_odometry_density within 1e-5
    (relative for the density), on pose pairs a sampled step apart."""
    x, y, th = _poses(rng, 1000)
    prev = convert.pose(x, y, th)
    odom = (0.1, 2.0, -0.05)
    alphas = (0.01, 0.01, 0.02, 0.02)
    curr = tmotion.sample_motion_model_odometry(Odometry.create(*odom), prev, alphas,
                                                generator=torch.Generator().manual_seed(2))
    jprev = JPose(*(jnp.asarray(np_(v)) for v in (prev.x, prev.y, prev.theta)))
    jcurr = JPose(*(jnp.asarray(np_(v)) for v in (curr.x, curr.y, curr.theta)))
    jo = jmotion.odometry_from_poses(jprev, jcurr)
    to = tmotion.odometry_from_poses(prev, curr)
    for f in ("rot1", "trans", "rot2"):
        np.testing.assert_allclose(np_(getattr(to, f)), np_(getattr(jo, f)), rtol=1e-5, atol=1e-5)
    jd = jmotion.motion_model_odometry_density(JOdometry.create(*odom), jprev, jcurr,
                                               jnp.asarray(alphas))
    td = tmotion.motion_model_odometry_density(Odometry.create(*odom), prev, curr, alphas)
    np.testing.assert_allclose(np_(td), np_(jd), rtol=1e-5, atol=1e-12)
    assert np_(td).min() > 0


def test_beam_weights_probabilistic_matches(rng):
    """The notebook's probabilistic beam model (a loop over the K ray
    steps with [N, B] tensors for JAX's lax.scan) within 1e-5 on a random
    occupancy map, with a scanner offset, rays leaving the map and
    max-range beams."""
    h, w = 48, 64
    prob = rng.uniform(0, 1, (h, w)).astype(np.float32) ** 4
    x, y, th = (v.astype(np.float32) for v in (rng.uniform(2, 62, 64), rng.uniform(2, 46, 64),
                                                rng.uniform(-np.pi, np.pi, 64)))
    angles = np.linspace(-np.pi / 2, np.pi / 2, 9).astype(np.float32)
    dists = rng.uniform(1, 30, 9).astype(np.float32)
    dists[4] = 30.0
    kw = dict(scanner_offset=(0.0, 2.0, 0.0), stddev=3.0, max_dist=30.0, step=1.0)
    from slam_tpu.core.types import Scan as JScan

    want = jmeas.beam_weights_probabilistic(
        jnp.asarray(prob), JPose(*(jnp.asarray(v) for v in (x, y, th))),
        JScan(angles=jnp.asarray(angles), dists=jnp.asarray(dists)), **kw)
    got = tmeas.beam_weights_probabilistic(torch.from_numpy(prob), convert.pose(x, y, th),
                                           convert.scan(angles, dists), **kw)
    assert got.shape == (64, 9)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5, atol=1e-7)


def _small_cfg(n_particles=300, **mcl):
    return tc.SLAMConfig(
        mcl=tc.MCLConfig(n_particles=n_particles, meas_stddev=3.0, **mcl),
        map=tc.MapConfig(height=128, width=128),
        lidar=tc.LidarConfig(max_dist=60.0, n_rays=24, stddev=3.0),
        motion=tc.MotionConfig(alphas=(0.002,) * 4),
        raycast=tc.RaycastConfig(step=1.0, max_dist=60.0, chunk=16),
    )


def _circuit(n):
    return [Odometry.create(0.04, 2.0, 0.04) for _ in range(n)]


def test_run_localization_tracks():
    """tests/test_mcl.py:77-88 on the port (300 particles, the march beam
    model, 40 steps of a circuit): mean-pose ATE < 4 px; with a scan
    matcher on the likelihood field (tests/test_scanmatch.py:174-227's
    serving mode, 32 particles), the refined track < 1.5 px."""
    blocked = tsim.synthetic_room()
    res = tsim.run_localization(blocked, _small_cfg(), _circuit(40),
                                Pose.create(40.0, 40.0, 0.3), seed=0, device="cpu")
    assert res.est_xy.shape == (40, 2) and res.sm_xy is None
    ate = ate_rmse(res.est_xy, res.gt_xy)
    assert ate < 4.0, f"localization ATE {ate:.2f}px"

    cfg = _small_cfg(32, measurement="likelihood_field")
    cfg = dataclasses.replace(cfg, scanmatch=tc.ScanMatchConfig(), raycast=tc.RaycastConfig(
        step=1.0, max_dist=60.0, chunk=16, backend="sdf"))
    res = tsim.run_localization(blocked, cfg, tsim.forward_arc_commands(40, 2.0, 0.04),
                                Pose.create(40.0, 40.0, 0.3), seed=0, device="cpu")
    sm = ate_rmse(res.sm_xy, res.gt_xy)
    assert sm < 1.5, f"refined localization ATE {sm:.2f}px"


def test_run_slam_tracks_and_maps():
    """tests/test_mcl.py:159-174 on the port (300 particles, alphas 1e-4 /
    1e-3, 40 steps): SE(2)-aligned ATE < 3 px, raw < 8 px; and
    run_slam_deterministic's arc stays finite with est_pose the best
    particle."""
    cfg = _small_cfg()
    cfg = dataclasses.replace(cfg, motion=tc.MotionConfig(alphas=(1e-4, 1e-4, 1e-3, 1e-3)))
    res = tsim.run_slam(tsim.synthetic_room(), cfg, _circuit(40), Pose.create(40.0, 40.0, 0.3),
                        seed=0, device="cpu")
    aligned = ate_rmse(res.est_xy, res.gt_xy, align=True)
    raw = ate_rmse(res.est_xy, res.gt_xy)
    assert aligned < 3.0 and raw < 8.0, (aligned, raw)
    assert (np.abs(np_(res.final_state.grid)) > 0.3).mean() > 0.05

    det = tsim.run_slam_deterministic(tsim.synthetic_room(), _small_cfg(64), 6, trans=2.0,
                                      device="cpu")
    assert det.gt_xy.shape == (6, 2) and np.isfinite(det.est_xy).all()
    np.testing.assert_allclose(det.sm_xy, det.best_xy)
    np.testing.assert_allclose(det.gt_xy[0], [64.0 + 2.0 * math.cos(math.pi / 2 + 0.01),
                                              64.0 + 2.0 * math.sin(math.pi / 2 + 0.01)],
                               atol=1e-4)


def test_simulator_runs_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: tsim.run_localization(tsim.synthetic_room(), _small_cfg(8), _circuit(1),
                                              Pose.create(40.0, 40.0, 0.3)),
                lambda: tsim.run_slam(tsim.synthetic_room(), _small_cfg(8), _circuit(1),
                                      Pose.create(40.0, 40.0, 0.3))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            run()
