"""The per-particle-map RBPF in slam_tpu_torch against slam_tpu: the
quantized u8 update on every value, the fused weighting + mapping (maps
bit for bit, weights within 1e-5), the RBPF step from a shared state with
JAX's draws injected, and the closed loop of tests/test_rbpf.py."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slam_tpu.core.config as jc
from slam_tpu.core.types import Odometry as JOdometry
from slam_tpu.core.types import Pose as JPose
from slam_tpu.core.types import Scan as JScan
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.models import rbpf as jrbpf
from slam_tpu.models.simulate import synthetic_room
from slam_tpu.ops import mapping as jmap
from slam_tpu.ops.measurement import sensor_pose as jsensor
import slam_tpu_torch.core.config as tc
from slam_tpu_torch.core.types import Odometry, Pose
from slam_tpu_torch.models import fake_lidar as tfake
from slam_tpu_torch.models import rbpf as trbpf
from slam_tpu_torch.ops import mapping as tmap
from slam_tpu_torch.ops import motion as tmotion
from slam_tpu_torch.ops.measurement import sensor_pose
from slam_tpu_torch.utils import convert
from slam_tpu_torch.utils import metrics as tmetrics
from torch_port import jax_noise, np_, t_pose, t_scan

H = W = 64
MAX_DIST, STEP = 40.0, 1.0


@pytest.mark.parametrize("factor", [0.6 / 0.5, 0.4 / 0.5], ids=["free", "occupied"])
def test_u8_update_every_value(factor):
    """All 256 codes equal the compiled reference's (under jit XLA
    multiplies by the folded f32 constant f32(1/255) * f32(factor))."""
    v = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax.jit(lambda x: jmap._u8_update(x, factor))(jnp.asarray(v)))
    np.testing.assert_array_equal(tmap._u8_update(torch.from_numpy(v), factor).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jmap._u8_update(jnp.asarray(v), factor)), want)


@functools.cache
def _jax_fidelity(offset):
    return jax.jit(lambda m, p, z: jmap.fidelity_measurement_and_mapping(
        m, p, z, scanner_offset=offset, stddev=3.0, eps=0.1, max_dist=MAX_DIST, step=STEP))


def _maps(rng, n):
    """u8 maps with learned-looking structure: mostly gray, free-ish
    interiors, dark walls (< 128) where the room has them, and noise."""
    room = synthetic_room(H, W)
    base = np.where(room, 40, 170).astype(np.int32)
    maps = base[None] + rng.integers(-40, 41, (n, H, W))
    maps[:, :, : W // 3] = 128  # an unexplored third
    return np.clip(maps, 1, 255).astype(np.uint8)


@pytest.mark.parametrize("chunked", [False, True], ids=["one_chunk", "chunked"])
@pytest.mark.parametrize("offset", [(0.0, 0.0, 0.0), (0.0, 3.0, 0.1)], ids=["centered", "offset"])
def test_fidelity_measurement_and_mapping_matches_jax(rng, monkeypatch, offset, chunked):
    """Maps bit for bit with JAX's (where lanes of one particle write one
    cell, the last lane in (beam, step) order wins, as XLA's in-order
    scatter keeps it) and log weights within a relative 1e-5; particles
    in one chunk or in chunks of 3 (`_FIDELITY_CHUNK_LANES`)."""
    n = 8
    if chunked:
        monkeypatch.setattr(tmap, "_FIDELITY_CHUNK_LANES", 3 * 16 * int(MAX_DIST / STEP))
    maps = _maps(rng, n)
    x = rng.uniform(8, W - 8, n).astype(np.float32)
    y = rng.uniform(8, H - 8, n).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    angles = np.linspace(-np.pi, np.pi, 16, endpoint=False).astype(np.float32)
    dists = rng.uniform(2, MAX_DIST, 16).astype(np.float32)
    dists[[3, 9]] = MAX_DIST  # max-range misses
    jscan = JScan(angles=jnp.asarray(angles), dists=jnp.asarray(dists))
    jlw, jmaps = _jax_fidelity(offset)(jnp.asarray(maps),
                                       JPose(*(jnp.asarray(v) for v in (x, y, th))), jscan)
    tlw, tmaps = tmap.fidelity_measurement_and_mapping(
        torch.from_numpy(maps), convert.pose(x, y, th), convert.scan(angles, dists),
        scanner_offset=offset, stddev=3.0, eps=0.1, max_dist=MAX_DIST, step=STEP)
    assert tmaps.dtype == torch.uint8
    np.testing.assert_array_equal(tmaps.numpy(), np.asarray(jmaps))
    np.testing.assert_allclose(np_(tlw), np.asarray(jlw), rtol=1e-5)
    assert (tmaps.numpy() != maps).mean() > 0.01


def _cfgs(m, resample):
    return (m.MCLConfig(n_particles=16, meas_stddev=3.0, resample=resample,
                        scanner_offset=(0.0, 2.0, 0.0)),
            m.RaycastConfig(step=STEP, max_dist=MAX_DIST))


@pytest.mark.parametrize("resample", ["systematic", "multinomial"])
def test_rbpf_step_matches_jax(resample):
    """Three chained RBPF steps, each port step from the JAX state carried
    across (`utils/convert.py:rbpf_state`) with JAX's motion and resampler
    draws injected: maps bit for bit, best_map_idx equal, poses within
    1e-4 px / rad, best_pose within 1e-4."""
    tcfg, trc = _cfgs(tc, resample)
    _hold_to_jax(resample, lambda ts, odom, z, k, **draws: trbpf.step(ts, odom, z, tcfg, trc,
                                                                     **draws))


@pytest.mark.parametrize("resample", ["systematic", "multinomial"])
def test_rbpf_engine_block_matches_jax(resample):
    """`RBPF.step`'s block (`StepGraphs`: a CUDA graph on the card, the
    same block code here) with JAX's draws injected, held to JAX's jitted
    steps as `test_rbpf_step_matches_jax` holds the free step."""
    tcfg, trc = _cfgs(tc, resample)
    engine = trbpf.RBPF(tcfg, trc, device="cpu")

    def port_step(ts, odom, z, k, **draws):
        return engine.graphs.run(lambda s, o, z_: trbpf.step(s, o, z_, tcfg, trc, **draws),
                                 ts, odom, z, key=("injected", k))

    _hold_to_jax(resample, port_step)
    assert len(engine.graphs.cache.blocks) == 3


@pytest.mark.parametrize("resample", ["systematic", "multinomial"])
def test_rbpf_engine_step_equals_free_step(resample):
    """`RBPF.step` through its block == the free `rbpf.step` bit for bit
    over 3 chained steps from cloned states, the engine's own draws: maps,
    particles, best_map_idx, the step counter and the generator's state."""
    from slam_tpu_torch.entry import clone_state, state_difference

    tcfg, trc = _cfgs(tc, resample)
    engine = trbpf.RBPF(tcfg, trc, seed=5, device="cpu")
    blocked = torch.from_numpy(synthetic_room(H, W))
    lidar = tc.LidarConfig(n_rays=12, max_dist=MAX_DIST)
    a = engine.init(Pose.create(30.0, 30.0, 0.4), (H, W))
    b = clone_state(a)
    truth = [30.0, 30.0, 0.4]
    for k in range(3):
        truth = [truth[0] + 1.5 * math.cos(truth[2] + 0.06),
                 truth[1] + 1.5 * math.sin(truth[2] + 0.06), truth[2] + 0.12]
        z = tfake.scan(blocked, sensor_pose(Pose.create(*truth), tcfg.scanner_offset), lidar, trc)
        odom = Odometry.create(0.06 + 0.01 * k, 1.5, 0.06)
        a = engine.step(a, odom, z)
        b = trbpf.step(b, odom, z, tcfg, trc)
        assert state_difference(a, b) is None, k
        assert a.step == k + 1 and bool((a.maps != 128).any())
    assert len(engine.graphs.cache.blocks) == 1


def _hold_to_jax(resample, port_step):
    """`test_rbpf_step_matches_jax`'s three chained steps, each port step
    `port_step(state, odom, scan, k, noise=, u0= or u=)` from the carried
    JAX state."""
    jcfg, jrc = _cfgs(jc, resample)
    blocked = jnp.asarray(synthetic_room(H, W))
    lidar = jc.LidarConfig(n_rays=12, max_dist=MAX_DIST)
    step = jax.jit(lambda s, o, z: jrbpf.step(s, o, z, jcfg, jrc))
    js = jrbpf.init(jax.random.key(3), 16, JPose.create(30.0, 30.0, 0.4), (H, W))
    truth = [30.0, 30.0, 0.4]
    for k in range(3):
        truth = [truth[0] + 1.5 * math.cos(truth[2] + 0.06),
                 truth[1] + 1.5 * math.sin(truth[2] + 0.06), truth[2] + 0.12]
        scan = jfake.scan(blocked, jsensor(JPose.create(*truth), jcfg.scanner_offset), lidar, jrc)
        _, k_mot, k_rs = jax.random.split(js.key, 3)
        p = js.particles
        ts = convert.rbpf_state(
            convert.particles(p.pose.x, p.pose.y, p.pose.theta, p.log_weight),
            np.asarray(js.maps), t_pose(js.best_pose), int(js.best_map_idx), int(js.step), 0)
        draws = dict(u0=convert.tensor(jax.random.uniform(k_rs, ()))) if resample == "systematic" \
            else dict(u=convert.tensor(jax.random.uniform(k_rs, (16,))))
        js = step(js, JOdometry.create(0.06, 1.5, 0.06), scan)
        ts = port_step(ts, Odometry.create(0.06, 1.5, 0.06), t_scan(scan), k,
                       noise=jax_noise(k_mot, (16,)), **draws)
        np.testing.assert_array_equal(ts.maps.numpy(), np.asarray(js.maps))
        assert int(ts.best_map_idx) == int(js.best_map_idx) and ts.step == int(js.step)
        for tp, jp in ((ts.particles.pose, js.particles.pose), (ts.best_pose, js.best_pose)):
            for f in ("x", "y", "theta"):
                np.testing.assert_allclose(np_(getattr(tp, f)), np_(getattr(jp, f)), atol=1e-4)
        np.testing.assert_array_equal(np_(ts.particles.log_weight),
                                      np.asarray(js.particles.log_weight))
    np.testing.assert_allclose(np_(trbpf.best_map_prob_free(ts)),
                               np.asarray(jrbpf.best_map_prob_free(js)), rtol=1e-6)
    for a, b in zip((trbpf.mean_pose(ts).x, trbpf.mean_pose(ts).y),
                    (jrbpf.mean_pose(js).x, jrbpf.mean_pose(js).y)):
        np.testing.assert_allclose(float(a), float(b), atol=1e-4)


def test_rbpf_tracks_and_maps():
    """tests/test_rbpf.py's closed loop on the port (96x96 room, 64
    particles, 20 rays, the march backend, 25 steps): mean-pose ATE < 8
    px, and the best map has learned walls and free space."""
    h = w = 96
    blocked = torch.from_numpy(synthetic_room(h, w))
    cfg = tc.MCLConfig(n_particles=64, meas_stddev=3.0, resample="systematic")
    rc = tc.RaycastConfig(step=1.0, max_dist=50.0, chunk=16)
    lidar = tc.LidarConfig(n_rays=20, max_dist=50.0)
    engine = trbpf.RBPF(cfg, rc, seed=0, device="cpu")
    state = engine.init(Pose.create(30.0, 30.0, 0.4), (h, w))
    gt = Pose.create(30.0, 30.0, 0.4)
    g = torch.Generator().manual_seed(1)
    est, gts = [], []
    for _ in range(25):
        odom = Odometry.create(0.06, 1.5, 0.06)
        gt = tmotion.sample_motion_model_odometry(odom, gt, (2e-3,) * 4, generator=g)
        state = engine.step(state, odom, tfake.scan(blocked, sensor_pose(gt, cfg.scanner_offset),
                                                    lidar, rc))
        mp = trbpf.mean_pose(state)
        est.append([float(mp.x), float(mp.y)])
        gts.append([float(gt.x), float(gt.y)])
    ate = tmetrics.ate_rmse(np.array(est), np.array(gts))
    assert ate < 8.0, ate
    pf = np_(trbpf.best_map_prob_free(state))
    assert pf.min() < 0.3 and pf.max() > 0.7 and np.abs(pf - 0.5).mean() > 0.01
    assert state.maps.shape == (64, h, w) and state.step == 25
