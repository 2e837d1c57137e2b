"""The slice as a whole: slam_tpu_torch.models.slam.step (predict -> capped
EDT -> likelihood-field weights -> estimate -> log-odds map update ->
resample) against slam_tpu.models.slam.step, with JAX's own motion draws
and resampler uniform injected, the JAX state carried across through
`utils.convert.slam_state`; and a closed-loop run of the port alone."""

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
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.models import slam as jslam
from slam_tpu.models.simulate import synthetic_room
from slam_tpu.utils.metrics import ate_rmse as jate
from slam_tpu.utils.metrics import fit_se2 as jfit
import slam_tpu_torch.core.config as tc
from slam_tpu_torch.core import grid as tgrid
from slam_tpu_torch.core.types import Odometry, Pose
from slam_tpu_torch.models import fake_lidar as tfake
from slam_tpu_torch.models import mcl as tmcl
from slam_tpu_torch.models import slam as tslam
from slam_tpu_torch.ops import edt as tedt
from slam_tpu_torch.ops import motion as tmotion
from slam_tpu_torch.utils import convert
from slam_tpu_torch.utils import metrics as tmetrics
from torch_port import assert_angles_close, jax_noise, np_, t_pose, t_scan

H = W = 96
N, MAX_DIST = 256, 60.0
ODOM = (0.06, 1.5, 0.06)
START = (40.0, 40.0, 0.3)


def _make(m, mcl=None, backend="sdf", **over):
    """One SLAM configuration built from either package's config module."""
    mcl_kw = dict(n_particles=N, meas_stddev=3.0, measurement="likelihood_field_table",
                  lf_table_box=48)
    mcl_kw.update(mcl or {})
    return m.SLAMConfig(
        mcl=m.MCLConfig(**mcl_kw),
        map=m.MapConfig(height=H, width=W),
        lidar=m.LidarConfig(max_dist=MAX_DIST, n_rays=24, stddev=3.0),
        motion=m.MotionConfig(alphas=(0.002,) * 4),
        raycast=m.RaycastConfig(step=1.0, max_dist=MAX_DIST, backend=backend),
        **over,
    )


CONFIGS = {
    "table_best": {},
    "table_mean": dict(map_pose="mean"),
    "table_mode_resample_every_4": dict(map_pose="mode", mcl={"resample_every": 4}),
    "table_map_every_2": dict(map_every=2),
    "table_edt_box": dict(edt_box=80),
    "table_dense_bf16": dict(mcl={"lf_table_box": None, "lf_table_dtype": "bf16"}),
    "likelihood_field": dict(mcl={"measurement": "likelihood_field"}),
    "beam_march": dict(mcl={"measurement": "beam"}, backend="march"),
}


@functools.cache
def _scans(n):
    """Scans from the truth along a deterministic arc."""
    blocked = jnp.asarray(synthetic_room(H, W))
    lidar = jc.LidarConfig(max_dist=MAX_DIST, n_rays=24, stddev=3.0)
    truth, out = list(START), []
    for _ in range(n):
        r1, t, r2 = ODOM
        truth = [truth[0] + t * math.cos(truth[2] + r1),
                 truth[1] + t * math.sin(truth[2] + r1), truth[2] + r1 + r2]
        out.append(jfake.scan(blocked, JPose.create(*truth), lidar,
                              jc.RaycastConfig(step=1.0, max_dist=MAX_DIST)))
    return out


@functools.cache
def _jax_step(jcfg):
    return jax.jit(lambda s, o, z: jslam.step(s, o, z, jcfg))


def _draws(js):
    """The motion noise and the resampler's u0 JAX's next step draws."""
    key, sub = jax.random.split(js.mcl.key)
    _, k_rs, _ = jax.random.split(key, 3)
    return jax_noise(sub, (N,)), convert.tensor(jax.random.uniform(k_rs, ()))


def _carry(js):
    m = js.mcl
    p = m.particles
    return convert.slam_state(
        np.asarray(js.grid), None if js.edt is None else np.asarray(js.edt),
        convert.particles(p.pose.x, p.pose.y, p.pose.theta, p.log_weight),
        t_pose(m.best_pose), t_pose(m.mode_pose), t_pose(js.est_pose),
        int(m.step), int(m.updates), seed=0)


def _run_jax(jcfg, steps):
    """JAX states after 0..steps steps."""
    js = jslam.init(jax.random.key(0), jcfg, JPose.create(*START))
    out = [js]
    for z in _scans(steps):
        js = _jax_step(jcfg)(js, JOdometry.create(*ODOM), z)
        out.append(js)
    return out


def _assert_pose_close(tp, jp, atol):
    np.testing.assert_allclose(np_(tp.x), np_(jp.x), rtol=1e-6, atol=atol)
    np.testing.assert_allclose(np_(tp.y), np_(jp.y), rtol=1e-6, atol=atol)
    assert_angles_close(np_(tp.theta), np_(jp.theta), atol=atol)


def _close_particles(tp, jp, atol=1e-3):
    return (np.isclose(np_(tp.pose.x), np_(jp.pose.x), rtol=1e-6, atol=atol)
            & np.isclose(np_(tp.pose.y), np_(jp.pose.y), rtol=1e-6, atol=atol))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slam_step_matches_jax_from_shared_state(name):
    """Steps 4 and 5 (one maps and one skips under map_every=2), each from
    the JAX state carried across. Tolerances:
      * best, mode and output poses 1e-3 px/rad (measured <= 1.1e-5);
      * particle poses 1e-3 px on >= 99.5% of particles (measured: all),
        their log weights rtol 1e-5 / atol 1e-2 (sums of ~20 beam scores in
        another order; measured <= 6.1e-5); the rest is the systematic
        resampler's one-slot allowance (ROADMAP.md Queue 3);
      * the grid to 1e-6 on every cell (measured <= 2.4e-7), the blocked
        mask and the EDT cache (edt_box) equal."""
    jcfg, tcfg = _make(jc, **CONFIGS[name]), _make(tc, **CONFIGS[name])
    states = _run_jax(jcfg, 5)
    for k in (3, 4):
        js0, js1 = states[k], states[k + 1]
        noise, u0 = _draws(js0)
        ts1 = tslam.step(_carry(js0), Odometry.create(*ODOM), t_scan(_scans(5)[k]), tcfg,
                         noise=noise, u0=u0)
        for tp, jp in ((ts1.mcl.best_pose, js1.mcl.best_pose),
                       (ts1.mcl.mode_pose, js1.mcl.mode_pose), (ts1.est_pose, js1.est_pose)):
            _assert_pose_close(tp, jp, 1e-3)
        jp, tp = js1.mcl.particles, ts1.mcl.particles
        close = _close_particles(tp, jp)
        assert close.mean() >= 0.995, f"{(~close).sum()} particles differ"
        np.testing.assert_allclose(np_(tp.log_weight)[close], np_(jp.log_weight)[close],
                                   rtol=1e-5, atol=1e-2)
        np.testing.assert_allclose(np_(ts1.grid), np.asarray(js1.grid), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np_(ts1.grid) > 0, np.asarray(js1.grid) > 0)
        if jcfg.edt_box is None:
            assert ts1.edt is None
        else:
            np.testing.assert_array_equal(np_(ts1.edt), np.asarray(js1.edt))
        assert (ts1.mcl.step, ts1.mcl.updates) == (int(js1.mcl.step), int(js1.mcl.updates))
    if name == "table_map_every_2":  # step 4 skipped the map update
        np.testing.assert_array_equal(np.asarray(states[4].grid), np.asarray(states[3].grid))


def _moments(p):
    pose = p.pose
    return np.array([np_(v).astype(np.float64).mean() for v in (pose.x, pose.y)]
                    + [np_(v).astype(np.float64).std() for v in (pose.x, pose.y, pose.theta)])


@pytest.mark.parametrize("name", ["table_best", "table_mode_resample_every_4"])
def test_slam_chained_steps_match_jax(name):
    """Five chained steps, each side on its own state (JAX's draws fed to
    the port). A resampled index one slot over picks a neighbour with other
    noise, so clouds are compared by their moments (1e-2 px/rad; measured
    <= 7.7e-6), poses to 1e-2 px/rad (measured <= 1.2e-5) and the grids by
    their blocked masks (<= 0.5% of cells; measured: equal)."""
    jcfg, tcfg = _make(jc, **CONFIGS[name]), _make(tc, **CONFIGS[name])
    states = _run_jax(jcfg, 5)
    ts = tslam.init(0, tcfg, convert.pose(*START))
    for k, z in enumerate(_scans(5)):
        noise, u0 = _draws(states[k])
        ts = tslam.step(ts, Odometry.create(*ODOM), t_scan(z), tcfg, noise=noise, u0=u0)
        js = states[k + 1]
        np.testing.assert_allclose(_moments(ts.mcl.particles), _moments(js.mcl.particles),
                                   rtol=0, atol=1e-2)
        _assert_pose_close(ts.est_pose, js.est_pose, 1e-2)
        _assert_pose_close(ts.mcl.mode_pose, js.mcl.mode_pose, 1e-2)
        flips = np.mean((np_(ts.grid) > 0) != (np.asarray(js.grid) > 0))
        assert flips <= 5e-3, f"step {k}: {flips:.4%} of blocked cells differ"


def test_init_rebuild_predict_and_wrapper():
    """init (default start, EDT cache), rebuild_edt, predict_only,
    prob_map and the GridSLAM wrapper, against the JAX package."""
    jcfg, tcfg = _make(jc, edt_box=80), _make(tc, edt_box=80)
    js = jslam.init(jax.random.key(0), jcfg)
    ts = tslam.init(0, tcfg)
    _assert_pose_close(ts.mcl.best_pose, js.mcl.best_pose, 0.0)
    np.testing.assert_array_equal(np_(ts.grid), np.asarray(js.grid))
    np.testing.assert_array_equal(np_(ts.edt), np.asarray(js.edt))
    assert tslam.init(0, _make(tc)).edt is None

    grid = np.random.default_rng(3).uniform(-1, 1, (H, W)).astype(np.float32)
    ts = tslam.rebuild_edt(ts.replace(grid=torch.from_numpy(grid)), tcfg)
    js = jslam.rebuild_edt(js.replace(grid=jnp.asarray(grid)), jcfg)
    np.testing.assert_array_equal(np_(ts.edt), np.asarray(js.edt))
    np.testing.assert_allclose(np_(tslam.GridSLAM(tcfg, device="cpu").prob_map(ts)),
                               np.asarray(jslam.GridSLAM(jcfg).prob_map(js)), rtol=1e-6)
    np.testing.assert_allclose(np_(tgrid.log_odds(torch.tensor([0.2, 0.5, 0.9]))),
                               np.log(np.array([0.25, 1.0, 9.0])), rtol=1e-6)

    engine = tslam.GridSLAM(tcfg, seed=1, device="cpu")
    ts = engine.init(convert.pose(*START))
    ts = engine.predict(ts, Odometry.create(*ODOM))
    assert ts.mcl.step == 1 and ts.mcl.updates == 0
    ts = engine.step(ts, Odometry.create(*ODOM), t_scan(_scans(1)[0]))
    assert ts.mcl.step == 2 and ts.mcl.updates == 1
    assert torch.isfinite(ts.grid).all() and (ts.grid != 0).any()
    np.testing.assert_array_equal(
        np_(ts.edt), np_(tedt.edt_capped(tgrid.blocked_from_logodds(ts.grid), 17.0)))
    for m in ("best", "mean", "mode"):
        for n in (100, 20_000):
            for k in (1, 4):
                over = dict(map_pose=m if m != "best" else "auto", mcl={"n_particles": n,
                                                                        "resample_every": k})
                assert tslam.resolve_map_pose(_make(tc, **over)) == \
                    jslam.resolve_map_pose(_make(jc, **over))


def test_unported_options_raise():
    """What stays unported raises, naming its item (`resample_fn`: item
    14), and a missing EDT cache is a ValueError. Scan matching and the
    auto tier run now (tests/test_torch_scanmatch.py,
    tests/test_torch_globalloc.py)."""
    ts = tslam.init(0, _make(tc))
    odom, scan = Odometry.create(*ODOM), t_scan(_scans(1)[0])
    with pytest.raises(NotImplementedError, match="item 5"):
        tslam.step(ts, odom, scan, _make(tc), resample_fn=lambda p: p)
    with pytest.raises(ValueError, match="EDT cache"):
        tslam.step(ts, odom, scan, _make(tc, edt_box=80))
    auto = tslam.GridSLAM(_make(tc, mcl={"measurement": "likelihood_field_auto"}), device="cpu")
    assert isinstance(auto._auto, tslam.AutoTierDispatcher)
    out = tslam.step(ts, odom, scan, _make(tc, scanmatch=tc.ScanMatchConfig()))
    assert torch.isfinite(out.est_pose.x) and torch.isfinite(out.est_pose.y)


def test_metrics_copy_matches():
    rng = np.random.default_rng(2)
    est = rng.normal(size=(30, 2))
    rot = np.array([[math.cos(0.3), -math.sin(0.3)], [math.sin(0.3), math.cos(0.3)]])
    gt = est @ rot.T + np.array([2.0, -1.0]) + rng.normal(0, 0.01, (30, 2))
    for a, b in zip(tmetrics.fit_se2(est, gt), jfit(est, gt)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    for align in (False, True):
        assert tmetrics.ate_rmse(est, gt, align) == pytest.approx(jate(est, gt, align))


def test_slam_closed_loop_boxed_table():
    """The port alone, closed loop, in the scenario and to the bound of
    tests/test_mcl.py:299-344: 128x128 room, 256 particles, boxed table
    (lf_table_box=48), noisy truth along a 30-step arc; mean-pose ATE < 8."""
    h = w = 128
    blocked = torch.from_numpy(synthetic_room(h, w))
    cfg = tc.SLAMConfig(
        mcl=tc.MCLConfig(n_particles=256, meas_stddev=3.0,
                         measurement="likelihood_field_table", lf_table_box=48),
        map=tc.MapConfig(height=h, width=w),
        lidar=tc.LidarConfig(max_dist=60.0, n_rays=24, stddev=3.0),
        motion=tc.MotionConfig(alphas=(0.002,) * 4),
        raycast=tc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf"),
    )
    engine = tslam.GridSLAM(cfg, seed=3, device="cpu")
    gt = Pose.create(40.0, 40.0, 0.3)
    state = engine.init(gt)
    g = tmcl.make_generator(4)
    odom = Odometry.create(0.06, 1.5, 0.06)
    est, truth = [], []
    for _ in range(30):
        gt = tmotion.sample_motion_model_odometry(odom, gt, cfg.motion.alphas, generator=g)
        scan = tfake.scan(blocked, gt, cfg.lidar, cfg.raycast)
        state = engine.step(state, odom, scan)
        mp = tmcl.mean_pose(state.mcl)
        est.append([float(mp.x), float(mp.y)])
        truth.append([float(gt.x), float(gt.y)])
    ate = tmetrics.ate_rmse(np.array(est), np.array(truth))
    assert ate < 8.0, f"port SLAM + boxed LF table ATE {ate}"
