"""slam_tpu_torch.ops.scanmatch against slam_tpu.ops.scanmatch (the same
field, seed pose and scan: refined pose within 1e-4 px / 1e-5 rad, which
also pins the integer argmax, since a flip moves the pose by a cell or a
heading bin), the coarse level and the quadratic peak fit, and the SLAM
step with `SLAMConfig.scanmatch` from a shared state."""

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
from slam_tpu.ops import edt as jedt
from slam_tpu.ops import rayfield as jrf
from slam_tpu.ops import scanmatch as jsm
from slam_tpu.ops.measurement import sensor_pose as jsensor
import slam_tpu_torch.core.config as tc
from slam_tpu_torch.core.types import Odometry
from slam_tpu_torch.models import slam as tslam
from slam_tpu_torch.ops import scanmatch as tsm
from slam_tpu_torch.utils import convert
from torch_port import assert_angles_close, jax_noise, np_, t_pose, t_scan

STDDEV = 3.0
TRUE = (52.0, 47.0, 0.8)


@functools.cache
def _field():
    blocked = jnp.asarray(synthetic_room())
    edt = jedt.edt_jfa(blocked, max_dist=5.0 * STDDEV + 2.0)
    return (jrf.RayField(blocked=blocked, edt=edt),
            convert.ray_field(np.asarray(blocked), edt=np.asarray(edt)))


def _scan(pose, offset=(0.0, 0.0, 0.0)):
    jfield, _ = _field()
    rc = jc.RaycastConfig(step=0.5, max_dist=60.0)
    lidar = jc.LidarConfig(max_dist=60.0, n_rays=48, stddev=0.0)
    return jfake.scan(jfield.blocked, jsensor(JPose.create(*pose), offset), lidar, rc), rc


def _assert_refined_close(tp, jp):
    np.testing.assert_allclose([float(tp.x), float(tp.y)], [float(jp.x), float(jp.y)],
                               rtol=0, atol=1e-4)
    assert_angles_close(np_(tp.theta), np_(jp.theta), atol=1e-5)


CASES = {
    "perturbed_a": dict(seed=(2.3, -1.7, 0.03)),
    "perturbed_b": dict(seed=(-3.1, 0.4, -0.04)),
    "at_truth": dict(seed=(0.0, 0.0, 0.0)),
    "no_subcell": dict(seed=(1.0, -1.0, 0.02), cfg=dict(subcell=False)),
    "offset": dict(seed=(2.0, -1.0, 0.02), offset=(0.0, 5.0, 0.1)),
    "coarse": dict(seed=(7.5, -9.0, 0.12), cfg=dict(coarse_window=12)),
    "coarse_offset": dict(seed=(-10.0, 6.0, -0.1), offset=(0.0, 5.0, 0.1),
                          cfg=dict(coarse_window=12, coarse_stride=3)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_refine_pose_matches_jax(name):
    """Refined robot pose within 1e-4 px and 1e-5 rad of JAX's, and the
    peak score within 1e-4 relative, with the coarse level off and on, a
    scanner offset, and without the subcell fit. Measured: <= 7.7e-6 px
    and <= 3.7e-6 rad over the cases; no argmax flipped."""
    case = CASES[name]
    offset = case.get("offset", (0.0, 0.0, 0.0))
    scan, rc = _scan(TRUE, offset)
    seed = tuple(t + d for t, d in zip(TRUE, case["seed"]))
    jcfg = jc.ScanMatchConfig(**case.get("cfg", {}))
    tcfg = tc.ScanMatchConfig(**case.get("cfg", {}))
    jfield, tfield = _field()
    jp, jpeak = jsm.refine_pose(jfield, JPose.create(*seed), scan, rc=rc, cfg=jcfg,
                                scanner_offset=offset, stddev=STDDEV)
    tp, tpeak = tsm.refine_pose(tfield, convert.pose(*seed), t_scan(scan),
                                rc=tc.RaycastConfig(step=0.5, max_dist=60.0), cfg=tcfg,
                                scanner_offset=offset, stddev=STDDEV)
    assert tp.x.shape == () and tpeak.shape == ()
    _assert_refined_close(tp, jp)
    np.testing.assert_allclose(float(tpeak), float(jpeak), rtol=1e-4)
    # And it refines: within a cell / a heading bin of the truth.
    assert abs(float(tp.x) - TRUE[0]) < 1.0 and abs(float(tp.y) - TRUE[1]) < 1.0


def test_coarse_shift_and_peak_delta_match():
    """The coarse level alone (stride-max-pooled field, asymmetric -inf
    padding) gives JAX's block center to 1e-4 px / 1e-5 rad, and the
    quadratic peak fit JAX's offsets to 1e-6 on random triples (concave,
    flat and convex)."""
    from slam_tpu.ops import measurement as jm
    from slam_tpu_torch.ops import measurement as tm

    jfield, tfield = _field()
    scan, rc = _scan(TRUE)
    for stride, window in ((4, 12), (3, 9), (5, 20)):
        jcfg = jc.ScanMatchConfig(coarse_window=window, coarse_stride=stride, window=5)
        tcfg = tc.ScanMatchConfig(coarse_window=window, coarse_stride=stride, window=5)
        jl = jm.lf_log_score_field(jnp.abs(jfield.edt - 0.5), stddev=STDDEV, z_hit=0.95,
                                   z_rand=0.05, max_dist=60.0)
        tl = tm.lf_log_score_field(torch.abs(tfield.edt - 0.5), stddev=STDDEV, z_hit=0.95,
                                   z_rand=0.05, max_dist=60.0)
        floor = float(math.log(0.05 / 60.0))
        seed = (TRUE[0] + 8.0, TRUE[1] - 6.0, TRUE[2] + 0.1)
        jp = jsm._coarse_shift(jl, JPose.create(*seed), scan, rc=rc, cfg=jcfg,
                               scanner_offset=(0.0, 0.0, 0.0), floor_val=floor)
        tp = tsm._coarse_shift(tl, convert.pose(*seed), t_scan(scan), rc=rc, cfg=tcfg,
                               scanner_offset=(0.0, 0.0, 0.0), floor_val=floor)
        _assert_refined_close(tp, jp)
    rng = np.random.default_rng(0)
    trip = rng.normal(size=(3, 500)).astype(np.float32)
    trip[:, :50] = 1.0  # flat
    want = np.asarray(jsm._peak_delta(*(jnp.asarray(v) for v in trip)))
    got = np_(tsm._peak_delta(*(torch.from_numpy(v) for v in trip)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[:50] == 0).all() and np.abs(got).max() <= 0.5


def test_flat_surface_returns_seed():
    """All-max-range scans carry no information: the center-preferring
    tiebreak keeps the seed pose (tests/test_scanmatch.py's case)."""
    from slam_tpu_torch.models import fake_lidar as tfake
    from slam_tpu_torch.ops import edt as tedt
    from slam_tpu_torch.ops.rayfield import RayField

    blocked = torch.zeros((64, 64), dtype=torch.bool)
    field = RayField(blocked=blocked, edt=tedt.edt_jfa(blocked, max_dist=17.0))
    rc = tc.RaycastConfig(step=1.0, max_dist=20.0)
    seed = convert.pose(32.0, 32.0, 0.3)
    scan = tfake.scan(blocked, seed, tc.LidarConfig(max_dist=20.0, n_rays=16), rc)
    refined, _ = tsm.refine_pose(field, seed, scan, rc=rc)
    np.testing.assert_allclose([float(refined.x), float(refined.y), float(refined.theta)],
                               [32.0, 32.0, 0.3], atol=1e-4)


# --------------------------------------------------------------------------
# The SLAM step with scan matching.
# --------------------------------------------------------------------------

H = W = 96
N = 256
ODOM = (0.06, 1.5, 0.06)
START = (40.0, 40.0, 0.3)


def _slam(m, mapping):
    return m.SLAMConfig(
        mcl=m.MCLConfig(n_particles=N, meas_stddev=3.0, measurement="likelihood_field_table",
                        lf_table_box=48),
        map=m.MapConfig(height=H, width=W),
        lidar=m.LidarConfig(max_dist=60.0, n_rays=24, stddev=3.0),
        motion=m.MotionConfig(alphas=(0.002,) * 4),
        raycast=m.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf"),
        scanmatch=m.ScanMatchConfig(mapping=mapping),
    )


@pytest.mark.parametrize("mapping", [False, True], ids=["estimate", "mapping"])
def test_slam_step_with_scanmatch_matches_jax(mapping):
    """Steps 3 and 4 of a deterministic arc, each from the JAX state
    carried across with JAX's draws injected: est_pose (the refined pose)
    and best_pose within 1e-3 px / rad (the best pose feeds the
    refinement; measured <= 1.2e-5), the grid within 1e-6 and its blocked
    mask equal (with `mapping`, the map follows the refined pose)."""
    jcfg, tcfg = _slam(jc, mapping), _slam(tc, mapping)
    blocked = jnp.asarray(synthetic_room(H, W))
    step = jax.jit(lambda s, o, z: jslam.step(s, o, z, jcfg))
    js = jslam.init(jax.random.key(0), jcfg, JPose.create(*START))
    truth = list(START)
    for k in range(5):
        r1, t, r2 = ODOM
        truth = [truth[0] + t * math.cos(truth[2] + r1),
                 truth[1] + t * math.sin(truth[2] + r1), truth[2] + r1 + r2]
        scan = jfake.scan(blocked, JPose.create(*truth), jcfg.lidar,
                          jc.RaycastConfig(step=1.0, max_dist=60.0))
        js1 = step(js, JOdometry.create(*ODOM), scan)
        if k >= 3:
            key, sub = jax.random.split(js.mcl.key)
            _, k_rs, _ = jax.random.split(key, 3)
            m, p = js.mcl, js.mcl.particles
            ts = convert.slam_state(
                np.asarray(js.grid), None,
                convert.particles(p.pose.x, p.pose.y, p.pose.theta, p.log_weight),
                t_pose(m.best_pose), t_pose(m.mode_pose), t_pose(js.est_pose),
                int(m.step), int(m.updates), seed=0)
            ts1 = tslam.step(ts, Odometry.create(*ODOM), t_scan(scan), tcfg,
                             noise=jax_noise(sub, (N,)),
                             u0=convert.tensor(jax.random.uniform(k_rs, ())))
            for tp, jp in ((ts1.est_pose, js1.est_pose), (ts1.mcl.best_pose, js1.mcl.best_pose)):
                np.testing.assert_allclose([float(tp.x), float(tp.y)],
                                           [float(jp.x), float(jp.y)], atol=1e-3)
                assert_angles_close(np_(tp.theta), np_(jp.theta), atol=1e-3)
            assert float(ts1.est_pose.x) != float(ts1.mcl.best_pose.x)
            np.testing.assert_allclose(np_(ts1.grid), np.asarray(js1.grid), rtol=0, atol=1e-6)
            np.testing.assert_array_equal(np_(ts1.grid) > 0, np.asarray(js1.grid) > 0)
        js = js1
