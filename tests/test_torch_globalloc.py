"""Global localization and kidnap recovery in slam_tpu_torch against the
JAX package: random-particle injection and `init_uniform` (JAX's draws
injected: exact), the augmented-MCL EMAs, the auto tier's predicate and
its selection (in `mcl.update` and through GridSLAM's host-lagged
dispatcher), filter health and recovery, and the closed loops of
tests/test_mcl.py (kidnap, auto-tier global localization) with the
port's own noise, held to the JAX tests' bounds."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slam_tpu.core.config as jc
from slam_tpu.core.types import Odometry as JOdometry
from slam_tpu.core.types import Particles as JParticles
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.models import mcl as jmcl
from slam_tpu.models import slam as jslam
from slam_tpu.ops import edt as jedt
from slam_tpu.ops import measurement as jmeas
from slam_tpu.ops import resample as jres
from slam_tpu.ops.rayfield import RayField as JRayField
from slam_tpu.utils import diagnostics as jdiag
import slam_tpu_torch.core.config as tc
from slam_tpu_torch.core.types import Odometry
from slam_tpu_torch.models import mcl as tmcl
from slam_tpu_torch.models import slam as tslam
from slam_tpu_torch.ops import measurement as tmeas
from slam_tpu_torch.ops import resample as tres
from slam_tpu_torch.utils import convert
from slam_tpu_torch.utils import diagnostics as tdiag
from torch_port import (
    glbench_run, globalloc_run, jax_noise, kidnap_errors, np_, room, t_pose, t_scan,
)

H, W = 96, 128


def _jax_injection_draws(key, n, shape):
    """The four draws `slam_tpu.ops.resample.inject_random_particles` takes
    from `key`, as torch tensors."""
    h, w = shape
    k_sel, k_i, k_j, k_t = jax.random.split(key, 4)
    return (convert.tensor(jax.random.uniform(k_sel, (n,))),
            convert.tensor(jax.random.randint(k_i, (n,), 0, h)),
            convert.tensor(jax.random.randint(k_j, (n,), 0, w)),
            convert.tensor(jax.random.uniform(k_t, (n,), minval=-jnp.pi, maxval=jnp.pi)))


def _assert_pose_equal(tp, jp):
    for f in ("x", "y", "theta"):
        np.testing.assert_array_equal(np_(getattr(tp, f)), np_(getattr(jp, f)))


@pytest.mark.parametrize("ratio", [0.0, 0.3, 1.0, "tensor"])
def test_inject_random_particles_exact(rng, ratio):
    """With JAX's draws injected the injected poses are equal bit for bit:
    the same particles replaced (select draw < ratio AND a free cell), the
    rest kept, draws on blocked cells keeping the original particle."""
    blocked = room(H, W)
    n = 2000
    x, y, th = (rng.uniform(5, 90, n).astype(np.float32) for _ in range(3))
    lw = rng.normal(size=n).astype(np.float32)
    key = jax.random.key(11)
    r = 0.45 if ratio == "tensor" else ratio
    jp = jres.inject_random_particles(
        key, JParticles(pose=JPose(*(jnp.asarray(v) for v in (x, y, th))), log_weight=lw),
        jnp.asarray(blocked), jnp.float32(r))
    tp = tres.inject_random_particles(
        convert.particles(x, y, th, lw), torch.from_numpy(blocked),
        torch.tensor(r) if ratio == "tensor" else r,
        draws=_jax_injection_draws(key, n, blocked.shape))
    _assert_pose_equal(tp.pose, jp.pose)
    np.testing.assert_array_equal(np_(tp.log_weight), lw)
    moved = np_(tp.pose.x) != x
    if r == 0.0:
        assert not moved.any()
    else:
        assert moved.any()
    # Drawn from the port's own generator: moved particles sit on free cells.
    g = tmcl.make_generator(5)
    own = tres.inject_random_particles(convert.particles(x, y, th, lw),
                                       torch.from_numpy(blocked), 1.0, generator=g)
    i = (H - np_(own.pose.y)).astype(np.int64)
    j = np_(own.pose.x).astype(np.int64)
    mv = np_(own.pose.x) != x
    assert mv.mean() > 0.5 and not blocked[i[mv], j[mv]].any()


def test_init_uniform_exact():
    """init_uniform with JAX's draws equals JAX's bit for bit; the draws
    that landed on blocked cells keep the canvas-center start pose."""
    blocked = room(H, W)
    n = 1500
    key = jax.random.key(4)
    js = jmcl.init_uniform(key, n, jnp.asarray(blocked))
    k_inj, _ = jax.random.split(key)
    ts = tmcl.init_uniform(0, n, torch.from_numpy(blocked),
                           draws=_jax_injection_draws(k_inj, n, blocked.shape))
    _assert_pose_equal(ts.particles.pose, js.particles.pose)
    np.testing.assert_array_equal(np_(ts.particles.log_weight), np.asarray(js.particles.log_weight))
    assert torch.isnan(ts.log_w_slow) and torch.isnan(ts.log_w_fast)
    at_start = np_(ts.particles.pose.x) == W / 2.0
    assert 0 < at_start.mean() < 0.5


def test_weight_average_helpers_match(rng):
    """update_w_averages and injection_ratio to a relative 1e-6."""
    lw = rng.normal(-3, 1, 500).astype(np.float32)
    for ws, wf in ((0.1, 0.1), (0.05, 0.2), (0.3, 0.01)):
        j = jres.update_w_averages(jnp.asarray(lw), jnp.float32(ws), jnp.float32(wf), 0.1, 0.9)
        t = tres.update_w_averages(torch.from_numpy(lw), torch.tensor(ws), torch.tensor(wf),
                                   0.1, 0.9)
        np.testing.assert_allclose([float(v) for v in t], [float(v) for v in j], rtol=1e-6)
        np.testing.assert_allclose(float(tres.injection_ratio(*t)),
                                   float(jres.injection_ratio(*j)), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# Adaptive MCL: EMAs and the capped ratio, step by step from shared states.
# --------------------------------------------------------------------------

N_AD = 512
ODOM = (0.03, 1.2, 0.03)
ALPHAS = (0.002,) * 4


@functools.cache
def _sdf_fields(h=H, w=W):
    blocked = room(h, w)
    jb = jnp.asarray(blocked)
    edt = np.asarray(jedt.edt_jfa(jb))
    return (JRayField(blocked=jb, edt=jnp.asarray(edt)),
            convert.ray_field(blocked, edt=edt))


def _adaptive_cfgs(**over):
    kw = dict(n_particles=N_AD, meas_stddev=3.0, measurement="likelihood_field")
    kw.update(over)
    return (jc.MCLConfig(adaptive=jc.AdaptiveConfig(max_ratio=0.1), **kw),
            tc.MCLConfig(adaptive=tc.AdaptiveConfig(max_ratio=0.1), **kw))


def _carry(js):
    p = js.particles
    return convert.mcl_state(
        convert.particles(p.pose.x, p.pose.y, p.pose.theta, p.log_weight),
        t_pose(js.best_pose), t_pose(js.mode_pose), int(js.step), int(js.updates), seed=0,
        log_w_slow=np.asarray(js.log_w_slow), log_w_fast=np.asarray(js.log_w_fast))


def test_adaptive_update_matches_jax():
    """Six predict -> update steps with adaptive injection, a kidnap after
    the third, each port step from the JAX state carried across with
    JAX's motion, resample and injection draws: the EMAs within a relative
    1e-6 (warm start at the first update: both equal the first average),
    the injected cloud within 1e-3 px on >= 99.5% of particles (the
    systematic resampler's one-slot allowance, ROADMAP.md Queue 3)."""
    jcfg, tcfg = _adaptive_cfgs()
    jfield, tfield = _sdf_fields()
    rc_j = jc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    rc_t = tc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    lidar = jc.LidarConfig(max_dist=60.0, n_rays=18)
    js = jmcl.init(jax.random.key(2), N_AD, JPose.create(40.0, 40.0, 0.3))
    truth = [40.0, 40.0, 0.3]
    for t in range(6):
        if t == 3:
            truth = [90.0, 60.0, -0.8]  # kidnap: the likelihood collapses
        r1, tr, r2 = ODOM
        truth = [truth[0] + tr * math.cos(truth[2] + r1),
                 truth[1] + tr * math.sin(truth[2] + r1), truth[2] + r1 + r2]
        scan = jfake.scan(jfield.blocked, JPose.create(*truth), lidar, rc_j)
        _, sub = jax.random.split(js.key)
        noise = jax_noise(sub, (N_AD,))
        js_p = jmcl.predict(js, JOdometry.create(*ODOM), jnp.asarray(ALPHAS))
        _, k_rs, k_inj = jax.random.split(js_p.key, 3)
        u0 = convert.tensor(jax.random.uniform(k_rs, ()))
        js1 = jmcl.update(js_p, scan, jfield, jcfg, rc_j)

        ts = tmcl.predict(_carry(js), Odometry.create(*ODOM), ALPHAS, noise=noise)
        ts1 = tmcl.update(ts, t_scan(scan), tfield, tcfg, rc_t, u0=u0,
                          inject=_jax_injection_draws(k_inj, N_AD, (H, W)))
        for name in ("log_w_slow", "log_w_fast"):
            np.testing.assert_allclose(float(getattr(ts1, name)), float(getattr(js1, name)),
                                       rtol=1e-6)
        if t == 0:
            assert float(ts1.log_w_slow) == float(ts1.log_w_fast)
        jp, tp = js1.particles.pose, ts1.particles.pose
        close = (np.isclose(np_(tp.x), np_(jp.x), rtol=1e-6, atol=1e-3)
                 & np.isclose(np_(tp.y), np_(jp.y), rtol=1e-6, atol=1e-3))
        assert close.mean() >= 0.995, f"step {t}: {(~close).sum()} particles differ"
        js = js1
    ratio = tmcl.adaptive_emas(ts1.log_w_slow, ts1.log_w_fast,
                               torch.zeros(4), tcfg.adaptive)[2]
    assert 0.0 <= float(ratio) <= 0.1


# --------------------------------------------------------------------------
# The auto tier.
# --------------------------------------------------------------------------


def _clouds(n=64):
    rs = np.random.RandomState(0)
    conv = (40.0 + 0.5 * rs.randn(n), 40.0 + 0.5 * rs.randn(n), 0.3 + 0.01 * rs.randn(n))
    disp = (rs.uniform(5, W - 5, n), rs.uniform(5, H - 5, n), rs.uniform(-np.pi, np.pi, n))
    # Halfway: a tight position spread, headings over +-0.25 rad (4-sigma
    # window ~0.6 = the threshold region avoided) and over a quarter turn.
    mid_tight = (40.0 + rs.randn(n), 40.0 + rs.randn(n), 0.3 + 0.05 * rs.randn(n))
    mid_wide = (40.0 + 3 * rs.randn(n), 40.0 + 3 * rs.randn(n), 0.3 + 0.4 * rs.randn(n))
    return {k: tuple(np.asarray(v, np.float32) for v in c) for k, c in (
        ("converged", conv), ("dispersed", disp), ("tight", mid_tight), ("wide", mid_wide))}


@pytest.mark.parametrize("box", [32, 8, None])
def test_lf_auto_converged_matches(box):
    """The predicate gives JAX's boolean on clouds away from its
    thresholds (converged, dispersed, a tight and a wide middle)."""
    jcfg = jc.MCLConfig(n_particles=64, lf_table_box=box, scanner_offset=(0.0, 2.0, 0.0))
    tcfg = tc.MCLConfig(n_particles=64, lf_table_box=box, scanner_offset=(0.0, 2.0, 0.0))
    seen = set()
    for name, (x, y, th) in _clouds().items():
        j = bool(jmeas.lf_auto_converged(JPose(*(jnp.asarray(v) for v in (x, y, th))), jcfg,
                                         (H, W), scanner_offset=jcfg.scanner_offset))
        t = tmeas.lf_auto_converged(convert.pose(x, y, th), tcfg, (H, W),
                                    scanner_offset=tcfg.scanner_offset)
        assert t.dtype == torch.bool and bool(t) == j, name
        seen.add(j)
    assert seen == {True, False}


def test_auto_update_equals_forced_tiers():
    """`measurement="likelihood_field_auto"` in mcl.update scores a
    converged cloud exactly as the forced boxed table and a dispersed one
    exactly as the forced direct field (one tier, after one read of the
    predicate), and each
    within a relative 1e-5 / absolute 1e-3 of the JAX auto path's weights
    (sums of ~20 beam scores in another order, and the table's lerp
    fraction moved by sin/cos/atan2 ulps: measured max |diff| 7.8e-4)."""
    jfield, tfield = _sdf_fields()
    rc_j = jc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    rc_t = tc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    scan = jfake.scan(jfield.blocked, JPose.create(40.0, 40.0, 0.3),
                      jc.LidarConfig(max_dist=60.0, n_rays=24), rc_j)
    base = dict(n_particles=64, meas_stddev=3.0, lf_table_box=32, ess_threshold=0.0)

    def run_t(meas, cloud):
        st = tmcl.init(0, 64, convert.pose(40.0, 40.0, 0.3))
        st = st.replace(particles=st.particles.replace(pose=convert.pose(*cloud)))
        out = tmcl.update(st, t_scan(scan), tfield, tc.MCLConfig(measurement=meas, **base), rc_t)
        return np_(out.particles.log_weight)

    clouds = _clouds()
    for cloud, want in (("converged", "likelihood_field_table"), ("dispersed", "likelihood_field")):
        other = ({"likelihood_field", "likelihood_field_table"} - {want}).pop()
        auto = run_t("likelihood_field_auto", clouds[cloud])
        np.testing.assert_array_equal(auto, run_t(want, clouds[cloud]))
        assert np.max(np.abs(auto - run_t(other, clouds[cloud]))) > 0.01
        st = jmcl.init(jax.random.key(0), 64, JPose.create(40.0, 40.0, 0.3))
        st = st.replace(particles=st.particles.replace(
            pose=JPose(*(jnp.asarray(v) for v in clouds[cloud]))))
        jauto = jmcl.update(st, scan, jfield, jc.MCLConfig(
            measurement="likelihood_field_auto", **base), rc_j)
        np.testing.assert_allclose(auto, np.asarray(jauto.particles.log_weight), rtol=1e-5,
                                   atol=1e-3)


def _slam_cfg(m, meas="likelihood_field_auto", **over):
    return m.SLAMConfig(
        mcl=m.MCLConfig(n_particles=256, meas_stddev=3.0, measurement=meas, lf_table_box=32,
                        **over),
        map=m.MapConfig(height=128, width=128),
        lidar=m.LidarConfig(max_dist=60.0, n_rays=24),
        raycast=m.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf"),
    )


def test_auto_tier_dispatcher_matches_forced_engines():
    """GridSLAM's host-lagged dispatcher (tests/test_mcl.py:548's case): a
    dispersed cloud steps exactly as the forced-direct engine, a converged
    one as the forced-table engine, from the same generator state, and the
    tier flag equals JAX's dispatcher's for the same cloud. Then seven
    steps from the dispersed cloud: the predicate is read once before the
    first step and once after every 4th (check_every 4), and the tiers
    follow it."""
    blocked = jnp.asarray(room(128, 128))
    start = (40.0, 40.0, 0.3)
    odom = (0.05, 1.5, 0.05)
    scan = jfake.scan(blocked, JPose.create(*start), _slam_cfg(jc).lidar, _slam_cfg(jc).raycast)
    rs = np.random.RandomState(7)
    disp = tuple(np.asarray(v, np.float32) for v in (
        rs.uniform(5, 123, 256), rs.uniform(5, 123, 256), rs.uniform(-np.pi, np.pi, 256)))

    def disperse_t(s):
        return s.replace(mcl=s.mcl.replace(particles=s.mcl.particles.replace(
            pose=convert.pose(*disp))))

    def disperse_j(s):
        return s.replace(mcl=s.mcl.replace(particles=s.mcl.particles.replace(
            pose=JPose(*(jnp.asarray(v) for v in disp)))))

    for prep_t, prep_j, forced in ((disperse_t, disperse_j, "likelihood_field"),
                                   (lambda s: s, lambda s: s, "likelihood_field_table")):
        auto = tslam.GridSLAM(_slam_cfg(tc), seed=0, device="cpu")
        out_a = auto.step(prep_t(auto.init(convert.pose(*start))), Odometry.create(*odom),
                          t_scan(scan))
        eng = tslam.GridSLAM(_slam_cfg(tc, forced), seed=0, device="cpu")
        out_f = eng.step(prep_t(eng.init(convert.pose(*start))), Odometry.create(*odom),
                         t_scan(scan))
        for a, f in ((out_a.mcl.particles.log_weight, out_f.mcl.particles.log_weight),
                     (out_a.mcl.particles.pose.x, out_f.mcl.particles.pose.x), (out_a.grid, out_f.grid)):
            assert torch.equal(a, f), forced
        assert auto._auto.converged == (forced == "likelihood_field_table")
        jauto = jslam.GridSLAM(_slam_cfg(jc), seed=0)
        jauto.step(prep_j(jauto.init(JPose.create(*start))), JOdometry.create(*odom), scan)
        assert jauto._auto.converged == auto._auto.converged

    auto = tslam.GridSLAM(_slam_cfg(tc), seed=1, device="cpu")
    st = disperse_t(auto.init(convert.pose(*start)))
    preds = []
    for k in range(7):
        preds.append(bool(tmeas.lf_auto_converged(st.mcl.particles.pose, _slam_cfg(tc).mcl,
                                                  (128, 128))))
        st = auto.step(st, Odometry.create(*odom), t_scan(scan))
    d = auto._auto
    assert d.check_every == 4 and d.host_reads == 2
    want = ["table" if preds[0] else "direct"] * 4 + ["table" if preds[4] else "direct"] * 3
    assert d.tiers == want
    assert tslam.GridSLAM(_slam_cfg(tc, adaptive=tc.AdaptiveConfig()),
                          device="cpu")._auto.check_every == 1


# --------------------------------------------------------------------------
# Diagnostics.
# --------------------------------------------------------------------------


def test_filter_health_and_recover_match(rng):
    """filter_health within 1e-5; needs_recovery's verdicts; recover with
    JAX's draws equal bit for bit, weights reset to -log N."""
    n = 600
    x, y, th = (rng.uniform(5, 90, n).astype(np.float32) for _ in range(3))
    blocked = room(H, W)
    for lw in (rng.normal(size=n).astype(np.float32), np.zeros(n, np.float32),
               np.where(np.arange(n) == 3, 0.0, -40.0).astype(np.float32)):
        jstate = jmcl.init(jax.random.key(0), n, JPose.create(1.0, 2.0, 0.0)).replace(
            particles=JParticles(pose=JPose(*(jnp.asarray(v) for v in (x, y, th))),
                                 log_weight=jnp.asarray(lw)))
        tstate = tmcl.init(0, n, convert.pose(1.0, 2.0, 0.0)).replace(
            particles=convert.particles(x, y, th, lw))
        jh, th_ = jdiag.filter_health(jstate), tdiag.filter_health(tstate)
        for k in jh:
            np.testing.assert_allclose(float(th_[k]), float(jh[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        for floor, ceil in ((0.02, None), (0.5, None), (0.02, 10.0)):
            assert tdiag.needs_recovery(th_, floor, ceil) == jdiag.needs_recovery(jh, floor, ceil)
        key = jax.random.key(9)
        jr = jdiag.recover(key, jstate, jnp.asarray(blocked), 0.5)
        tr = tdiag.recover(tstate, torch.from_numpy(blocked), 0.5,
                           draws=_jax_injection_draws(key, n, blocked.shape))
        _assert_pose_equal(tr.particles.pose, jr.particles.pose)
        np.testing.assert_array_equal(np_(tr.particles.log_weight),
                                      np.asarray(jr.particles.log_weight))
    bad = tstate.replace(particles=convert.particles(x, y, np.full(n, np.nan, np.float32), lw))
    assert bool(tdiag.filter_health(bad)["any_nan"]) and tdiag.needs_recovery(
        tdiag.filter_health(bad))


# --------------------------------------------------------------------------
# Closed loops, the port alone.
# --------------------------------------------------------------------------


def test_kidnap_recovery_with_capped_injection():
    """tests/test_mcl.py:347-392 on the port (`torch_port.kidnap_errors`):
    1024 particles, direct likelihood field, AdaptiveConfig(max_ratio=0.1);
    tracking, a teleport, re-localization: mode_pose within 2 px before
    the kidnap, then min error < 3 px and mean of the last 10 < 4 px.
    Recovery within the 40 steps is a matter of the draws: over filter
    seeds 0-39 (truth seed + 100) the port met both bounds in 8 of 40 runs
    and the JAX package, in the same loop, in 13 of 40 (the JAX test's seed
    is one that does); both tracked before the kidnap in all 40 (`python
    tests/torch_port.py kidnap 0 40`). The port's seed here, 6, is one that
    recovers."""
    errs = kidnap_errors("port", 6)
    assert errs[9] < 2.0
    after = errs[10:]
    assert min(after) < 3.0, f"never re-localized: min err {min(after):.2f}"
    assert np.mean(after[-10:]) < 4.0, f"unstable tail: {after[-10:]}"


def test_auto_tier_global_localization_converges():
    """tests/test_mcl.py:501-545 on the port (`torch_port.globalloc_run`):
    init_uniform over the room, 2048 particles,
    measurement="likelihood_field_auto" (the direct field while dispersed,
    the boxed table once converged), 12 steps; the mean pose ends within 10
    px of the truth and the cloud fits the box. The cloud collapses onto
    the nearest init particle, so the error depends on the draws: over init
    seeds 0-39 (truth seed + 1) 25 of 40 port runs ended within 10 px, and
    25 of 40 in the JAX package (`python tests/torch_port.py globalloc 0
    40`). The port's seed here, 6, is one within the bound."""
    cfg, st0, st, e = globalloc_run("port", 6)
    assert float(torch.std(st0.particles.pose.x, correction=0)) > cfg.lf_table_box
    assert not bool(tmeas.lf_auto_converged(st0.particles.pose, cfg, (128, 128)))
    assert e < 10.0, f"auto-tier global localization error {e}"
    assert float(torch.std(st.particles.pose.x, correction=0)) * cfg.lf_auto_sigma < (
        cfg.lf_table_box / 2)
    assert bool(tmeas.lf_auto_converged(st.particles.pose, cfg, (128, 128)))


def test_global_loc_bench_planted_converges_in_both():
    """tools/global_loc_bench.py's configuration (the 599x1297 plan, the
    360-bin bf16 LUT, 90 beams) at 2000 particles, 50 of them planted next
    to the truth's start pose by the same numpy draws in both packages
    (`torch_port.glbench_run`, the port's side through
    `slam_tpu_torch/tools/global_loc_bench.py`): both filters converge on
    the truth (spread < 20 px, error < 10 px) within 3 of 8 steps and keep
    the post-convergence ATE below 2 px, as a right weighting and
    resampling must."""
    runs = {pkg: glbench_run(pkg, 0, 2000, plant=50, steps=8) for pkg in ("port", "jax")}
    for pkg, r in runs.items():
        assert r["finite"], pkg
        assert r["converged_at_step"] is not None and r["converged_at_step"] <= 3, (pkg, r)
        assert r["post_convergence_ate_px"] < 2.0, (pkg, r)
