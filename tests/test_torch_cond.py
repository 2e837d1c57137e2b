"""The port's device control flow (`slam_tpu_torch/core/graph.py:cond` and
`Chain`) against the JAX package's `lax.cond` / `lax.while_loop`, on the
CPU: here `cond` runs both branches and selects (JAX's lowering under
`vmap`), so every case runs under `no_host_reads`, which shows that the
code a graph captures on the card reads nothing on the host.

  * `cond` selects as `lax.cond` does;
  * `edt_refresh` takes each of its three branches (no flip, window, full
    rebuild) bit for bit JAX's jitted `edt_refresh`;
  * six SLAM steps with `edt_box` against JAX's `slam.step`;
  * the auto-tier `MCL.update` / `MCL.step` equal the forced tier;
  * the fleet's auto step (R = 3, 512 particles) against JAX's `vmap`ped
    `fleet_step`;
  * an `ess_threshold = 0.5` update against JAX, resampling and not, and
    the gate a row of [R, N] rows equal to single filters;
  * each planner's search as chains of one block a run equals its
    search as the module's own chains.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core import config as jc
from slam_tpu.core.types import Odometry as JOdometry
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.models import fleet as jfleet
from slam_tpu.models import mcl as jmcl
from slam_tpu.ops import edt as jedt
from slam_tpu_torch.core import config as tc
from slam_tpu_torch.core.config import HybridAStarConfig, RRTStarConfig
from slam_tpu_torch.core.graph import cond
from slam_tpu_torch.core.types import Odometry, Pose
from slam_tpu_torch.models import fleet as tfleet
from slam_tpu_torch.models import mcl as tmcl
from slam_tpu_torch.models import slam as tslam
from slam_tpu_torch.ops import edt as tedt
from slam_tpu_torch.planners import HybridAStar, RRTStar, _graph
from slam_tpu_torch.planners import astar as tastar
from slam_tpu_torch.planners import rrtstar as trrt
from slam_tpu_torch.utils import convert
from test_torch_fleet import ALPHAS as FLEET_ALPHAS
from test_torch_fleet import _jax_draws, _stack, _t_scans, _t_state
from test_torch_globalloc import _sdf_fields
from test_torch_graph import RRT_A, RRT_B, _continuous, chain_runs
from test_torch_hastar import A, B, BASE, HA_FIELDS, LAT_FIELDS, WALL
from test_torch_rrtstar import KW as RRT_KW
from test_torch_slam import _carry, _close_particles, _draws, _make, _run_jax, _scans
from torch_port import no_host_reads, np_, t_scan


def _bits(t) -> np.ndarray:
    a = np_(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


# -- cond ---------------------------------------------------------------------

@pytest.mark.parametrize("pick", [True, False])
def test_cond_selects_like_lax_cond(pick):
    """Tuple outputs, an operand returned unchanged and a nested cond: the
    port's result is `lax.cond`'s bit for bit, with no host read."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(64).astype(np.float32)
    y = rng.standard_normal(64).astype(np.float32)

    def branches(m, c):  # correctly rounded arithmetic only
        def yes(a, b):
            inner = c(m.sum(a) > 0, lambda u: u * 2.0, lambda u: u - 1.0, a)
            return inner, b * 4.0

        def no(a, b):
            return a, b + 3.0

        return yes, no

    jyes, jno = branches(jnp, lambda p, f, g, *o: jax.lax.cond(p, f, g, *o))
    want = jax.jit(lambda a, b: jax.lax.cond(pick, jyes, jno, a, b))(x, y)
    tyes, tno = branches(torch, cond)
    with no_host_reads():
        got = cond(torch.tensor(pick), tyes, tno, torch.from_numpy(x), torch.from_numpy(y))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), np.asarray(w).view(np.int32))
    with pytest.raises(ValueError, match="structures"):
        cond(torch.tensor(pick), lambda a: (a, a), lambda a: (a,), torch.zeros(2))


# -- edt_refresh ----------------------------------------------------------------

EDT_H, EDT_W, EDT_CAP, EDT_BOX = 128, 160, 5.0, 40  # reach 6: the box must exceed 24


@functools.cache
def _jax_refresh():
    return jax.jit(functools.partial(jedt.edt_refresh, max_dist=EDT_CAP, box=EDT_BOX))


@pytest.mark.parametrize("branch", ["none", "window", "full"])
def test_edt_refresh_branches_match_jax(branch):
    """Each of the refresh's three branches, chosen under `cond` with no
    host read, equals JAX's jitted `edt_refresh` and the full rebuild bit
    for bit."""
    rng = np.random.default_rng(7)
    old = rng.random((EDT_H, EDT_W)) < 0.04
    new = old.copy()
    if branch == "window":
        new[60:66, 70:78] ^= True
    elif branch == "full":
        new[2:4, 2:4] ^= True
        new[120, 150] ^= True  # opposite corners fit no window
    t_old, t_new = torch.from_numpy(old), torch.from_numpy(new)
    prev = tedt.edt_capped(t_old, EDT_CAP)
    with no_host_reads():
        got = tedt.edt_refresh(prev, t_old, t_new, max_dist=EDT_CAP, box=EDT_BOX)
    any_diff, fits, _, _ = (bool(v) for v in tedt._refresh_plan(
        t_old, t_new, reach=tedt.edt_capped_reach(EDT_CAP), box=EDT_BOX))
    assert any_diff == (branch != "none")
    assert fits == (branch == "window") or not any_diff
    want = _jax_refresh()(jnp.asarray(np_(prev)), jnp.asarray(old), jnp.asarray(new))
    np.testing.assert_array_equal(_bits(got), np.asarray(want).view(np.int32))
    np.testing.assert_array_equal(_bits(got), _bits(tedt.edt_capped(t_new, EDT_CAP)))


# -- SLAM with edt_box ------------------------------------------------------------

def test_slam_edt_box_steps_match_jax():
    """Six SLAM steps with `edt_box` (steps 1-6), each from the JAX state
    carried across with its draws injected and run under `no_host_reads`:
    the EDT cache bit for bit, the grid to 1e-6, poses and weights within
    test_torch_slam.py's tolerances (the systematic resampler's one-slot
    allowance, ROADMAP.md Queue 3). Step 0 is the bootstrap against the
    empty grid: every weight ties, the ESS equals N up to rounding, and
    `ess <= N` falls either way (JAX keeps the cloud, the port resamples,
    with or without `edt_box`), as ROADMAP.md Queue 3 notes."""
    over = dict(edt_box=80)
    jcfg, tcfg = _make(jc, **over), _make(tc, **over)
    states = _run_jax(jcfg, 7)
    for k in range(1, 7):
        js0, js1 = states[k], states[k + 1]
        noise, u0 = _draws(js0)
        with no_host_reads():
            ts1 = tslam.step(_carry(js0), Odometry.create(0.06, 1.5, 0.06),
                             t_scan(_scans(7)[k]), tcfg, noise=noise, u0=u0)
        np.testing.assert_array_equal(_bits(ts1.edt), np.asarray(js1.edt).view(np.int32))
        np.testing.assert_allclose(np_(ts1.grid), np.asarray(js1.grid), rtol=0, atol=1e-6)
        close = _close_particles(ts1.mcl.particles, js1.mcl.particles)
        assert close.mean() >= 0.995, f"step {k}: {(~close).sum()} particles differ"
        np.testing.assert_allclose(np_(ts1.mcl.particles.log_weight)[close],
                                   np.asarray(js1.mcl.particles.log_weight)[close],
                                   rtol=1e-5, atol=1e-2)
    assert np.isfinite(np_(ts1.est_pose.x))


# -- the auto tier -----------------------------------------------------------------

def _clouds(n, h, w):
    rs = np.random.RandomState(1)
    conv = (40.0 + 0.5 * rs.randn(n), 40.0 + 0.5 * rs.randn(n), 0.3 + 0.01 * rs.randn(n))
    disp = (rs.uniform(5, w - 5, n), rs.uniform(5, h - 5, n), rs.uniform(-np.pi, np.pi, n))
    return {k: tuple(np.asarray(v, np.float32) for v in c)
            for k, c in (("converged", conv), ("dispersed", disp))}


@pytest.mark.parametrize("call", ["update", "step"])
@pytest.mark.parametrize("cloud", ["converged", "dispersed"])
def test_auto_tier_entry_points_equal_forced_tier(cloud, call):
    """`MCL.update` and `MCL.step` with likelihood_field_auto run as one
    block each under `no_host_reads` (the tier a `cond` in the block) and
    equal the tier the predicate picks, forced, bit for bit, resampling
    included."""
    _, tfield = _sdf_fields()
    h, w = tfield.blocked.shape
    rc = tc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    scan = t_scan(jfake.scan(jnp.asarray(np_(tfield.blocked)), JPose.create(40.0, 40.0, 0.3),
                             jc.LidarConfig(max_dist=60.0, n_rays=24),
                             jc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")))
    base = dict(n_particles=256, meas_stddev=3.0, lf_table_box=32)
    x, y, th = _clouds(256, h, w)[cloud]

    def start():
        st = tmcl.init(4, 256, convert.pose(40.0, 40.0, 0.3))
        return st.replace(particles=st.particles.replace(pose=convert.pose(x, y, th)))

    auto = tc.MCLConfig(measurement="likelihood_field_auto", **base)
    forced = tc.MCLConfig(measurement="likelihood_field_table" if cloud == "converged"
                          else "likelihood_field", **base)
    eng = tmcl.MCL(auto, rc, device="cpu")
    eng.graphs.guard = no_host_reads
    odom = Odometry.create(0.02, 0.5, 0.01)
    alphas = (1e-3, 1e-3, 5e-3, 5e-3)
    if call == "update":
        got = eng.update(start(), scan, tfield)
        want = tmcl.update(start(), scan, tfield, forced, rc)
    else:
        got = eng.step(start(), odom, alphas, scan, tfield)
        want = tmcl.step(start(), odom, alphas, scan, tfield, forced, rc)
    assert [k[0][0] for k in eng.graphs.cache.blocks] == [call]
    for a, b in ((got.particles.pose.x, want.particles.pose.x),
                 (got.particles.pose.y, want.particles.pose.y),
                 (got.particles.log_weight, want.particles.log_weight),
                 (got.best_pose.x, want.best_pose.x), (got.mode_pose.theta, want.mode_pose.theta)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


def test_fleet_auto_step_matches_jax():
    """The fleet's auto step, R = 3 x 512 particles, robots 0 and 2
    converged and robot 1 dispersed, so both tiers run, each under a
    `cond` on whether some robot needs it, with no host read (ess_threshold
    0: no resample). Each robot's weights are its tier's, forced, bit for
    bit, and JAX's `vmap` of the auto update (compute both, select) to
    rtol 1e-5 / atol 1e-3 (test_torch_globalloc.py's), but on the
    particles where the forced table tier itself differs from JAX's (a
    heading on a table bin's edge after the motion draws' sin / cos ulps:
    16 of robot 2's 512 here), which the auto step then matches. The
    graphed `MCLFleet.step` equals the free function bit for bit."""
    jfield, tfield = _sdf_fields()
    h, w = tfield.blocked.shape
    n, r = 512, 3
    kw = dict(step=1.0, max_dist=60.0, backend="sdf")
    base = dict(n_particles=n, meas_stddev=3.0, lf_table_box=32, ess_threshold=0.0)
    jrc, trc = jc.RaycastConfig(**kw), tc.RaycastConfig(**kw)
    clouds = _clouds(n, h, w)
    picks = ["converged", "dispersed", "converged"]
    lidar = jc.LidarConfig(max_dist=60.0, n_rays=24)
    scans = [jfake.scan(jfield.blocked, JPose.create(40.0, 40.0, 0.3), lidar, jrc)] * r
    odom = JOdometry.create(0.02, 0.5, 0.01)
    odoms = Odometry.create([0.02] * r, [0.5] * r, [0.01] * r)
    pose = JPose(*(jnp.asarray(np.stack([clouds[p][i] for p in picks])) for i in range(3)))
    lw = {}
    for meas in ("likelihood_field_auto", "likelihood_field_table", "likelihood_field"):
        fl = jfleet.MCLFleet(r, jc.MCLConfig(measurement=meas, **base), jrc, seed=5)
        states = fl.init(_stack([JPose.create(40.0, 40.0, 0.3)] * r))
        states = states.replace(particles=states.particles.replace(pose=pose))
        noise, u0 = _jax_draws(states, n)
        with no_host_reads():
            ts = tfleet.fleet_step(_t_state(states), odoms, _t_scans(scans), tfield,
                                   FLEET_ALPHAS, tc.MCLConfig(measurement=meas, **base), trc,
                                   u0=u0, noise=noise)
        js = fl.step(states, _stack([odom] * r), _stack(scans), jfield,
                     jnp.asarray(FLEET_ALPHAS))
        np.testing.assert_allclose(np_(ts.particles.pose.x), np.asarray(js.particles.pose.x),
                                   rtol=1e-6, atol=1e-4)
        lw[meas] = (np_(ts.particles.log_weight), np.asarray(js.particles.log_weight))
    conv = np.array([p == "converged" for p in picks])[:, None]
    auto, table, direct = (lw[m] for m in ("likelihood_field_auto", "likelihood_field_table",
                                          "likelihood_field"))
    np.testing.assert_array_equal(auto[0].view(np.int32),
                                  np.where(conv, table[0], direct[0]).view(np.int32))

    def near(a, b):
        return np.abs(a - b) <= 1e-3 + 1e-5 * np.abs(b)

    edge = ~np.where(conv, near(*table), near(*direct))
    assert edge.mean(axis=1).max() <= 0.05
    assert near(*auto)[~edge].all()

    fl = jfleet.MCLFleet(r, jc.MCLConfig(measurement="likelihood_field_auto", **base), jrc,
                         seed=5)
    states = fl.init(_stack([JPose.create(40.0, 40.0, 0.3)] * r))
    states = states.replace(particles=states.particles.replace(pose=pose))
    tcfg = tc.MCLConfig(measurement="likelihood_field_auto", **base)
    eng = tfleet.MCLFleet(r, tcfg, trc, seed=5, device="cpu")
    eng.graphs.guard = no_host_reads
    got = eng.step(_t_state(states, seed=5), odoms, _t_scans(scans), tfield, FLEET_ALPHAS)
    want = tfleet.fleet_step(_t_state(states, seed=5), odoms, _t_scans(scans), tfield,
                             FLEET_ALPHAS, tcfg, trc)
    for a, b in ((got.particles.pose.x, want.particles.pose.x),
                 (got.particles.log_weight, want.particles.log_weight)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# -- the ESS gate --------------------------------------------------------------------

@pytest.mark.parametrize("cloud", ["converged", "dispersed"])
def test_ess_gated_update_matches_jax(cloud):
    """`ess_threshold = 0.5`: the resampler runs under `cond(do_it, ...)`
    (JAX's `lax.cond`, `slam_tpu/models/mcl.py:331`) with its draw made
    first; the converged cloud keeps its weights (no resample), the
    dispersed one resamples. Poses and weights as test_torch_mcl.py holds
    them (1e-3 px on >= 99.5% of particles, log weights rtol 1e-5 / atol
    1e-3), under `no_host_reads`."""
    jfield, tfield = _sdf_fields()
    h, w = tfield.blocked.shape
    n = 512
    kw = dict(step=1.0, max_dist=60.0, backend="sdf")
    base = dict(n_particles=n, meas_stddev=3.0, measurement="likelihood_field",
                ess_threshold=0.5)
    x, y, th = _clouds(n, h, w)[cloud]
    js = jmcl.init(jax.random.key(2), n, JPose.create(40.0, 40.0, 0.3))
    js = js.replace(particles=js.particles.replace(pose=JPose(*(jnp.asarray(v)
                                                               for v in (x, y, th)))))
    scan = jfake.scan(jfield.blocked, JPose.create(40.0, 40.0, 0.3),
                      jc.LidarConfig(max_dist=60.0, n_rays=24), jc.RaycastConfig(**kw))
    _, k_rs, _ = jax.random.split(js.key, 3)
    u0 = convert.tensor(jax.random.uniform(k_rs, ()))
    jout = jmcl.update(js, scan, jfield, jc.MCLConfig(**base), jc.RaycastConfig(**kw))
    ts = tmcl.init(2, n, convert.pose(40.0, 40.0, 0.3))
    ts = ts.replace(particles=ts.particles.replace(pose=convert.pose(x, y, th)))
    with no_host_reads():
        tout = tmcl.update(ts, t_scan(scan), tfield, tc.MCLConfig(**base),
                           tc.RaycastConfig(**kw), u0=u0)
    resampled = bool(np.all(np.asarray(jout.particles.log_weight)
                            == np.asarray(jout.particles.log_weight)[0]))
    assert resampled == (cloud == "dispersed")
    jp, tp = jout.particles, tout.particles
    close = (np.isclose(np_(tp.pose.x), np.asarray(jp.pose.x), rtol=1e-6, atol=1e-3)
             & np.isclose(np_(tp.pose.y), np.asarray(jp.pose.y), rtol=1e-6, atol=1e-3))
    assert close.mean() >= 0.995, f"{(~close).sum()} particles differ"
    np.testing.assert_allclose(np_(tp.log_weight)[close], np.asarray(jp.log_weight)[close],
                               rtol=1e-5, atol=1e-3)


def test_ess_gate_rows_equal_single_filters():
    """The ESS gate a row: `_finish` on [R, N] rows, flat and peaked
    weights mixed at `ess_threshold = 0.5` (the gate handed to the
    resampler, as the kernel chain reads it on the card), equals each row
    run as one filter, whose gate is a `cond`, bit for bit, under
    `no_host_reads`; the flat rows keep their particles and weights."""
    n, r = 512, 4
    rng = np.random.default_rng(6)
    x, y, th = (rng.uniform(5, 75, (r, n)).astype(np.float32) for _ in range(3))
    spread = np.array([0.01, 5.0, 0.02, 8.0], np.float32)[:, None]
    lw = torch.from_numpy((rng.standard_normal((r, n)) * spread).astype(np.float32))
    u0 = torch.from_numpy(rng.uniform(0, 1, r).astype(np.float32))
    cfg = tc.MCLConfig(n_particles=n, ess_threshold=0.5)
    pose = Pose(*(torch.from_numpy(v) for v in (x, y, th)))
    one = tmcl.init(0, n, convert.pose(40.0, 40.0, 0.3))
    lw0 = one.particles.log_weight
    rows = one.replace(particles=one.particles.replace(
        pose=pose, log_weight=lw0.expand(r, n).contiguous()))
    with no_host_reads():
        got = tmcl._finish(rows, lw, cfg, u0=u0)
        singles = [tmcl._finish(one.replace(particles=one.particles.replace(
            pose=Pose(x=pose.x[q], y=pose.y[q], theta=pose.theta[q]))), lw[q], cfg, u0=u0[q])
            for q in range(r)]
    gp = got.particles
    for q, s_ in enumerate(singles):
        sp = s_.particles
        for a, b in ((gp.pose.x[q], sp.pose.x), (gp.pose.theta[q], sp.pose.theta),
                     (gp.log_weight[q], sp.log_weight)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        kept = bool(torch.equal(sp.log_weight, lw0 + lw[q]))
        assert kept == (q % 2 == 0)


# -- the planners' chains ----------------------------------------------------------------

@pytest.mark.parametrize("search", ["lattice", "continuous", "rrt", "astar"])
def test_one_block_a_run_equals_the_default_chain(search, monkeypatch):
    """Each planner's search as chains of one block a run (`_CHAIN_RUNS` 1:
    every block its own run, the host loop reading the flag before each)
    and as the module's own chains (`core/graph.py:Chain`): the same
    state, path, rounds and iterations launched, with fewer host reads at
    the default length."""
    out = {}
    for runs in ("one", "default"):
        chain_runs(monkeypatch, runs)
        if search == "lattice":
            p = HybridAStar(WALL, Pose.create(*A), Pose.create(*B), HybridAStarConfig(**BASE),
                            device="cpu")
            p._graphs.guard = no_host_reads
            p.solve(400)
            res = [getattr(p.state, f) for f in LAT_FIELDS]
        elif search == "continuous":
            _, p = _continuous("sdf")
            p.solve(400)
            res = [getattr(p.state, f) for f in HA_FIELDS]
        elif search == "rrt":
            p = RRTStar(WALL, RRT_A, RRT_B, RRTStarConfig(**RRT_KW), seed=5, device="cpu")
            p._graphs.guard = no_host_reads
            p.solve(120, 600)  # two blocks: the one-block chain reads twice
            res = [getattr(p.state, f) for f in trrt._RRT_FIELDS] + [p.generator.get_state()]
        else:
            cache = _graph.Cache()
            cache.guard = no_host_reads
            out[runs] = ([tastar.distance_field(torch.from_numpy(WALL), (5, 5), cache)],
                         None, None)
            continue
        out[runs] = (res, p, p.recover_path())
    (res0, p0, path0), (res1, p1, path1) = out["one"], out["default"]
    for a, b in zip(res0, res1):
        assert torch.equal(a, b)
    assert path0 == path1
    if search != "astar":
        assert p0.rounds == p1.rounds and p0.launched == p1.launched
        assert p1.host_reads < p0.host_reads
