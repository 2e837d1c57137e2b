"""The filter steps' graphs (`slam_tpu_torch/models/_graph.py`): on the card
each entry point's step is one CUDA graph replay; here, on the CPU, the
same block code runs eagerly through the same entry points.

  * Each graphed entry point equals the free function bit for bit over 6+
    steps: states, estimates, EMAs, grid and the generators' states; the
    odometry and the scan change at every step, so a value frozen into a
    block would show.
  * Every block runs under `no_host_reads` (a host read would be a sync
    on the card, which a capture cannot hold).
  * A state that a step returned is unchanged after the next step.
  * The auto measurement tier branches under `cond` with no host read,
    to the forced tier's weights, and they match JAX's `lax.cond` route.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core import config as jc
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.models import mcl as jmcl
from slam_tpu_torch.core import config as tc
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import _graph
from slam_tpu_torch.models import fake_lidar as tfake
from slam_tpu_torch.models import fleet as tfleet
from slam_tpu_torch.models import mcl as tmcl
from slam_tpu_torch.models import slam as tslam
from slam_tpu_torch.ops import measurement as tmeas
from slam_tpu_torch.ops import rayfield as trf
from slam_tpu_torch.tools.maze_bench import procedural_maze
from slam_tpu_torch.utils import convert
from test_torch_globalloc import _clouds, _sdf_fields
from torch_port import HostSync, no_host_reads, np_, room, t_scan

H, W = 96, 128
STEPS = 6
ALPHAS = (5e-4, 5e-4, 1e-2, 1e-2)
LIDAR = tc.LidarConfig(start=0.0, stop=math.pi, max_dist=80.0, n_rays=90)
SCAN_RC = tc.RaycastConfig(step=0.5, max_dist=80.0)


def _odom(k: int, r=None) -> Odometry:
    """Step k's odometry (a new value every step); [r] fields for a fleet."""
    base = (0.02 + 0.01 * math.sin(k), 1.5 + 0.1 * k, 0.01 * math.cos(k))
    if r is None:
        return Odometry.create(*base)
    return Odometry.create(*(np.float32(v) + np.float32(0.01) * np.arange(r, dtype=np.float32)
                             for v in base))


def _truth(k: int, q: int = 0):
    return (40.0 + 1.5 * k + 3.0 * q, 30.0 + 0.5 * k, 0.4 + 0.02 * k)


def _scan(blocked, k: int, offset=(0.0, 10.0, 0.0), lidar=LIDAR) -> Scan:
    sensor = tmcl.MCL.sensor_position(Pose.create(*_truth(k)), offset)
    return tfake.scan(blocked, sensor, lidar, SCAN_RC)


def _leaves(state) -> dict:
    leaves, host = {}, {}
    _graph._flatten(state, "", leaves, host)
    return leaves


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().numpy().tobytes()


def _snapshot(state) -> dict:
    return {k: _bits(v) for k, v in _leaves(state).items()}


def _gen_states(state):
    return [g.get_state() for g in _graph.generators(_graph.host_fields(state))]


def _assert_same(got, want, what: str) -> None:
    """Every tensor bit for bit, the counters and the generators' states."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), what
    for k in g:
        assert g[k].shape == w[k].shape and _bits(g[k]) == _bits(w[k]), f"{what}: {k}"
    hg, hw = _graph.host_fields(got), _graph.host_fields(want)
    for k, v in hw.items():
        if _graph._is_count(v):
            assert hg[k] == v, f"{what}: {k}"
    for a, b in zip(_gen_states(got), _gen_states(want)):
        assert torch.equal(a, b), f"{what}: generator state"


def _drive(engine, graphed, eager, state_g, state_e, steps=STEPS):
    """Run `graphed(state, k)` and `eager(state, k)` from equal states for
    `steps` steps under the host-read guard; after each step the states
    are equal, and the state the step before returned is unchanged."""
    engine.graphs.guard = no_host_reads
    prev = None
    for k in range(steps):
        state_g = graphed(state_g, k)
        state_e = eager(state_e, k)
        _assert_same(state_g, state_e, f"step {k}")
        if prev is not None:
            assert _snapshot(prev[0]) == prev[1], f"step {k} overwrote the state of step {k - 1}"
        prev = (state_g, _snapshot(state_g))
    assert engine.graphs.cache.blocks
    return state_g


def _lut_setup(n, **over):
    blocked = torch.from_numpy(room(H, W))
    rc = tc.RaycastConfig(step=0.5, max_dist=80.0, backend="lut")
    kw = dict(n_particles=n, meas_stddev=5.0, scanner_offset=(0.0, 10.0, 0.0),
              lut_beam_stride=tc.beam_bin_stride(LIDAR, rc))
    kw.update(over)
    return blocked, rc, tc.MCLConfig(**kw), trf.make_ray_field(blocked, rc)


@pytest.mark.parametrize("resample_every", [1, 2])
@pytest.mark.parametrize("call", ["predict_update", "step"])
def test_mcl_entry_points_equal_free_functions(call, resample_every):
    """`MCL.predict` / `update` and `MCL.step` on the bench configuration
    (the LUT route, 90 beams) at 512 particles."""
    blocked, rc, cfg, field = _lut_setup(512, resample_every=resample_every)
    eng = tmcl.MCL(cfg, rc, seed=3, device="cpu")

    def graphed(st, k):
        if call == "step":
            return eng.step(st, _odom(k), ALPHAS, _scan(blocked, k), field)
        return eng.update(eng.predict(st, _odom(k), ALPHAS), _scan(blocked, k), field)

    def eager(st, k):
        if call == "step":
            return tmcl.step(st, _odom(k), ALPHAS, _scan(blocked, k), field, cfg, rc)
        return tmcl.update(tmcl.predict(st, _odom(k), ALPHAS), _scan(blocked, k), field, cfg, rc)

    _drive(eng, graphed, eager, eng.init(H, W), eng.init(H, W))
    blocks = {k[0][0] for k in eng.graphs.cache.blocks}
    assert blocks == ({"step"} if call == "step" else {"predict", "update"})
    # The state crosses from one block to the next without a reload.
    assert eng.graphs.skipped > 0


def test_global_localization_with_injection():
    """`MCL.step` from `init_uniform` with adaptive injection: the EMAs and
    the injected particles draw from the state's generator."""
    blocked, rc, cfg, field = _lut_setup(1000, adaptive=tc.AdaptiveConfig(max_ratio=0.2))
    eng = tmcl.MCL(cfg, rc, device="cpu")

    def start():
        return tmcl.init_uniform(tmcl.make_generator(5), cfg.n_particles, blocked)

    st = _drive(eng, lambda s, k: eng.step(s, _odom(k), ALPHAS, _scan(blocked, k), field),
                lambda s, k: tmcl.step(s, _odom(k), ALPHAS, _scan(blocked, k), field, cfg, rc),
                start(), start())
    assert bool(torch.isfinite(st.log_w_slow)) and bool(torch.isfinite(st.log_w_fast))


def test_cddt_maze_step():
    """`MCL.step` through the compressed ray table on a 240 px maze (the
    beam model per particle and beam: K1, then the CDDT queries)."""
    blocked = torch.from_numpy(procedural_maze(240, 40))
    rc = tc.RaycastConfig(step=0.5, max_dist=120.0, backend="cddt", lut_bins=120)
    cfg = tc.MCLConfig(n_particles=300, meas_stddev=5.0)
    field = trf.make_ray_field(blocked, rc)
    lidar = tc.LidarConfig(start=0.0, stop=math.pi, max_dist=120.0, n_rays=30)
    eng = tmcl.MCL(cfg, rc, device="cpu")

    def scan(k):
        sensor = Pose.create(118.0 + k, 121.0, 0.9 + 0.05 * k)
        return tfake.scan(blocked, sensor, lidar, tc.RaycastConfig(step=0.5, max_dist=120.0))

    start = Pose.create(118.0, 121.0, 0.9)
    _drive(eng, lambda s, k: eng.step(s, _odom(k), ALPHAS, scan(k), field),
           lambda s, k: tmcl.step(s, _odom(k), ALPHAS, scan(k), field, cfg, rc),
           tmcl.init(1, 300, start), tmcl.init(1, 300, start))


def _slam_cfg(**over):
    mcl = dict(n_particles=256, meas_stddev=3.0, measurement="likelihood_field_table",
               lf_table_box=48, resample_every=4)
    mcl.update(over.pop("mcl", {}))
    return tc.SLAMConfig(
        mcl=tc.MCLConfig(**mcl), map=tc.MapConfig(height=H, width=W),
        lidar=tc.LidarConfig(max_dist=60.0, n_rays=24, stddev=3.0),
        motion=tc.MotionConfig(alphas=(0.002,) * 4),
        raycast=tc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf"), **over)


@pytest.mark.parametrize("case", ["table_resample4_map2", "scanmatch", "edt_box"])
def test_grid_slam_equals_free_functions(case):
    """`GridSLAM.step` (a block per phase of the resample and map gates)
    and `GridSLAM.predict` against `slam.step` / `slam.predict_only`; with
    `edt_box` the refresh's branch is a `cond` inside the block."""
    over = {"table_resample4_map2": dict(map_every=2, map_pose="mode"),
            "scanmatch": dict(scanmatch=tc.ScanMatchConfig(), mcl={"resample_every": 1}),
            "edt_box": dict(map_every=2, edt_box=80)}[case]
    cfg = _slam_cfg(**over)
    blocked = torch.from_numpy(room(H, W))
    eng = tslam.GridSLAM(cfg, seed=2, device="cpu")

    def scan(k):
        return _scan(blocked, k, cfg.mcl.scanner_offset, cfg.lidar)

    def graphed(st, k):
        if k == 3:
            st = eng.predict(st, _odom(10 + k))
        return eng.step(st, _odom(k), scan(k))

    def eager(st, k):
        if k == 3:
            st = tslam.predict_only(st, _odom(10 + k), cfg)
        return tslam.step(st, _odom(k), scan(k), cfg)

    start = Pose.create(*_truth(0))
    st = _drive(eng, graphed, eager, eng.init(start), eng.init(start), steps=8)
    assert bool((st.grid != 0).any())
    phases = {k[3] for k in eng.graphs.cache.blocks if k[0][0] == "step"}
    assert phases == ({(0, 0), (1, 1), (2, 0), (3, 1)} if case != "scanmatch" else {(0, 0)})
    if case == "edt_box":
        np.testing.assert_array_equal(
            np_(st.edt), np_(tslam.rebuild_edt(st, cfg).edt))


def test_fleet_equals_free_function():
    """`MCLFleet.step` at R = 4: the four generators registered, robot q's
    odometry and scan its own."""
    blocked, rc, cfg, field = _lut_setup(256, resample_every=2)
    r = 4
    fl = tfleet.MCLFleet(r, cfg, rc, seed=9, device="cpu")
    poses = Pose.create(*(torch.tensor([_truth(0, q)[i] for q in range(r)]) for i in range(3)))

    def scans(k):
        ss = [tfake.scan(blocked, tmcl.MCL.sensor_position(Pose.create(*_truth(k, q)),
                                                           cfg.scanner_offset), LIDAR, SCAN_RC)
              for q in range(r)]
        return Scan(angles=torch.stack([s.angles for s in ss]),
                    dists=torch.stack([s.dists for s in ss]))

    _drive(fl, lambda s, k: fl.step(s, _odom(k, r), scans(k), field, ALPHAS),
           lambda s, k: tfleet.fleet_step(s, _odom(k, r), scans(k), field, ALPHAS, cfg, rc),
           fl.init(poses), fl.init(poses))
    assert len(_graph.generators(_graph.host_fields(fl.init(poses)))) == r


@pytest.mark.parametrize("cloud", ["converged", "dispersed"])
def test_auto_update_computes_one_tier_like_lax_cond(cloud, monkeypatch):
    """`MCL.update` with likelihood_field_auto branches on its predicate
    under `core/graph.py:cond` (JAX's `lax.cond`) with no host read: on the
    CPU the cond runs both tiers' measurements and selects, and the weights
    equal the tier the predicate picks, forced, bit for bit, and JAX's
    `lax.cond` route within test_torch_mcl.py's rtol 1e-5 / atol 1e-3 (no
    resample: ess_threshold 0). The free function too, under the guard."""
    jfield, tfield = _sdf_fields()
    rc_j = jc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    rc_t = tc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    scan = jfake.scan(jfield.blocked, JPose.create(40.0, 40.0, 0.3),
                      jc.LidarConfig(max_dist=60.0, n_rays=24), rc_j)
    base = dict(n_particles=64, meas_stddev=3.0, lf_table_box=32, ess_threshold=0.0)
    want = "likelihood_field_table" if cloud == "converged" else "likelihood_field"
    calls = []
    for name in ("particle_log_weights_lf_table", "particle_log_weights_likelihood_field"):
        fn = getattr(tmeas, name)
        monkeypatch.setattr(tmeas, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    x, y, th = _clouds()[cloud]

    def start():
        st = tmcl.init(0, 64, convert.pose(40.0, 40.0, 0.3))
        return st.replace(particles=st.particles.replace(pose=convert.pose(x, y, th)))

    auto_cfg = tc.MCLConfig(measurement="likelihood_field_auto", **base)
    eng = tmcl.MCL(auto_cfg, rc_t, device="cpu")
    eng.graphs.guard = no_host_reads
    got = eng.update(start(), t_scan(scan), tfield)
    both = ["particle_log_weights_lf_table", "particle_log_weights_likelihood_field"]
    assert calls == both
    assert bool(tmcl.auto_converged(start().particles.pose, tfield, auto_cfg)) == (
        cloud == "converged")
    forced = tmcl.update(start(), t_scan(scan), tfield, tc.MCLConfig(measurement=want, **base),
                         rc_t)
    _assert_same(got, forced, "auto vs forced tier")
    calls.clear()
    with no_host_reads():
        free = tmcl.update(start(), t_scan(scan), tfield, auto_cfg, rc_t)
    assert calls == both
    _assert_same(free, forced, "free auto vs forced tier")

    st = jmcl.init(jax.random.key(0), 64, JPose.create(40.0, 40.0, 0.3))
    st = st.replace(particles=st.particles.replace(pose=JPose(*(jnp.asarray(v) for v in (x, y, th)))))
    jauto = jmcl.update(st, scan, jfield, jc.MCLConfig(measurement="likelihood_field_auto", **base),
                        rc_j)
    np.testing.assert_allclose(np_(got.particles.log_weight),
                               np.asarray(jauto.particles.log_weight), rtol=1e-5, atol=1e-3)


def test_loads_stage_and_skip():
    """A load skips a buffer that already holds its value (the state a step
    returned, unmodified) and reloads one modified in place; a new
    odometry is loaded at every step."""
    blocked, rc, cfg, field = _lut_setup(128)
    eng = tmcl.MCL(cfg, rc, device="cpu")
    st = eng.init(H, W)
    st = eng.predict(st, _odom(0), ALPHAS)
    loads = eng.graphs.loads
    st2 = eng.predict(st, _odom(1), ALPHAS)
    assert eng.graphs.loads == loads + 1  # the odometry only
    st2.particles.pose.x.add_(0.0)  # an in-place edit bumps the version
    loads = eng.graphs.loads
    eng.predict(st2, _odom(2), ALPHAS)
    assert eng.graphs.loads > loads + 1
    assert eng.graphs.copies == 3 and eng.graphs.copy_bytes > 0


def test_update_that_reads_host_stays_eager():
    """The beam measurement cast by the march: the free `mcl.update` stays
    eager and reads a flag on the host (it stops early); `MCL.update` and
    `MCL.step` run their blocks with the march's whole count and no host
    read, to the free functions' states bit for bit."""
    blocked = torch.from_numpy(room(H, W))
    rc = tc.RaycastConfig(step=1.0, max_dist=60.0, backend="march", chunk=8)
    cfg = tc.MCLConfig(n_particles=64, meas_stddev=3.0, resample_every=2)
    lidar = tc.LidarConfig(max_dist=60.0, n_rays=24)
    eng = tmcl.MCL(cfg, rc, device="cpu")
    scan = _scan(blocked, 0, cfg.scanner_offset, lidar)
    with pytest.raises(HostSync), no_host_reads():
        tmcl.update(eng.init(H, W), scan, blocked, cfg, rc)

    def graphed(st, k):
        if k % 2:
            return eng.step(st, _odom(k), ALPHAS, _scan(blocked, k, cfg.scanner_offset, lidar),
                            blocked)
        return eng.update(eng.predict(st, _odom(k), ALPHAS),
                          _scan(blocked, k, cfg.scanner_offset, lidar), blocked)

    def eager(st, k):
        z = _scan(blocked, k, cfg.scanner_offset, lidar)
        if k % 2:
            return tmcl.step(st, _odom(k), ALPHAS, z, blocked, cfg, rc)
        return tmcl.update(tmcl.predict(st, _odom(k), ALPHAS), z, blocked, cfg, rc)

    _drive(eng, graphed, eager, eng.init(H, W), eng.init(H, W))
    assert {k[0][0] for k in eng.graphs.cache.blocks} == {"predict", "update", "step"}


def test_grid_slam_sdf_beam_equals_free_function():
    """`GridSLAM.step` on `apps/grid_slam.py`'s default measurement (the beam
    model, rays sphere-traced over the rebuilt EDT): the block traces the
    whole count with no host read, the free `slam.step` stops early, and
    the states agree bit for bit."""
    cfg = _slam_cfg(mcl={"measurement": "beam", "meas_stddev": 5.0, "lf_table_box": None,
                         "resample_every": 1})
    blocked = torch.from_numpy(room(H, W))
    eng = tslam.GridSLAM(cfg, seed=4, device="cpu")

    def scan(k):
        return _scan(blocked, k, cfg.mcl.scanner_offset, cfg.lidar)

    start = Pose.create(*_truth(0))
    st = _drive(eng, lambda s, k: eng.step(s, _odom(k), scan(k)),
                lambda s, k: tslam.step(s, _odom(k), scan(k), cfg), eng.init(start),
                eng.init(start))
    assert bool((st.grid != 0).any())
