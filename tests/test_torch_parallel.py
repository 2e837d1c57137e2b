"""slam_tpu_torch.parallel's particle-sharded engines at D = 2 and 4
ranks over gloo, against the JAX package (the counterparts of
tests/test_parallel.py).

One world per rank count runs every scenario of the module
(tests/torch_parallel_worker.py, suite "parallel") on inputs made here
with numpy and JAX (the scene, the scans and JAX's motion noise and
resampler uniforms); the worlds run in subprocesses under a wall-clock
limit while this process computes the JAX side on the CPU. The JAX tests
hold JAX's sharded engines to its single-device ones, so the references
here are mostly the single-device JAX functions; the resampler is also
held to JAX's `systematic_resample_sharded` on a mesh of D devices.

Tolerances: the JAX tests' (poses rtol 1e-5, log weights 1e-4, the SLAM
grids 1e-5); the sharded resampler index-exact on equal weights; the
fleet, the auto tier and the checkpoint bit for bit against the port's
own unsharded or forced counterparts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import (
    LidarConfig, MapConfig, MCLConfig, RaycastConfig, ScanMatchConfig, SLAMConfig,
)
from slam_tpu.core.types import Odometry as JOdometry
from slam_tpu.core.types import Particles as JParticles
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.models import mcl as jmcl
from slam_tpu.models import slam as jslam
from slam_tpu.models.simulate import synthetic_room
from slam_tpu.ops import rayfield as jrf
from slam_tpu.ops import resample as jres
from slam_tpu.parallel import make_mesh as jmake_mesh
from slam_tpu.parallel.resample import systematic_resample_sharded as jrs_sharded
from slam_tpu_torch.core import config as tcfg
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import fleet as tfleet
from slam_tpu_torch.ops import rayfield as trf
from torch_port import D, assert_angles_close, draws, start_worlds

H = W = 64
N = 64
ODOM_MCL = (0.1, 2.0, 0.1)
ODOM_SLAM = (0.05, 2.0, 0.05)
ALPHAS = (1e-3, 1e-3, 1e-3, 1e-3)
KIDNAP_SEED = 6  # tests/test_torch_globalloc.py's seed for the port's kidnap loop


def _scene():
    blocked = jnp.asarray(synthetic_room(H, W))
    pose = JPose.create(W / 2.0, H / 2.0, np.pi / 2)
    scan = jfake.scan(blocked, pose, LidarConfig(n_rays=16, max_dist=100.0),
                      RaycastConfig(max_dist=100.0, chunk=32))
    return blocked, pose, scan, RaycastConfig(max_dist=100.0, chunk=32)


def _slam_cfg(backend="march", **mcl_kw):
    return SLAMConfig(
        mcl=MCLConfig(n_particles=N, **mcl_kw), map=MapConfig(height=H, width=W),
        lidar=LidarConfig(n_rays=16, max_dist=100.0),
        raycast=RaycastConfig(max_dist=100.0, chunk=32, backend=backend))


def _fleet_inputs(blocked):
    r = 8
    rc = RaycastConfig(max_dist=100.0, chunk=32)
    xs = np.linspace(20.0, 44.0, r, dtype=np.float32)
    from slam_tpu.ops.measurement import sensor_pose
    scans = [jfake.scan(blocked, sensor_pose(JPose.create(xs[q], xs[q], 0.0), (0.0, 0.0, 0.0)),
                        LidarConfig(n_rays=16, max_dist=100.0), rc) for q in range(r)]
    return {"fleet.x": xs, "fleet.y": xs, "fleet.theta": np.zeros(r, np.float32),
            "fleet.angles": np.stack([np.asarray(s.angles) for s in scans]),
            "fleet.dists": np.stack([np.asarray(s.dists) for s in scans])}


RS_CASES = 6


def _rs_weights():
    n = 512
    out = [np.asarray(jax.random.normal(jax.random.key(1), (n,))) * 6.0]
    for k in (300, 0, n - 1):
        out.append(np.full(n, -50.0, np.float32))
        out[-1][k] = 10.0
    out.append(np.zeros(n, np.float32))
    out.append(np.where(np.arange(n) >= n - 64, 0.0, -40.0).astype(np.float32))
    return [a.astype(np.float32) for a in out]


@pytest.fixture(scope="module")
def run():
    blocked, pose, scan, rc = _scene()
    inp = {"blocked": np.asarray(blocked), "scan.angles": np.asarray(scan.angles),
           "scan.dists": np.asarray(scan.dists), "kidnap.seed": np.array(KIDNAP_SEED),
           "room128": synthetic_room(128, 128), "rs.cases": np.array(RS_CASES)}
    mcl_noise, _, _ = draws(jax.random.key(0), N)
    inp["mcl.noise"] = mcl_noise
    slam_noise, slam_u0, _ = draws(jax.random.key(0), N)
    inp["slam.noise"], inp["slam.u0"] = slam_noise, slam_u0
    rs_keys = [jax.random.key(5)] + [jax.random.key(9)] * (RS_CASES - 1)
    for k, (lw, key) in enumerate(zip(_rs_weights(), rs_keys)):
        inp[f"rs.lw{k}"] = lw
        inp[f"rs.u0{k}"] = np.asarray(jax.random.uniform(key, ()))
    lut_rc = RaycastConfig(max_dist=100.0, backend="lut", lut_bins=64)
    lutscan = jfake.scan(blocked, pose, LidarConfig(n_rays=16, max_dist=100.0),
                         RaycastConfig(max_dist=100.0))
    inp["lutscan.angles"], inp["lutscan.dists"] = (np.asarray(lutscan.angles),
                                                   np.asarray(lutscan.dists))
    _, k_rs, _ = jax.random.split(jax.random.key(0), 3)
    inp["lut.u0"] = np.asarray(jax.random.uniform(k_rs, ()))
    inp.update(_fleet_inputs(blocked))
    eb_cfg = _edt_box_cfg()
    eb_blocked = jnp.asarray(synthetic_room(128, 128))
    ebscan = jfake.scan(eb_blocked, JPose.create(64.0, 64.0, np.pi / 2), eb_cfg.lidar,
                        eb_cfg.raycast)
    inp["ebscan.angles"], inp["ebscan.dists"] = (np.asarray(ebscan.angles),
                                                 np.asarray(ebscan.dists))
    key = jax.random.key(0)
    for k in range(3):
        inp[f"eb.noise{k}"], inp[f"eb.u0{k}"], key = draws(key, 64)
    wait = start_worlds("parallel", inp)

    # The JAX side, while the worlds run.
    ref = {}
    cfg = MCLConfig(n_particles=N, ess_threshold=0.0)
    st = jmcl.init(jax.random.key(0), N, pose)
    st = jmcl.predict(st, JOdometry.create(*ODOM_MCL), jnp.asarray(ALPHAS))
    ref["mcl"] = jmcl.update(st, scan, blocked, cfg, rc)
    for box in (None, 40):
        c = _slam_cfg("sdf", measurement="likelihood_field_table", lf_table_box=box,
                      ess_threshold=0.0)
        ref[f"table{box or 0}"] = jslam.step(jslam.init(jax.random.key(0), c, pose),
                                             JOdometry.create(*ODOM_SLAM), scan, c)
    ref["rs"] = []
    for k, (lw, key) in enumerate(zip(_rs_weights(), rs_keys)):
        ar = jnp.arange(512, dtype=jnp.float32)
        p = JParticles(pose=JPose(x=ar, y=ar * 2.0, theta=ar * 1e-3), log_weight=jnp.asarray(lw))
        ref["rs"].append(jres.resample(key, p, "systematic"))
        if k == 0:
            ref["rs_jax_sharded"] = {d: jrs_sharded(jmake_mesh(d), key, p) for d in (2, 4)}
    lut_field = jrf.make_ray_field(blocked, lut_rc)
    ref["lut"] = jmcl.update(jmcl.init(jax.random.key(0), N, pose), lutscan, lut_field,
                             MCLConfig(n_particles=N), lut_rc)
    ref["fleet"] = _port_fleet(inp)
    js = jslam.init(jax.random.key(0), eb_cfg, JPose.create(64.0, 64.0, np.pi / 2))
    for _ in range(3):
        js = jslam.step(js, JOdometry.create(0.05, 1.5, 0.05), ebscan, eb_cfg)
    ref["eb"] = js
    sm_cfg = SLAMConfig(mcl=MCLConfig(n_particles=N, ess_threshold=0.0),
                        map=MapConfig(height=H, width=W),
                        lidar=LidarConfig(n_rays=16, max_dist=100.0),
                        raycast=RaycastConfig(max_dist=100.0, chunk=32),
                        scanmatch=ScanMatchConfig())
    ref["sm"] = jslam.step(jslam.init(jax.random.key(0), sm_cfg, pose),
                           JOdometry.create(*ODOM_SLAM), scan, sm_cfg)
    ref["sm_cfg"] = sm_cfg
    return ref, wait()


def _edt_box_cfg():
    return SLAMConfig(
        mcl=MCLConfig(n_particles=64, meas_stddev=1.0, measurement="likelihood_field_table"),
        map=MapConfig(height=128, width=128), lidar=LidarConfig(n_rays=16, max_dist=50.0),
        raycast=RaycastConfig(step=1.0, max_dist=50.0, backend="sdf"), edt_box=72)


def _port_fleet(inp):
    """The port's unsharded fleet, two steps, on the CPU."""
    rc = tcfg.RaycastConfig(max_dist=100.0, chunk=32)
    cfg = tcfg.MCLConfig(n_particles=32, meas_stddev=3.0)
    field = trf.make_ray_field(torch.tensor(inp["blocked"]), rc)
    fl = tfleet.MCLFleet(8, cfg, rc, seed=3, device="cpu")
    st = fl.init(Pose(*(torch.tensor(inp[f"fleet.{k}"]) for k in ("x", "y", "theta"))))
    scans = Scan(angles=torch.tensor(inp["fleet.angles"]), dists=torch.tensor(inp["fleet.dists"]))
    odoms = Odometry(*(torch.full((8,), v) for v in (0.05, 1.0, 0.05)))
    for _ in range(2):
        st = fl.step(st, odoms, scans, field, (1e-3, 1e-3, 5e-3, 5e-3))
    p = st.particles.pose
    return np.stack([p.x.numpy(), p.y.numpy(), p.theta.numpy()])


def _pose3(p):
    return np.array([float(p.x), float(p.y), float(p.theta)])


@pytest.mark.parametrize("d", D)
@pytest.mark.parametrize("ba", [1, 2])
def test_sharded_mcl_matches_single_device(run, d, ba):
    ref, out = run
    o, j = out[d][0], ref["mcl"]
    np.testing.assert_allclose(o[f"mcl_b{ba}.x"], np.asarray(j.particles.pose.x), rtol=1e-5)
    np.testing.assert_allclose(o[f"mcl_b{ba}.lw"], np.asarray(j.particles.log_weight),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(o[f"mcl_b{ba}.best_pose"], _pose3(j.best_pose), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(o[f"mcl_b{ba}.mode_pose"], _pose3(j.mode_pose), rtol=1e-5,
                               atol=1e-4)
    # The particle axis is split over 'p' (D / beam_axis shards).
    assert int(o[f"mcl_b{ba}.n_local"]) == N * ba // d


@pytest.mark.parametrize("d", D)
def test_sharded_slam_step_runs_and_stays_sharded(run, d):
    _, out = run
    o = out[d][0]
    assert float(o["beam.grid_abs"]) > 0.0
    assert int(o["beam.n_local"]) == N * 2 // d


@pytest.mark.parametrize("d", D)
@pytest.mark.parametrize("box", [None, 40])
def test_sharded_slam_lf_table_matches_single_device(run, d, box):
    ref, out = run
    j, key = ref[f"table{box or 0}"], f"table{box or 0}"
    for o in out[d]:
        np.testing.assert_allclose(o[f"{key}.lw"], np.asarray(j.mcl.particles.log_weight),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(o[f"{key}.grid"], np.asarray(j.grid), rtol=1e-4, atol=1e-5)
        # Every rank applied the same map update.
        np.testing.assert_array_equal(o[f"{key}.grid"], out[d][0][f"{key}.grid"])


@pytest.mark.parametrize("d", D)
@pytest.mark.parametrize("bins", [1, 5, 8])
def test_table_bins_split_over_beam_axis(run, d, bins):
    """`lf_score_table(bin_sharding=...)` over |b| = 2 builds each rank's
    share of the heading bins, the parts padded to the largest for the
    all-gather, whether |b| divides the bin count or not: every rank gets
    the one-rank table bit for bit."""
    _, out = run
    for o in out[d]:
        assert bool(o[f"bins{bins}.same"])


@pytest.mark.parametrize("d", D)
def test_sharded_auto_tier_matches_forced_table(run, d):
    _, out = run
    o = out[d][0]
    assert bool(o["auto.converged"])
    for k in ("x", "y", "theta", "lw"):
        np.testing.assert_array_equal(o[f"auto.{k}"], o[f"forced.{k}"])


class TestShardedResample:
    @pytest.mark.parametrize("d", D)
    @pytest.mark.parametrize("ba", [1, 2])
    def test_exact_match(self, run, d, ba):
        ref, out = run
        got, want = out[d][0][f"rs_b{ba}.0"], ref["rs"][0].pose
        for row, f in enumerate(("x", "y", "theta")):
            np.testing.assert_array_equal(got[row], np.asarray(getattr(want, f)))
        # JAX's own sharded resampler on a mesh of d devices agrees.
        js = ref["rs_jax_sharded"][d].pose
        np.testing.assert_array_equal(got[0], np.asarray(js.x))
        assert int(out[d][0][f"rs_b{ba}.0.n_local"]) == 512 * ba // d

    @pytest.mark.parametrize("d", D)
    def test_degenerate_weights(self, run, d):
        ref, out = run
        for k in range(1, RS_CASES):
            got, want = out[d][0][f"rs_b1.{k}"], ref["rs"][k].pose
            for row, f in enumerate(("x", "y", "theta")):
                np.testing.assert_array_equal(got[row], np.asarray(getattr(want, f)))

    @pytest.mark.parametrize("d", D)
    def test_update_has_no_large_all_gather(self, run, d):
        """The sharded MCL update at 4096 particles moves no [N]-sized
        all-gather: its all-gathers are [D]-sized shard summaries (the
        estimate's [D, 6], the resampler's [D]); the one [N]-scale
        collective is the resampler's reduce-scatter of [D, 4, L] per
        rank."""
        _, out = run
        o = out[d][0]
        assert int(o["counts.largest_all_gather"]) <= d * 16
        assert int(o["counts.reduce_scatter"]) == 4 * 4096
        assert int(o["counts.staged_bytes"]) == 0


@pytest.mark.parametrize("d", D)
def test_sharded_mcl_with_lut_backend(run, d):
    ref, out = run
    o, j = out[d][0], ref["lut"]
    np.testing.assert_allclose(o["lut.x"], np.asarray(j.particles.pose.x), rtol=1e-5)
    np.testing.assert_allclose(o["lut.best_pose"], _pose3(j.best_pose), rtol=1e-5, atol=1e-4)
    assert int(o["lut.n_local"]) == N * 2 // d


@pytest.mark.parametrize("d", D)
def test_sharded_fleet_matches_unsharded(run, d):
    """Robots over 'p': the sharded fleet equals the port's unsharded fleet
    bit for bit and its steps call no collective."""
    ref, out = run
    o = out[d][0]
    np.testing.assert_array_equal(o["fleet.pose"], ref["fleet"])
    assert int(o["fleet.calls"]) == 0
    assert int(o["fleet.n_local"]) == 8 // d


@pytest.mark.parametrize("d", D)
def test_sharded_state_checkpoint_roundtrip(run, d):
    _, out = run
    for o in out[d]:
        assert bool(o["ckpt.same"]) and bool(o["ckpt.same_next"])
        assert int(o["ckpt.n_local"]) == N * 2 // d


@pytest.mark.parametrize("d", D)
def test_sharded_kidnap_recovery_with_capped_injection(run, d):
    """tests/test_mcl.py's kidnap loop (`torch_port.kidnap_errors`, the
    port's seed) through ShardedMCL: tracks before the kidnap, re-localizes
    after it (min error < 3 px, mean of the last 10 < 4 px)."""
    _, out = run
    errs = out[d][0]["kidnap.errs"]
    assert errs[9] < 2.0
    assert errs[10:].min() < 3.0, f"never re-localized: {errs[10:].min():.2f}"
    assert errs[-10:].mean() < 4.0, f"unstable tail: {errs[-10:]}"


@pytest.mark.parametrize("d", D)
def test_sharded_slam_with_incremental_edt_matches_single_device(run, d):
    ref, out = run
    o, j = out[d][0], ref["eb"]
    np.testing.assert_allclose(o["eb.grid"], np.asarray(j.grid), atol=1e-5)
    np.testing.assert_allclose(o["eb.edt"], np.asarray(j.edt), atol=1e-5)
    np.testing.assert_allclose(o["eb.x"], np.asarray(j.mcl.particles.pose.x), rtol=1e-4)


@pytest.mark.parametrize("d", D)
def test_sharded_slam_scanmatch_matches_single_device(run, d):
    ref, out = run
    o, j, cfg = out[d][0], ref["sm"], ref["sm_cfg"]
    tstep = 2 * cfg.scanmatch.theta_halfwidth / (cfg.scanmatch.theta_bins - 1)
    np.testing.assert_allclose(o["sm.est"][:2], _pose3(j.est_pose)[:2], atol=1.0)
    assert_angles_close(o["sm.est"][2:], _pose3(j.est_pose)[2:], tstep + 1e-5)
    assert not np.array_equal(o["sm.est"], o["sm.best_pose"])


@pytest.mark.parametrize("d", D)
@pytest.mark.parametrize("engine", ["mcl_step", "mcl_predict_update", "slam", "mapshard",
                                    "fleet"])
def test_sharded_engine_block_route_equals_eager(run, d, engine):
    """Each sharded engine's steps through its `StepGraphs` (over gloo the
    same block code eagerly; over NCCL one CUDA graph replay a step) ==
    the eager free functions bit for bit over two steps, on every rank,
    with the same collectives counted at each step."""
    _, out = run
    for o in out[d]:
        assert bool(o[f"routes.{engine}.same"])
        assert bool(o[f"routes.{engine}.counts_same"])
    if engine != "fleet":  # robots never talk
        assert int(out[d][0][f"routes.{engine}.calls"]) > 0

