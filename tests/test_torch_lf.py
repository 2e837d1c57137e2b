"""The likelihood-field measurements of slam_tpu_torch.ops.measurement
(direct model, correlative score table, window, lookup) against
slam_tpu.ops.measurement on the same numpy inputs."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import LidarConfig as JLidar
from slam_tpu.core.config import RaycastConfig as JRaycast
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.ops import edt as jedt
from slam_tpu.ops import measurement as jm
from slam_tpu.ops.rayfield import RayField as JRayField
from slam_tpu_torch.core.config import RaycastConfig
from slam_tpu_torch.ops import measurement as tm
from slam_tpu_torch.utils import convert
from torch_port import np_, one_rank_sharding, room, t_pose, t_scan

H, W, MAX_DIST, STD, CAP = 96, 128, 60.0, 3.0, 17.0
JRC = JRaycast(step=1.0, max_dist=MAX_DIST, backend="sdf")
TRC = RaycastConfig(step=1.0, max_dist=MAX_DIST, backend="sdf")
LF = dict(stddev=STD, z_hit=0.95, z_rand=0.05)
# Table entries are sums over ~20 beams of log scores of magnitude up to
# ~7: the two packages sum in other orders (measured max |diff| 1.5e-5).
TABLE_ATOL = 1e-3


def _scan(pose=(50.3, 40.7, 0.3), n_rays=24):
    lidar = JLidar(start=0.0, stop=2 * math.pi, max_dist=MAX_DIST, n_rays=n_rays)
    return jfake.scan(jnp.asarray(room(H, W)), JPose.create(*pose), lidar, JRC)


def _fields():
    blocked = room(H, W)
    jedt_ = jedt.edt_capped(jnp.asarray(blocked), CAP)
    jf = JRayField(blocked=jnp.asarray(blocked), edt=jedt_)
    tf = convert.ray_field(blocked, edt=np.asarray(jedt_))
    return jf, tf


def _cloud(rng, n=256, center=(50.0, 40.0, 0.3), spread=(1.5, 1.5, 0.04), outliers=True):
    x = rng.normal(center[0], spread[0], n).astype(np.float32)
    y = rng.normal(center[1], spread[1], n).astype(np.float32)
    th = rng.normal(center[2], spread[2], n).astype(np.float32)
    if outliers:  # headings far out of the window, cells far out of the box
        th[:2] += np.float32(3.0)
        x[8:16] = np.float32(120.0)
        y[16:20] = np.float32(-5.0)
    return JPose.create(x, y, th)


def test_lf_cell_offsets_equal(rng):
    """The (bin, beam) window offsets, against the JAX package's
    expressions (`slam_tpu/ops/measurement.py:313-319`), on random ranges
    (some at max range) and headings."""
    pad = int(math.ceil(MAX_DIST)) + 1
    dists = rng.uniform(0.5, MAX_DIST, 24).astype(np.float32)
    dists[::5] = MAX_DIST
    angles = rng.uniform(-math.pi, math.pi, 24).astype(np.float32)
    heads = rng.uniform(-math.pi, math.pi, 32).astype(np.float32)
    ang = jnp.asarray(heads)[:, None] + jnp.asarray(angles)[None, :]
    want_i = jnp.floor(0.5 - jnp.asarray(dists)[None, :] * jnp.sin(ang)).astype(jnp.int32) + pad
    want_j = jnp.floor(0.5 + jnp.asarray(dists)[None, :] * jnp.cos(ang)).astype(jnp.int32) + pad
    oi, oj = tm.lf_cell_offsets(convert.scan(angles, dists), torch.from_numpy(heads),
                                max_dist=MAX_DIST)
    np.testing.assert_array_equal(oi.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(oj.numpy(), np.asarray(want_j))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("origin", [None, (20, 30), (0, 80), (48, 0)],
                         ids=["dense", "box_inside", "box_top_right", "box_bottom_left"])
def test_lf_score_table(origin, dtype):
    jf, tf = _fields()
    scan = _scan()
    heads = np.linspace(-0.5, 0.8, 8).astype(np.float32)
    out_shape = None if origin is None else (48, 48)
    want = jm.lf_score_table(
        jf.edt, scan, jnp.asarray(heads), rc=JRC, dtype=dtype, out_shape=out_shape,
        origin=None if origin is None else tuple(jnp.int32(o) for o in origin), **LF)
    got = tm.lf_score_table(
        tf.edt, t_scan(scan), torch.from_numpy(heads), rc=TRC, dtype=dtype,
        out_shape=out_shape,
        origin=None if origin is None else tuple(torch.tensor(o) for o in origin), **LF)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=TABLE_ATOL)


@pytest.mark.parametrize("box", [None, 48, 200])
def test_lf_table_window(rng, box):
    poses = _cloud(rng)
    want = jm.lf_table_window(poses, grid_shape=(H, W), scanner_offset=(0.0, 2.0, 0.0),
                              box_size=box)
    got = tm.lf_table_window(t_pose(poses), grid_shape=(H, W),
                             scanner_offset=(0.0, 2.0, 0.0), box_size=box)
    for g, w_ in zip(got[:4], want[:4]):
        np.testing.assert_allclose(np_(g), np_(w_), rtol=1e-6, atol=1e-6)
    assert [int(v) for v in got[4:]] == [int(v) for v in want[4:]]


@pytest.mark.parametrize("box", [None, 48])
def test_lf_table_lookup(rng, box):
    """The lookup from the same (JAX-built) prep: in-window particles to
    rtol 1e-5 / atol 1e-4 (sin/cos/atan2 ulps move the lerp fraction);
    the floored set (out-of-window headings, out-of-box cells) is the
    same and reads the same floor."""
    jf, _ = _fields()
    scan = _scan()
    poses = _cloud(rng)
    prep = jm.lf_table_prepare(jf, poses, scan, rc=JRC, box_size=box, **LF)
    tprep = (convert.tensor(prep[0]),) + tuple(convert.tensor(v) for v in prep[1:])
    want = np.asarray(jm.lf_table_lookup(prep, poses, scan, rc=JRC, grid_shape=(H, W)))
    got = np_(tm.lf_table_lookup(tprep, t_pose(poses), t_scan(scan), rc=TRC,
                                 grid_shape=(H, W)))
    n_valid = int(np.sum(np.asarray(scan.dists) < MAX_DIST))
    floor = np.float32(n_valid) * np.float32(math.log(0.05 / MAX_DIST))
    floored = want == floor
    np.testing.assert_array_equal(got == floor, floored)
    assert floored[:2].all()  # out-of-window headings
    if box is not None:
        assert floored[8:20].all()  # out-of-box cells
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_particle_log_weights_likelihood_field(rng):
    """Direct model on poses spread over the room, endpoints off the map
    and max-range beams included: rtol 1e-5 (exp/log ulps over ~20 beams)."""
    jf, tf = _fields()
    scan = _scan()
    x, y, th = (rng.uniform(3, W - 3, 256).astype(np.float32),
                rng.uniform(3, H - 3, 256).astype(np.float32),
                rng.uniform(-math.pi, math.pi, 256).astype(np.float32))
    poses = JPose.create(x, y, th)
    want = jm.particle_log_weights_likelihood_field(jf, poses, scan, rc=JRC,
                                                    scanner_offset=(0.0, 2.0, 0.0), **LF)
    got = tm.particle_log_weights_likelihood_field(tf, t_pose(poses), t_scan(scan), rc=TRC,
                                                   scanner_offset=(0.0, 2.0, 0.0), **LF)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("box,dtype", [(None, "f32"), (48, "f32"), (48, "bf16")])
def test_particle_log_weights_lf_table(rng, box, dtype):
    """Window, build and lookup end to end: within the table tolerance."""
    jf, tf = _fields()
    scan = _scan()
    poses = _cloud(rng)
    kw = dict(table_bins=16, box_size=box, table_dtype=dtype, **LF)
    want = jm.particle_log_weights_lf_table(jf, poses, scan, rc=JRC, **kw)
    got = tm.particle_log_weights_lf_table(tf, t_pose(poses), t_scan(scan), rc=TRC, **kw)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5, atol=TABLE_ATOL)


def test_unported_and_invalid_arguments():
    """The sharding arguments run (tests/test_torch_parallel.py and
    tests/test_torch_mapshard.py run them over worlds of ranks): a
    one-rank `bin_sharding` / `ray_sharding` changes nothing, `lpad` takes
    the padded window of the boxed build in its place and checks its
    shape; a missing EDT is a ValueError."""
    _, tf = _fields()
    scan = t_scan(_scan())
    poses = convert.pose(np.full(4, 50.0), np.full(4, 40.0), np.zeros(4))
    heads = torch.zeros(4)
    want = tm.lf_score_table(tf.edt, scan, heads, rc=TRC, **LF)
    got = tm.lf_score_table(tf.edt, scan, heads, rc=TRC, **LF, bin_sharding=one_rank_sharding())
    np.testing.assert_array_equal(np_(got), np_(want))
    # lpad: the dense build's padded field, cut to a box's window.
    pad = int(math.ceil(TRC.max_dist)) + 1
    box = tm.lf_score_table(tf.edt, scan, heads, rc=TRC, **LF, origin=(10, 20),
                            out_shape=(16, 24))
    field = tm.lf_log_score_field(tf.edt, max_dist=TRC.max_dist, **LF)
    lpad = torch.nn.functional.pad(field, (pad,) * 4, value=math.log(LF["z_rand"] / TRC.max_dist))
    win = lpad[10:10 + 16 + 2 * pad, 20:20 + 24 + 2 * pad]
    got = tm.lf_score_table(tf.edt, scan, heads, rc=TRC, **LF, out_shape=(16, 24), lpad=win)
    np.testing.assert_array_equal(np_(got), np_(box))
    with pytest.raises(ValueError, match="lpad shape"):
        tm.lf_score_table(tf.edt, scan, heads, rc=TRC, **LF, out_shape=(16, 24),
                          lpad=torch.zeros(3, 3))
    np.testing.assert_array_equal(
        np_(tm.particle_log_weights_lf_table(tf, poses, scan, rc=TRC,
                                             ray_sharding=one_rank_sharding())),
        np_(tm.particle_log_weights_lf_table(tf, poses, scan, rc=TRC)))
    no_edt = convert.ray_field(room(H, W))
    with pytest.raises(ValueError, match="edt"):
        tm.particle_log_weights_lf_table(no_edt, poses, scan, rc=TRC)
    with pytest.raises(ValueError, match="edt"):
        tm.particle_log_weights_likelihood_field(no_edt, poses, scan, rc=TRC)
    with pytest.raises(ValueError, match="table_bins"):
        tm.lf_table_window(poses, grid_shape=(H, W), table_bins=1)


@pytest.mark.parametrize("measurement", ["likelihood_field", "likelihood_field_table"])
def test_mcl_update_lf_from_raw_mask(rng, measurement):
    """mcl.update handed a raw blocked mask builds the capped EDT itself
    (cap 5 sigma + 2) in both packages: best and mode poses to 1e-3, the
    resampled particles to 1e-3 px on >= 99.5% of them."""
    import jax

    from slam_tpu.core.config import MCLConfig as JMCLConfig
    from slam_tpu.models import mcl as jmcl
    from slam_tpu_torch.core.config import MCLConfig
    from slam_tpu_torch.models import mcl as tmcl
    from torch_port import assert_angles_close

    scan = _scan()
    poses = _cloud(rng, outliers=False)
    kw = dict(n_particles=256, meas_stddev=STD, measurement=measurement, lf_table_box=48)
    js = jmcl.init(jax.random.key(0), 256, JPose.create(50.0, 40.0, 0.3))
    js = js.replace(particles=js.particles.replace(pose=poses))
    _, k_rs, _ = jax.random.split(js.key, 3)
    j1 = jmcl.update(js, scan, jnp.asarray(room(H, W)), JMCLConfig(**kw), JRC)
    p = js.particles
    ts = convert.mcl_state(convert.particles(p.pose.x, p.pose.y, p.pose.theta, p.log_weight),
                           t_pose(js.best_pose), t_pose(js.mode_pose), 0, 0, seed=0)
    t1 = tmcl.update(ts, t_scan(scan), torch.from_numpy(room(H, W)), MCLConfig(**kw), TRC,
                     u0=convert.tensor(jax.random.uniform(k_rs, ())))
    for tp, jp in ((t1.best_pose, j1.best_pose), (t1.mode_pose, j1.mode_pose)):
        np.testing.assert_allclose([np_(tp.x), np_(tp.y)], [np_(jp.x), np_(jp.y)], atol=1e-3)
        assert_angles_close(np_(tp.theta), np_(jp.theta), atol=1e-3)
    close = (np.isclose(np_(t1.particles.pose.x), np_(j1.particles.pose.x), atol=1e-3)
             & np.isclose(np_(t1.particles.pose.y), np_(j1.particles.pose.y), atol=1e-3))
    assert close.mean() >= 0.995
