"""slam_tpu_torch beam measurement against the JAX package, on a table
JAX built and `utils.convert` carried across."""

import functools
import math

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import LidarConfig as JLidar
from slam_tpu.core.config import RaycastConfig as JRaycast
from slam_tpu.core.config import beam_bin_stride
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.ops import measurement as jmeas
from slam_tpu.ops import rayfield as jrf
from slam_tpu_torch.core.config import RaycastConfig
from slam_tpu_torch.core.types import Scan
from slam_tpu_torch.ops import lut as tlut
from slam_tpu_torch.ops import lut_weights_cuda
from slam_tpu_torch.ops import measurement as tmeas
from slam_tpu_torch.utils import convert
from torch_port import np_, random_poses, room, t_field, t_scan

H, W, MAX_DIST = 96, 128, 80.0
OFFSET = (0.0, 10.0, 0.0)
N = 2048


@functools.cache
def _setup(n_rays, lut_dtype):
    """A JAX-built field, a scan from inside the room and N poses around it."""
    blocked = room(H, W)
    lidar = JLidar(start=0.0, stop=math.pi, max_dist=MAX_DIST, n_rays=n_rays)
    jrc = JRaycast(step=0.5, max_dist=MAX_DIST, backend="lut", lut_dtype=lut_dtype)
    stride = beam_bin_stride(lidar, jrc)
    jfield = jrf.make_ray_field(jnp.asarray(blocked), jrc)
    scan = jfake.scan(jnp.asarray(blocked), JPose.create(50.0, 30.0, 0.4), lidar,
                      JRaycast(max_dist=MAX_DIST))
    rng = np.random.default_rng(n_rays)
    x, y, th = random_poses(rng, N, blocked, margin=-4.0)  # a few off the map
    return blocked, jfield, scan, stride, (x, y, th)


CASES = [(90, "bf16"), (60, "bf16"), (90, "u8")]  # strides 2, 3, 2


@pytest.mark.parametrize("n_rays,lut_dtype", CASES)
def test_fused_weights_match_jax(n_rays, lut_dtype):
    """The fused panorama route: rtol 1e-5, atol 1e-3 (exp/log ulps and
    the beam sum's order)."""
    _, jfield, scan, stride, (x, y, th) = _setup(n_rays, lut_dtype)
    assert stride == {90: 2, 60: 3}[n_rays]
    rc = RaycastConfig(step=0.5, max_dist=MAX_DIST, backend="lut", lut_dtype=lut_dtype)
    want = jmeas.particle_log_weights_lut_fused(
        jfield, JPose.create(x, y, th), scan, rc=JRaycast(**rc.__dict__),
        beam_stride=stride, scanner_offset=OFFSET, stddev=5.0, eps=0.1)
    got = tmeas.particle_log_weights_lut_fused(
        t_field(jfield), convert.pose(x, y, th), t_scan(scan), rc=rc,
        beam_stride=stride, scanner_offset=OFFSET, stddev=5.0, eps=0.1)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-5, atol=1e-3)
    assert np.ptp(np_(want)) > 10.0  # the poses score differently


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
@pytest.mark.parametrize("n_rays,lut_dtype", CASES)
def test_particle_log_weights_dispatch_matches_jax(n_rays, lut_dtype, fused):
    """`particle_log_weights` through the fused route (a stride given) and
    the general per-ray `raycast_field` route (no stride):
    rtol 1e-5, atol 1e-3."""
    _, jfield, scan, stride, (x, y, th) = _setup(n_rays, lut_dtype)
    jrc = JRaycast(step=0.5, max_dist=MAX_DIST, backend="lut", lut_dtype=lut_dtype)
    rc = RaycastConfig(step=0.5, max_dist=MAX_DIST, backend="lut", lut_dtype=lut_dtype)
    g = stride if fused else None
    want = jmeas.particle_log_weights(
        jfield, JPose.create(x, y, th), scan, rc=jrc, scanner_offset=OFFSET,
        stddev=5.0, eps=0.1, lut_beam_stride=g)
    got = tmeas.particle_log_weights(
        t_field(jfield), convert.pose(x, y, th), t_scan(scan), rc=rc,
        scanner_offset=OFFSET, stddev=5.0, eps=0.1, lut_beam_stride=g)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-5, atol=1e-3)


def test_march_route_matches_jax():
    """The general route on the march backend (a raw blocked mask):
    rtol 1e-5, atol 1e-3, with one beam per sensor allowed to land a step
    apart if a cos/sin ulp moves a march sample across a cell boundary."""
    blocked, _, scan, _, (x, y, th) = _setup(90, "bf16")
    x, y, th = x[:512], y[:512], th[:512]
    jrc = JRaycast(step=0.5, max_dist=MAX_DIST, chunk=32)
    rc = RaycastConfig(step=0.5, max_dist=MAX_DIST, chunk=32)
    want = np_(jmeas.particle_log_weights(
        jnp.asarray(blocked), JPose.create(x, y, th), scan, rc=jrc, scanner_offset=OFFSET))
    got = np_(tmeas.particle_log_weights(
        torch.from_numpy(blocked), convert.pose(x, y, th), t_scan(scan), rc=rc,
        scanner_offset=OFFSET))
    close = np.isclose(got, want, rtol=1e-5, atol=1e-3)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} sensors differ"


def test_sensor_pose_and_beam_weights_match(rng):
    x, y, th = random_poses(rng, 1000, room(H, W))
    jsp = jmeas.sensor_pose(JPose.create(x, y, th), (3.0, 30.0, 0.2))
    tsp = tmeas.sensor_pose(convert.pose(x, y, th), (3.0, 30.0, 0.2))
    for a, b in ((tsp.x, jsp.x), (tsp.y, jsp.y), (tsp.theta, jsp.theta)):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-6, atol=1e-4)
    assert tmeas.scanner_displacement((3.0, 30.0, 0.2)) == jmeas.scanner_displacement(
        (3.0, 30.0, 0.2))
    pred = rng.uniform(0, 100, (50, 90)).astype(np.float32)
    meas = rng.uniform(0, 100, (1, 90)).astype(np.float32)
    hit = rng.uniform(size=(50, 90)) < 0.7
    want = jmeas.beam_log_weights(pred, hit, meas, stddev=5.0, max_dist=100.0, eps=0.1)
    got = tmeas.beam_log_weights(torch.from_numpy(pred), torch.from_numpy(hit),
                                 torch.from_numpy(meas), stddev=5.0, max_dist=100.0, eps=0.1)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-6, atol=1e-6)


def test_fused_rejects_bad_stride():
    """7 does not divide 360 bins; at stride 5 the 90 beams outnumber the
    72 comb positions."""
    _, jfield, scan, _, (x, y, th) = _setup(90, "bf16")
    rc = RaycastConfig(max_dist=MAX_DIST, backend="lut")
    for g in (7, 5):
        with pytest.raises(ValueError):
            tmeas.particle_log_weights_lut_fused(
                t_field(jfield), convert.pose(x, y, th), t_scan(scan), rc=rc, beam_stride=g)


def test_lut_weights_kernel_wrapper_on_the_cpu():
    """A CPU table takes the plain composition and counts no launch; the
    kernel's launcher takes only a table on a CUDA device; its u8 step is
    the one `lut.dequantize` applies (every code decodes equal)."""
    _, jfield, scan, stride, (x, y, th) = _setup(90, "u8")
    field, poses = t_field(jfield), convert.pose(x, y, th)
    rc = RaycastConfig(step=0.5, max_dist=MAX_DIST, backend="lut", lut_dtype="u8")
    before = lut_weights_cuda.launch.launches
    lw = tmeas.particle_log_weights_lut_fused(field, poses, t_scan(scan), rc=rc,
                                              beam_stride=stride, scanner_offset=OFFSET)
    assert lut_weights_cuda.launch.launches == before and lw.shape == (N,)
    with pytest.raises(ValueError, match="CUDA"):
        lut_weights_cuda.launch(field.lut, 360, poses, t_scan(scan), beam_stride=stride,
                                displacement=tmeas.scanner_displacement(OFFSET),
                                max_dist=MAX_DIST, stddev=5.0, eps=0.1)
    params = lut_weights_cuda.weigh_params(
        torch.uint8, n_bins=360, displacement=tmeas.scanner_displacement(OFFSET),
        max_dist=MAX_DIST, stddev=5.0, eps=0.1)
    codes = torch.arange(256).to(torch.uint8)
    np.testing.assert_array_equal(((codes.float() + 0.5) * float(params[-1])).numpy(),
                                  tlut.dequantize(codes, torch.uint8, MAX_DIST).numpy())


@pytest.mark.parametrize("n_beams,refused", [(90, False), (385, False), (720, False),
                                             (12288, False), (12289, True)])
def test_lut_weights_kernel_beam_limit(n_beams, refused):
    """The kernel takes up to MAX_BEAMS = 12288 beams (beyond 384 in chunks
    of 384): a longer scan raises ValueError on any table, before the
    device check, and counts no launch; a scan within it reaches the
    device check (a CPU table raises there)."""
    n_bins = 2 * 12289
    table = torch.zeros((1, 1, n_bins), dtype=torch.bfloat16)
    scan = Scan(angles=torch.zeros(n_beams), dists=torch.ones(n_beams))
    poses = convert.pose(*(np.ones(4, np.float32) for _ in range(3)))
    before = lut_weights_cuda.launch.launches
    with pytest.raises(ValueError, match="exceed" if refused else "CUDA"):
        lut_weights_cuda.launch(table, n_bins, poses, scan, beam_stride=2,
                                displacement=tmeas.scanner_displacement(OFFSET),
                                max_dist=MAX_DIST, stddev=5.0, eps=0.1)
    assert lut_weights_cuda.launch.launches == before


def test_adversarial_poses_land_where_named():
    """`chip_smoke.adversarial_poses` (the kernel's adversarial
    clouds on the card): through the plain sensor pose and panorama index,
    each kind's sensors land where it says, every first bin 0.2 bins or
    more off a rounding tie."""
    h, w, n_bins, n, span = 37, 53, 360, 2003, 179
    disp = tmeas.scanner_displacement(OFFSET)
    angle0 = 0.25
    (x, y, th), kind = chip_smoke.adversarial_poses(h, w, n_bins, n, span, disp, angle0,
                                                    np.random.default_rng(3))
    sp = tmeas.sensor_pose(convert.pose(x, y, th), OFFSET)
    idx, inb = tlut.panorama_index((h, w), sp.x, sp.y)
    idx, inb = idx.numpy(), inb.numpy()
    q = ((sp.theta.double().numpy() + angle0) / (2 * math.pi / n_bins))
    s = np.round(q).astype(np.int64) % n_bins
    assert (np.abs(q - np.round(q)) <= 0.31).all()
    kinds = chip_smoke.ADVERSARIAL_KINDS
    for name in kinds:
        assert (kind == kinds.index(name)).sum() >= n // len(kinds)
    last, off = kind == kinds.index("last_cell"), kind == kinds.index("off_bottom_right")
    assert (idx[last] == h * w - 1).all() and inb[last].all()
    assert (idx[off] == h * w - 1).all() and not inb[off].any()
    wrapped = kind == kinds.index("wrapped")
    assert (s[wrapped] + span > n_bins).all() and (s[wrapped] == n_bins - 1).any()
    odd = kind == kinds.index("odd_row")
    assert (idx[odd] % 2 == 1).all() and inb[odd].all()
