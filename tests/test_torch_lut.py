"""slam_tpu_torch LUT build and queries, the march raycaster and the
simulated lidar against the JAX package on small maps."""

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import LidarConfig as JLidar
from slam_tpu.core.config import MCLConfig as JMCLConfig
from slam_tpu.core.config import RaycastConfig as JRaycast
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.ops import lut as jlut
from slam_tpu.ops import measurement as jmeas
from slam_tpu.ops import rayfield as jrf
from slam_tpu.ops.raycast import raycast_march as jmarch
from slam_tpu_torch.core.config import LidarConfig, MCLConfig, RaycastConfig, beam_bin_stride
from slam_tpu_torch.core.types import Odometry
from slam_tpu_torch.models import fake_lidar as tfake
from slam_tpu_torch.models import mcl as tmcl
from slam_tpu_torch.ops import lut as tlut
from slam_tpu_torch.ops import measurement as tmeas
from slam_tpu_torch.ops import rayfield as trf
from slam_tpu_torch.ops.raycast import raycast_march as tmarch
from slam_tpu_torch.utils import convert
from torch_port import np_, random_poses, room, t_field, t_scan, table_bits, torch_table_bits

H, W, BINS, MAX_DIST = 96, 128, 360, 80.0
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "u8": (jnp.uint8, torch.uint8)}


@pytest.fixture(scope="module")
def blocked():
    return room(H, W)


@pytest.mark.parametrize("per_bin", [False, True], ids=["quad", "per_bin"])
@pytest.mark.parametrize("dtype", ["bf16", "u8"])
def test_build_beam_lut_matches_jax(blocked, dtype, per_bin):
    """Byte-equality is the aim. One thing keeps it from being total: f32
    sin/cos differ by an ulp between XLA:CPU and torch on ~5% of inputs,
    and where the rotated sample lands exactly on a cell boundary a floor
    flips. Measured on this map: 107 of 4.4M bf16 entries (quad), 89
    (per-bin), 0.002%, and the same counts in the u8 table. Held to
    <= 0.01%.

    The u8 encode floor(run / q) follows XLA: q = cap * f32(1 / 255), then
    a true divide. Every entry whose quotient lies within 1e-4 of an
    integer (7.9% of this table, almost all at the cap) is held to no
    one-code difference; the IEEE q = cap / 255 gave one code more on all
    of them. (A trig flip can still land on a tie: 7 such entries here,
    2-5 codes off, counted in the budget.)
    """
    jdt, tdt = DTYPES[dtype]
    want = table_bits(jlut.build_beam_lut(
        jnp.asarray(blocked), n_bins=BINS, max_dist=MAX_DIST, dtype=jdt,
        _force_per_bin=per_bin))
    t_lut = tlut.build_beam_lut(torch.from_numpy(blocked), n_bins=BINS, max_dist=MAX_DIST,
                                dtype=tdt, _force_per_bin=per_bin)
    assert t_lut.shape == (H, W, BINS) and t_lut.dtype == tdt
    got = torch_table_bits(t_lut)
    diff = got != want
    if dtype == "u8":
        runs = np_(tlut.build_beam_lut(torch.from_numpy(blocked), n_bins=BINS,
                                       max_dist=MAX_DIST, _force_per_bin=per_bin))
        cap = np.float32(MAX_DIST * 1.25)
        quot = np.minimum(runs, cap).astype(np.float64) / np.float64(cap / np.float32(255))
        tie = np.abs(quot - np.round(quot)) < 1e-4
        assert tie.mean() > 0.05
        one_code = np.abs(got.astype(int) - want.astype(int)) == 1
        assert not (tie & one_code).any(), f"{(tie & one_code).sum()} ties one code off"
    share = diff.mean()
    assert share <= 1e-4, f"{share:.4%} of entries differ ({diff.sum()} of {diff.size})"


def _shared_table(blocked, dtype):
    """A table JAX built, carried to torch through utils.convert."""
    jdt, _ = DTYPES[dtype]
    j = jlut.build_beam_lut(jnp.asarray(blocked), n_bins=BINS, max_dist=MAX_DIST, dtype=jdt)
    return j, convert.lut_tensor(table_bits(j))


@pytest.mark.parametrize("dtype", ["bf16", "u8"])
def test_raycast_lut_and_panorama_exact(blocked, dtype, rng):
    """On one shared table, queries are exact: same cells, bins and
    decoded distances, including positions off the map."""
    jtab, ttab = _shared_table(blocked, dtype)
    x, y, th = random_poses(rng, 3000, blocked, margin=-10.0)  # some off-map
    jd, jh = jlut.raycast_lut(jtab, x, y, th, max_dist=MAX_DIST)
    td, th_ = tlut.raycast_lut(ttab, torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(th), max_dist=MAX_DIST)
    np.testing.assert_array_equal(np_(td), np_(jd))
    np.testing.assert_array_equal(np_(th_), np_(jh))
    assert (~np_(jh)).any() and np_(jh).any()
    jp, jinb = jlut.panorama_rows(jtab, x, y)
    tp, tinb = tlut.panorama_rows(ttab, torch.from_numpy(x), torch.from_numpy(y))
    assert tp.dtype == ttab.dtype
    np.testing.assert_array_equal(np_(tp), np_(jp))
    np.testing.assert_array_equal(np_(tinb), np_(jinb))
    q = tlut.lut_quant_step(ttab.dtype, MAX_DIST)
    assert q == jlut.lut_quant_step(jtab.dtype, MAX_DIST)
    np.testing.assert_array_equal(
        np_(tlut.dequantize(tp, ttab.dtype, MAX_DIST)),
        np_(jlut.dequantize(jp, jtab.dtype, MAX_DIST)))


def test_raycast_march_matches_jax(blocked, rng):
    """Same hits and distances. A cos/sin ulp could move one march sample
    across a cell boundary; measured: none of 4096 rays differ. Held to
    >= 99.5% identical."""
    x, y, th = random_poses(rng, 4096, blocked)
    jd, jh = jmarch(jnp.asarray(blocked), x, y, th, step=0.5, max_dist=MAX_DIST, chunk=16)
    td, th_ = tmarch(torch.from_numpy(blocked), torch.from_numpy(x), torch.from_numpy(y),
                     torch.from_numpy(th), step=0.5, max_dist=MAX_DIST, chunk=16)
    same = (np_(td) == np_(jd)) & (np_(th_) == np_(jh))
    assert same.mean() >= 0.995, f"{1 - same.mean():.4%} of rays differ"
    assert np_(jh).mean() > 0.5


def test_fake_lidar_scan_matches_jax(blocked):
    lidar = dict(start=0.0, stop=math.pi, max_dist=MAX_DIST, n_rays=90)
    for pose in ((40.0, 30.0, 0.3), (100.0, 70.0, -2.5), (64.5, 48.25, math.pi)):
        js = jfake.scan(jnp.asarray(blocked), JPose.create(*pose), JLidar(**lidar),
                        JRaycast(max_dist=MAX_DIST))
        ts = tfake.scan(torch.from_numpy(blocked), convert.pose(*pose), LidarConfig(**lidar),
                        RaycastConfig(max_dist=MAX_DIST))
        np.testing.assert_array_equal(np_(ts.angles), np_(js.angles))
        same = np_(ts.dists) == np_(js.dists)
        assert same.mean() >= 0.98, f"scan from {pose}: {np.flatnonzero(~same)} differ"


def test_lut_quality_against_march(blocked, rng):
    """The port's own table answers bin-snapped rays within the JAX
    package's bounds (tests/test_rayfield.py): median < 1.5 px, p95 < 4."""
    lut = tlut.build_beam_lut(torch.from_numpy(blocked), n_bins=256, max_dist=120.0)
    x, y, th = (torch.from_numpy(v) for v in random_poses(rng, 512, blocked, margin=5.0))
    th = torch.round(th / (2 * math.pi / 256)) * (2 * math.pi / 256)
    d0, h0 = tmarch(torch.from_numpy(blocked), x, y, th, step=0.5, max_dist=120.0)
    d1, h1 = tlut.raycast_lut(lut, x, y, th, max_dist=120.0)
    both = (h0 & h1).numpy()
    assert both.mean() > 0.8
    err = np.abs(np_(d0) - np_(d1))[both]
    assert np.median(err) < 1.5 and np.quantile(err, 0.95) < 4.0


@pytest.mark.parametrize("dtype", ["bf16", "u8"])
def test_ray_field_cache_is_shared_with_jax(blocked, dtype, tmp_path):
    """The on-disk cache keeps the JAX format: a table either package
    wrote loads byte for byte in the other."""
    jrc = JRaycast(max_dist=MAX_DIST, backend="lut", lut_bins=64, lut_dtype=dtype)
    trc = RaycastConfig(max_dist=MAX_DIST, backend="lut", lut_bins=64, lut_dtype=dtype)
    jdir, tdir = tmp_path / "jax_wrote", tmp_path / "torch_wrote"
    jfield = jrf.make_ray_field(jnp.asarray(blocked), jrc, cache_dir=str(jdir))
    loaded = trf.make_ray_field(torch.from_numpy(blocked), trc, cache_dir=str(jdir))
    np.testing.assert_array_equal(torch_table_bits(loaded.lut), table_bits(jfield.lut))
    assert loaded.lut.dtype == DTYPES[dtype][1] and loaded.lut_bins == 64

    tfield = trf.make_ray_field(torch.from_numpy(blocked), trc, cache_dir=str(tdir))
    assert [p.name for p in tdir.iterdir()] == [p.name for p in jdir.iterdir()]
    jloaded = jrf.make_ray_field(jnp.asarray(blocked), jrc, cache_dir=str(tdir))
    np.testing.assert_array_equal(table_bits(jloaded.lut), torch_table_bits(tfield.lut))


def test_unported_backends_raise(blocked):
    """Every backend of the JAX package is ported now: `cddt` builds its
    table (tests/test_torch_cddt.py holds it to JAX's), and only a name
    neither package knows raises."""
    field = trf.make_ray_field(torch.from_numpy(blocked), RaycastConfig(backend="cddt",
                                                                        lut_bins=16))
    assert field.cddt is not None and field.cddt.n_bins == 16
    with pytest.raises(ValueError, match="unknown raycast backend"):
        trf.make_ray_field(torch.from_numpy(blocked), RaycastConfig(backend="dense"))


# Row-padded tables (`lut.pad_lut_rows`): PAD_BINS semantic bins stored in
# rows of `padded_bins` (512 bf16, 384 u8); 24 beams over pi at stride 2.
PAD_BINS = 96
PAD_LIDAR = dict(start=0.0, stop=math.pi, max_dist=MAX_DIST, n_rays=24)
PAD_OFFSET = (0.0, 10.0, 0.0)
JDTYPES = {"bf16": jnp.bfloat16, "u8": jnp.uint8, "f32": jnp.float32}
TDTYPES = {"bf16": torch.bfloat16, "u8": torch.uint8, "f32": torch.float32}


@pytest.mark.parametrize("dtype", ["bf16", "u8", "f32"])
@pytest.mark.parametrize("n_bins", [8, 90, 96, 360, 512, 720])
def test_padded_bins_matches_jax(n_bins, dtype):
    got = tlut.padded_bins(n_bins, TDTYPES[dtype])
    assert got == jlut.padded_bins(n_bins, JDTYPES[dtype])
    assert got >= n_bins and got % (384 if dtype == "u8" else 512) == 0


@functools.cache
def _padded_fields(dtype):
    """The room's JAX-built PAD_BINS field, unpadded and padded in each
    package (the port's tables carried from JAX's, `utils.convert`)."""
    jrc = JRaycast(step=0.5, max_dist=MAX_DIST, backend="lut", lut_bins=PAD_BINS,
                   lut_dtype=dtype)
    jfield = jrf.make_ray_field(jnp.asarray(room(H, W)), jrc)
    jpad = jfield.replace(lut=jlut.pad_lut_rows(jfield.lut))
    tfield = t_field(jfield)
    tpad = dataclasses.replace(tfield, lut=tlut.pad_lut_rows(tfield.lut))
    return jrc, jfield, jpad, tfield, tpad


@pytest.mark.parametrize("dtype", ["bf16", "u8"])
def test_pad_lut_rows_matches_jax(dtype):
    """The port's padded table == JAX's bit for bit (bf16 as its bits):
    the rows widened to `padded_bins`, zeros in the pad bins; a table
    already at that width comes back as it is."""
    _, jfield, jpad, tfield, tpad = _padded_fields(dtype)
    width = tlut.padded_bins(PAD_BINS, TDTYPES[dtype])
    assert tpad.lut.shape == (H, W, width) == jpad.lut.shape and width > PAD_BINS
    assert tpad.lut.dtype == tfield.lut.dtype and tpad.lut.is_contiguous()
    np.testing.assert_array_equal(torch_table_bits(tpad.lut), table_bits(jpad.lut))
    np.testing.assert_array_equal(torch_table_bits(tpad.lut[..., :PAD_BINS]),
                                  torch_table_bits(tfield.lut))
    assert not torch_table_bits(tpad.lut[..., PAD_BINS:]).any()
    assert tlut.pad_lut_rows(tpad.lut) is tpad.lut


@pytest.mark.parametrize("dtype", ["bf16", "u8"])
def test_padded_queries_match_unpadded_and_jax(dtype, rng):
    """`raycast_lut` and `panorama_rows` on padded rows with the semantic
    bin count == the unpadded table's answers == JAX's on its padded table
    (the counterpart of tests/test_rayfield.py's padded-storage test),
    positions off the map included."""
    _, jfield, jpad, tfield, tpad = _padded_fields(dtype)
    x, y, th = random_poses(rng, 3000, room(H, W), margin=-10.0)
    tx, ty, tth = (torch.from_numpy(v) for v in (x, y, th))
    d0, h0 = tlut.raycast_lut(tfield.lut, tx, ty, tth, max_dist=MAX_DIST)
    d1, h1 = tlut.raycast_lut(tpad.lut, tx, ty, tth, max_dist=MAX_DIST, n_bins=PAD_BINS)
    jd, jh = jlut.raycast_lut(jpad.lut, x, y, th, max_dist=MAX_DIST, n_bins=PAD_BINS)
    assert torch.equal(d1, d0) and torch.equal(h1, h0)
    np.testing.assert_array_equal(np_(d1), np_(jd))
    np.testing.assert_array_equal(np_(h1), np_(jh))
    assert (~np_(jh)).any() and np_(jh).any()
    p0, i0 = tlut.panorama_rows(tfield.lut, tx, ty)
    p1, i1 = tlut.panorama_rows(tpad.lut, tx, ty, PAD_BINS)
    jp, ji = jlut.panorama_rows(jpad.lut, x, y, PAD_BINS)
    assert p1.shape == p0.shape == (3000, PAD_BINS) and p1.dtype == tfield.lut.dtype
    np.testing.assert_array_equal(torch_table_bits(p1), torch_table_bits(p0))
    np.testing.assert_array_equal(torch_table_bits(p1), table_bits(jp))
    assert torch.equal(i1, i0)
    np.testing.assert_array_equal(np_(i1), np_(ji))


def _pad_scan():
    lidar = JLidar(**PAD_LIDAR)
    return jfake.scan(jnp.asarray(room(H, W)), JPose.create(50.0, 30.0, 0.4), lidar,
                      JRaycast(max_dist=MAX_DIST))


@pytest.mark.parametrize("dtype", ["bf16", "u8"])
def test_fused_weights_on_padded_rows(dtype, rng):
    """`particle_log_weights_lut_fused` on a padded field (`lut_bins` =
    PAD_BINS) == the port's unpadded field bit for bit, and == JAX's on
    its padded field within rtol 1e-5, atol 1e-3 (the tolerance
    tests/test_torch_measurement.py states for this function: exp/log ulps
    and the beam sum's order)."""
    jrc, _, jpad, tfield, tpad = _padded_fields(dtype)
    stride = beam_bin_stride(LidarConfig(**PAD_LIDAR), RaycastConfig(lut_bins=PAD_BINS))
    assert stride == 2
    jscan = _pad_scan()
    x, y, th = random_poses(rng, 2048, room(H, W), margin=-4.0)
    rc = RaycastConfig(**dataclasses.asdict(jrc))
    kw = dict(rc=rc, beam_stride=stride, scanner_offset=PAD_OFFSET, stddev=5.0, eps=0.1)
    poses = convert.pose(x, y, th)
    got = tmeas.particle_log_weights_lut_fused(tpad, poses, t_scan(jscan), **kw)
    flat = tmeas.particle_log_weights_lut_fused(tfield, poses, t_scan(jscan), **kw)
    assert torch.equal(got.view(torch.int32), flat.view(torch.int32))
    want = jmeas.particle_log_weights_lut_fused(
        jpad, JPose.create(x, y, th), jscan, rc=jrc, beam_stride=stride,
        scanner_offset=PAD_OFFSET, stddev=5.0, eps=0.1)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-5, atol=1e-3)
    assert np.ptp(np_(want)) > 10.0  # the poses score differently


def test_mcl_step_on_padded_rows():
    """Two `MCL(..., device="cpu")` filters from one seed, one on the
    unpadded bf16 field and one on its padded copy, give the same states
    bit for bit (particles, weights, estimates, generator) after two
    `step`s and an `update(..., blocked=)`."""
    jrc, _, _, tfield, tpad = _padded_fields("bf16")
    rc = RaycastConfig(**dataclasses.asdict(jrc))
    cfg = MCLConfig(n_particles=512, meas_stddev=5.0, scanner_offset=PAD_OFFSET,
                    lut_beam_stride=2)
    scan = t_scan(_pad_scan())
    odom = Odometry.create(0.02, 1.5, 0.01)
    alphas = (0.0005, 0.0005, 0.01, 0.01)
    states = []
    for field in (tfield, tpad):
        m = tmcl.MCL(cfg, rc, seed=3, device="cpu")
        st = m.init(H, W)
        for _ in range(2):
            st = m.step(st, odom, alphas, scan, field)
        # JAX's keyword for the update's map.
        states.append(m.update(st, scan, blocked=field))
    a, b = states
    for f in ("x", "y", "theta"):
        for pa, pb in ((a.particles.pose, b.particles.pose), (a.best_pose, b.best_pose),
                       (a.mode_pose, b.mode_pose)):
            assert torch.equal(getattr(pa, f), getattr(pb, f)), f
    assert torch.equal(a.particles.log_weight, b.particles.log_weight)
    assert torch.isfinite(a.particles.log_weight).all() and int(a.updates) == 3
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
