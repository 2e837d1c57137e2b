"""slam_tpu_torch LUT build and queries, the march raycaster and the
simulated lidar against the JAX package on small maps."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import LidarConfig as JLidar
from slam_tpu.core.config import RaycastConfig as JRaycast
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.ops import lut as jlut
from slam_tpu.ops import rayfield as jrf
from slam_tpu.ops.raycast import raycast_march as jmarch
from slam_tpu_torch.core.config import LidarConfig, RaycastConfig
from slam_tpu_torch.models import fake_lidar as tfake
from slam_tpu_torch.ops import lut as tlut
from slam_tpu_torch.ops import rayfield as trf
from slam_tpu_torch.ops.raycast import raycast_march as tmarch
from slam_tpu_torch.utils import convert
from torch_port import np_, random_poses, room, table_bits, torch_table_bits

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
    with pytest.raises(NotImplementedError, match="item 11"):
        trf.make_ray_field(torch.from_numpy(blocked), RaycastConfig(backend="cddt"))
