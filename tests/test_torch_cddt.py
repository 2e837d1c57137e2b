"""slam_tpu_torch's compressed ray table (`ops/cddt.py`) and the rayfield's
cddt branch against `slam_tpu.ops.cddt` on the same maps: the build, both
query branches (the masked min at K <= 64, the binary search above), the
overflow count and the npz cache, which both packages read."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import RaycastConfig as JRaycast
from slam_tpu.ops import cddt as jcddt
from slam_tpu.ops import rayfield as jrf
from slam_tpu_torch.core.config import RaycastConfig
from slam_tpu_torch.ops import cddt as tcddt
from slam_tpu_torch.ops import lut as tlut
from slam_tpu_torch.ops import rayfield as trf
from torch_port import np_, room

MAX_DIST = 80.0
BINS = 36


def stripes(h: int = 200, w: int = 200, pitch: int = 3) -> np.ndarray:
    """Vertical one-pixel walls every `pitch` px in a border: rows across
    them cross ~w / pitch obstacle runs, so K > 64."""
    b = np.zeros((h, w), bool)
    b[:, ::pitch] = True
    b[[0, -1], :] = True
    b[:, [0, -1]] = True
    return b


MAPS = {"room": lambda: room(64, 80), "stripes": stripes}
_TABLES = {}


def tables(name: str, k=None):
    """(blocked, JAX table, port table) of a map, built once."""
    if (name, k) not in _TABLES:
        blocked = MAPS[name]()
        _TABLES[name, k] = (blocked, jcddt.build_cddt(jnp.asarray(blocked), n_bins=BINS, k=k),
                            tcddt.build_cddt(torch.from_numpy(blocked), n_bins=BINS, k=k))
    return _TABLES[name, k]


def rays(blocked, n: int, seed: int):
    rng = np.random.default_rng(seed)
    h, w = blocked.shape
    return (rng.uniform(1, w - 1, n).astype(np.float32),
            rng.uniform(1, h - 1, n).astype(np.float32),
            rng.uniform(-math.pi, math.pi, n).astype(np.float32))


def as_port(table) -> tcddt.CDDTTable:
    return tcddt.CDDTTable(starts=torch.from_numpy(np.array(table.starts)),
                           ends=torch.from_numpy(np.array(table.ends)),
                           n_bins=table.n_bins, n_overflow=table.n_overflow)


@pytest.mark.parametrize("name", list(MAPS))
def test_build_matches_jax(name):
    """The interval tables equal JAX's up to the canvas trig flips of
    `rotated_blocked_canvas` (f32 sin/cos differ by an ulp between XLA:CPU
    and torch on ~5% of angles): the room 64x80 at 36 bins is equal
    everywhere; the stripe map (K = 67 > 64) differs on 8 of 246k entries
    in two bins."""
    blocked, jt, tt = tables(name)
    assert (jt.k, jt.d, jt.n_overflow) == (tt.k, tt.d, tt.n_overflow) == (jt.k, jt.d, 0)
    assert tt.starts.dtype == tt.ends.dtype == torch.int16
    assert tt.nbytes == jt.nbytes
    same = (np_(tt.starts) == np.asarray(jt.starts)) & (np_(tt.ends) == np.asarray(jt.ends))
    assert same.mean() >= (1.0 if name == "room" else 0.9999)
    if name == "stripes":
        assert tt.k > 64  # the binary-search branch


@pytest.mark.parametrize("name", list(MAPS))
def test_queries_match_jax_on_both_branches(name):
    """On JAX's own table both packages answer 4000 rays identically (ties
    in the query's angle bin or canvas row are counted, and none occur);
    on its own table the port differs from JAX on <= 0.1% of the rays,
    the rays through the trig-flipped entries."""
    blocked, jt, tt = tables(name)
    x, y, th = rays(blocked, 4000, 3)
    jd, jh = jcddt.raycast_cddt(jt, jnp.asarray(x), jnp.asarray(y), jnp.asarray(th),
                                max_dist=MAX_DIST, shape=blocked.shape)
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(th))
    td, th_ = tcddt.raycast_cddt(as_port(jt), *args, max_dist=MAX_DIST, shape=blocked.shape)
    ties = int(np.sum((np_(td) != np.asarray(jd)) | (np_(th_) != np.asarray(jh))))
    assert ties == 0
    od, oh = tcddt.raycast_cddt(tt, *args, max_dist=MAX_DIST, shape=blocked.shape)
    assert np.mean((np_(od) != np.asarray(jd)) | (np_(oh) != np.asarray(jh))) <= 0.001
    assert 0.3 < np.mean(np.asarray(jh)) < 1.0


def test_scan_and_search_branches_agree():
    """The room padded to K = 80 takes the binary search and answers as
    the masked min over its K = 4 table does, in both packages."""
    blocked, jt, tt = tables("room")
    _, jt80, tt80 = tables("room", k=80)
    assert tt.k <= 64 < tt80.k == 80 and tt80.n_overflow == 0
    x, y, th = rays(blocked, 2000, 5)
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(th))
    d0, h0 = tcddt.raycast_cddt(tt, *args, max_dist=MAX_DIST, shape=blocked.shape)
    d1, h1 = tcddt.raycast_cddt(tt80, *args, max_dist=MAX_DIST, shape=blocked.shape)
    assert torch.equal(d0, d1) and torch.equal(h0, h1)
    jd, _ = jcddt.raycast_cddt(jt80, jnp.asarray(x), jnp.asarray(y), jnp.asarray(th),
                               max_dist=MAX_DIST, shape=blocked.shape)
    np.testing.assert_array_equal(np_(d1), np.asarray(jd))


def test_matches_dense_lut_except_angle_ties():
    """Against the port's dense f32 LUT on the same map: equal except
    where the dense quad build derives a bin from another canvas (the JAX
    package's bound, tests/test_rayfield.py:175)."""
    blocked, _, tt = tables("room")
    lut = tlut.build_beam_lut(torch.from_numpy(blocked), n_bins=BINS, max_dist=MAX_DIST,
                              dtype=torch.float32)
    x, y, th = rays(blocked, 4000, 7)
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(th))
    d0, h0 = tlut.raycast_lut(lut, *args, max_dist=MAX_DIST)
    d1, h1 = tcddt.raycast_cddt(tt, *args, max_dist=MAX_DIST, shape=blocked.shape)
    assert float(((d0 == d1) & (h0 == h1)).float().mean()) > 0.995


def test_explicit_k_overflow_is_counted():
    """k=2 on the room drops runs: the port counts as many as JAX (772)."""
    _, jt, tt = tables("room", k=2)
    assert tt.k == jt.k == 2
    assert tt.n_overflow == jt.n_overflow > 0
    np.testing.assert_array_equal(np_(tt.starts), np.asarray(jt.starts))
    with pytest.raises(ValueError, match="even n_bins"):
        tcddt.build_cddt(torch.zeros((8, 8), dtype=torch.bool), n_bins=7)


def test_rayfield_cddt_cache_round_trips_across_packages(tmp_path, caplog):
    """`make_ray_field` with the cddt backend writes the `cddt-v1` npz
    under JAX's key: each package loads the table the other cached, and
    `raycast_field` dispatches to `raycast_cddt`. A truncated table
    warns."""
    blocked = room(64, 80)
    kw = dict(backend="cddt", max_dist=MAX_DIST, lut_bins=BINS)
    jrc, trc = JRaycast(**kw), RaycastConfig(**kw)
    jdir, tdir = tmp_path / "jax_wrote", tmp_path / "torch_wrote"
    jfield = jrf.make_ray_field(jnp.asarray(blocked), jrc, cache_dir=str(jdir))
    loaded = trf.make_ray_field(torch.from_numpy(blocked), trc, cache_dir=str(jdir))
    np.testing.assert_array_equal(np_(loaded.cddt.starts), np.asarray(jfield.cddt.starts))
    tfield = trf.make_ray_field(torch.from_numpy(blocked), trc, cache_dir=str(tdir))
    assert [p.name for p in tdir.iterdir()] == [p.name for p in jdir.iterdir()]
    jloaded = jrf.make_ray_field(jnp.asarray(blocked), jrc, cache_dir=str(tdir))
    np.testing.assert_array_equal(np.asarray(jloaded.cddt.ends), np_(tfield.cddt.ends))
    again = trf.make_ray_field(torch.from_numpy(blocked), trc, cache_dir=str(tdir))
    assert torch.equal(again.cddt.starts, tfield.cddt.starts)

    x, y, th = rays(blocked, 256, 9)
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(th))
    d0, h0 = trf.raycast_field(tfield, *args, trc)
    d1, h1 = tcddt.raycast_cddt(tfield.cddt, *args, max_dist=MAX_DIST, shape=blocked.shape)
    assert torch.equal(d0, d1) and torch.equal(h0, h1)
    with pytest.raises(ValueError, match="field.cddt"):
        trf.raycast_field(trf.RayField(blocked=torch.from_numpy(blocked)), *args, trc)
    trf.make_ray_field(torch.from_numpy(blocked), RaycastConfig(**kw, cddt_k=2))
    assert "dropped" in caplog.text
