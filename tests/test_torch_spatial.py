"""slam_tpu_torch.ops.spatial against slam_tpu.ops.spatial: indices and
masks exact, distances within one ulp (both take a correctly rounded
square root of the same squared distance, up to its rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import spatial as jsp
from slam_tpu_torch.ops import spatial as tsp
from torch_port import np_


def _points(seed, n, q, scale=100.0, valid_p=0.7):
    rng = np.random.default_rng(seed)
    f = np.float32
    px, py = (rng.random(n) * scale).astype(f), (rng.random(n) * scale).astype(f)
    # Integer coordinates make exact distance ties.
    px[: n // 4] = np.round(px[: n // 4])
    py[: n // 4] = np.round(py[: n // 4])
    valid = rng.random(n) < valid_p
    qx, qy = (rng.random(q) * scale).astype(f), (rng.random(q) * scale).astype(f)
    qx[: q // 4] = np.round(qx[: q // 4])
    qy[: q // 4] = np.round(qy[: q // 4])
    return px, py, valid, qx, qy


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _assert_ulp(got, want, ulps=1):
    got, want = np_(got), np_(want)
    big = want >= 1e29
    np.testing.assert_array_equal(got[big], want[big])
    d = np.abs(got[~big].view(np.int32).astype(np.int64) - want[~big].view(np.int32))
    assert d.max(initial=0) <= ulps


def test_sq_dist_tile_and_within_radius():
    j, t = _both(*_points(0, 300, 40))
    jpx, jpy, jv, jqx, jqy = j
    tpx, tpy, tv, tqx, tqy = t
    np.testing.assert_allclose(np_(tsp.sq_dist_tile(tpx, tpy, tqx, tqy)),
                               np_(jsp.sq_dist_tile(jpx, jpy, jqx, jqy)), rtol=2e-7)
    for r in (3.0, 12.5, 40.0):
        np.testing.assert_array_equal(np_(tsp.within_radius(tpx, tpy, tv, tqx, tqy, r)),
                                      np_(jsp.within_radius(jpx, jpy, jv, jqx, jqy, r)))


@pytest.mark.parametrize("valid_p", [0.7, 0.0])
def test_nearest_neighbor(valid_p):
    j, t = _both(*_points(1, 500, 64, valid_p=valid_p))
    ji, jd = jsp.nearest_neighbor(*j)
    ti, td = tsp.nearest_neighbor(*t)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(np_(ti), np_(ji))
    _assert_ulp(td, jd)


@pytest.mark.parametrize("n", [1000, 4096, 4097])
def test_nearest_neighbor_blocked(n):
    """Ragged N: the last block is padded with invalid points; equal to
    the JAX scan and to the one-tile query."""
    j, t = _both(*_points(2, n, 48, scale=60.0))
    ji, jd = jsp.nearest_neighbor_blocked(*j, block=512)
    ti, td = tsp.nearest_neighbor_blocked(*t, block=512)
    np.testing.assert_array_equal(np_(ti), np_(ji))
    _assert_ulp(td, jd)
    pi, pd = tsp.nearest_neighbor(*t)
    np.testing.assert_array_equal(np_(ti), np_(pi))
    np.testing.assert_array_equal(np_(td), np_(pd))


def test_box_queries():
    px, py, valid, _, _ = _points(3, 400, 1)
    rng = np.random.default_rng(4)
    lo = np.round(rng.random((20, 2)) * 80).astype(np.float32)
    boxes = np.concatenate([lo, lo + np.round(rng.random((20, 2)) * 30)], 1)
    boxes = boxes.astype(np.float32)
    (jpx, jpy, jv, jb), (tpx, tpy, tv, tb) = _both(px, py, valid, boxes)
    np.testing.assert_array_equal(np_(tsp.range_query_boxes(tpx, tpy, tv, tb)),
                                  np_(jsp.range_query_boxes(jpx, jpy, jv, jb)))
    for k in range(3):
        jbox = tuple(jb[k, c] for c in range(4))
        tbox = tuple(tb[k, c] for c in range(4))
        np.testing.assert_array_equal(np_(tsp.in_box(tpx, tpy, tv, tbox)),
                                      np_(jsp.in_box(jpx, jpy, jv, jbox)))
