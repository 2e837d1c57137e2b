"""slam_tpu_torch.ops.mapping.scan_logodds_update against
slam_tpu.ops.mapping on identical poses and scans.

The port counts each cell's free / occupied hits with an integer
scatter-add and applies them in one multiply-add; the JAX package adds the
per-beam deltas one by one in f32. A cell hit more than once in a scan can
therefore differ in its last bits: grids are held to 1e-6, and the blocked
mask (log-odds > 0) to equality, which held on every input here."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import LidarConfig as JLidar
from slam_tpu.core.config import RaycastConfig as JRaycast
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.ops import mapping as jmap
from slam_tpu_torch.ops import mapping as tmap
from slam_tpu_torch.utils import convert
from torch_port import np_, room, t_pose, t_scan

H, W, MAX_DIST = 96, 128, 60.0
KW = dict(scanner_offset=(0.0, 2.0, 0.0), step=0.5, max_dist=MAX_DIST)


def _scan(pose, n_rays=24):
    lidar = JLidar(start=0.0, stop=2 * math.pi, max_dist=MAX_DIST, n_rays=n_rays)
    return jfake.scan(jnp.asarray(room(H, W)), pose, lidar, JRaycast(step=1.0, max_dist=MAX_DIST))


def _assert_grids(tg, jg):
    t, j = np_(tg), np.asarray(jg)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t > 0, j > 0)


# Interior, near each map edge (beams leave the map: the march stops at the
# first out-of-bounds step) and outside the map.
POSES = [(50.3, 40.7, 0.3), (3.2, 45.0, 2.9), (120.5, 90.1, -0.7), (64.0, 2.5, 1.6),
         (-3.0, 20.0, 0.0)]


def test_beam_cells_match():
    sp = JPose.create(50.3, 40.7, 0.3)
    angles = jnp.asarray(np.linspace(-math.pi, math.pi, 24, endpoint=False), jnp.float32)
    want = jmap._beam_cells((H, W), sp, sp.theta + angles, step=0.5, max_dist=MAX_DIST)
    tsp = t_pose(sp)
    got = tmap._beam_cells((H, W), tsp, tsp.theta + convert.tensor(angles), step=0.5,
                           max_dist=MAX_DIST)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(np_(g), np.asarray(w_))


@pytest.mark.parametrize("pose", POSES)
@pytest.mark.parametrize("l_occ,l_free", [(0.85, -0.4), (0.42, -0.2)])
def test_scan_logodds_update(rng, pose, l_occ, l_free):
    """One scan onto a random grid (values on both sides of 0); the scan has
    max-range misses (its beams out of the room's openings and the
    max_dist cut)."""
    p = JPose.create(*pose)
    scan = _scan(JPose.create(50.3, 40.7, 0.3))
    assert float(jnp.max(scan.dists)) == MAX_DIST  # some max-range misses
    grid = rng.uniform(-2.0, 2.0, (H, W)).astype(np.float32)
    kw = dict(KW, l_occ=l_occ, l_free=l_free)
    jg = jmap.scan_logodds_update(jnp.asarray(grid), p, scan, **kw)
    tg = tmap.scan_logodds_update(torch.from_numpy(grid), t_pose(p), t_scan(scan), **kw)
    _assert_grids(tg, jg)
    assert tg.dtype == torch.float32


def test_max_range_misses_mark_no_occupied_cell():
    p = JPose.create(50.3, 40.7, 0.3)
    scan = _scan(p)
    miss = scan.replace(dists=jnp.full_like(scan.dists, MAX_DIST))
    tg = tmap.scan_logodds_update(torch.zeros(H, W), t_pose(p), t_scan(miss), **KW)
    assert float(tg.max()) == 0.0 and float(tg.min()) < 0.0
    _assert_grids(tg, jmap.scan_logodds_update(jnp.zeros((H, W)), p, miss, **KW))


def test_chained_updates_match(rng):
    """40 scans from random poses accumulate onto one grid (cells hit many
    times, l_min / l_max clamps, sums through 0)."""
    kw = dict(KW, l_occ=0.42, l_free=-0.2, l_min=-1.0, l_max=1.0)
    jg, tg = jnp.zeros((H, W)), torch.zeros(H, W)
    for _ in range(40):
        p = JPose.create(float(rng.uniform(10, W - 10)), float(rng.uniform(10, H - 10)),
                         float(rng.uniform(-math.pi, math.pi)))
        scan = _scan(p)
        jg = jmap.scan_logodds_update(jg, p, scan, **kw)
        tg = tmap.scan_logodds_update(tg, t_pose(p), t_scan(scan), **kw)
    _assert_grids(tg, jg)
    assert float(tg.max()) == 1.0 and float(tg.min()) == -1.0


@pytest.mark.parametrize("rows", [(0, 40), (40, 96), (30, 70)])
def test_row_blocks_compose(rows):
    """A row block updated with row_offset / full_h: equal to the JAX
    block, and the port's blocks tile into its full update bit for bit."""
    p = JPose.create(50.3, 40.7, 0.3)
    scan = _scan(p)
    r0, r1 = rows
    full = tmap.scan_logodds_update(torch.zeros(H, W), t_pose(p), t_scan(scan), **KW)
    tb = tmap.scan_logodds_update(torch.zeros(r1 - r0, W), t_pose(p), t_scan(scan),
                                  row_offset=r0, full_h=H, **KW)
    jb = jmap.scan_logodds_update(jnp.zeros((r1 - r0, W)), p, scan, row_offset=r0,
                                  full_h=H, **KW)
    _assert_grids(tb, jb)
    assert torch.equal(tb, full[r0:r1])
