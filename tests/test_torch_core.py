"""slam_tpu_torch core parity: config copy, grid and angle arithmetic,
statistics, and the port's JAX-free import."""

import dataclasses
import math
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slam_tpu.core.config as jcfg
from slam_tpu.core import grid as jgrid
from slam_tpu.core import stats as jstats
from slam_tpu.ops import lut as jlut
from slam_tpu_torch.core import config as tcfg
from slam_tpu_torch.core import grid as tgrid
from slam_tpu_torch.core import stats as tstats
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Box, Pose, Velocity
from slam_tpu_torch.models.fleet import MCLFleet
from slam_tpu_torch.models.mcl import MCL
from slam_tpu_torch.models.rbpf import RBPF
from slam_tpu_torch.models.slam import GridSLAM
from slam_tpu_torch.ops import lut as tlut
from slam_tpu_torch.planners import AStar, HybridAStar, RRTStar
from slam_tpu_torch.utils import convert
from torch_port import np_

REPO = Path(__file__).resolve().parent.parent


def _dataclasses(mod):
    return {
        name: obj
        for name, obj in vars(mod).items()
        if isinstance(obj, type) and dataclasses.is_dataclass(obj)
        and obj.__module__ == mod.__name__
    }


def test_config_copy_matches_original():
    """Same classes, field names (in order), defaults, properties."""
    jc, tc = _dataclasses(jcfg), _dataclasses(tcfg)
    assert sorted(jc) == sorted(tc)
    for name in jc:
        jf, tf = dataclasses.fields(jc[name]), dataclasses.fields(tc[name])
        assert [f.name for f in jf] == [f.name for f in tf], name
        assert dataclasses.asdict(jc[name]()) == dataclasses.asdict(tc[name]()), name
        assert jc[name].__dataclass_params__.frozen and tc[name].__dataclass_params__.frozen
    assert jcfg.RaycastConfig(step=0.3).max_steps == tcfg.RaycastConfig(step=0.3).max_steps
    assert jcfg.LidarConfig(n_rays=7).angles == tcfg.LidarConfig(n_rays=7).angles
    assert jcfg.MapConfig().shape == tcfg.MapConfig().shape


@pytest.mark.parametrize("n_rays", [90, 60, 45, 100, 361])
@pytest.mark.parametrize("stop", [math.pi, 2 * math.pi, 1.0])
@pytest.mark.parametrize("bins", [360, 256])
def test_beam_bin_stride_matches(n_rays, stop, bins):
    j = jcfg.beam_bin_stride(
        jcfg.LidarConfig(start=0.0, stop=stop, n_rays=n_rays), jcfg.RaycastConfig(lut_bins=bins)
    )
    t = tcfg.beam_bin_stride(
        tcfg.LidarConfig(start=0.0, stop=stop, n_rays=n_rays), tcfg.RaycastConfig(lut_bins=bins)
    )
    assert j == t


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.MCLConfig(resample_every=0),
        lambda m: m.MCLConfig(lf_table_box=0),
        lambda m: m.SLAMConfig(map_pose="typo"),
        lambda m: m.ScanMatchConfig(coarse_window=4, window=1, coarse_stride=8),
        lambda m: m.ScanMatchConfig(coarse_window=4, theta_halfwidth=0.01),
    ],
)
def test_config_validation_matches(make):
    with pytest.raises(ValueError):
        make(jcfg)
    with pytest.raises(ValueError):
        make(tcfg)


def _edge_angles(rng):
    base = rng.uniform(-30.0, 30.0, 4000).astype(np.float32)
    k = np.arange(-6, 7, dtype=np.float32)
    special = np.concatenate([k * np.float32(np.pi), k * np.float32(np.pi) + 1e-6,
                              k * np.float32(np.pi) - 1e-6, [0.0, -0.0]])
    return np.concatenate([base, special.astype(np.float32)])


def test_normalize_angle_exact(rng):
    a = _edge_angles(rng)
    want = np.asarray(jstats.normalize_angle(jnp.asarray(a)))
    got = tstats.normalize_angle(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_bins", [360, 256, 7])
def test_angle_bin_exact(rng, n_bins):
    a = _edge_angles(rng)
    binw = np.float32(2 * np.pi / n_bins)
    a = np.concatenate([a, (np.arange(-3 * n_bins, 3 * n_bins) * binw).astype(np.float32),
                        (np.arange(-40, 40) * binw + binw / 2).astype(np.float32)])
    want = np.asarray(jlut.angle_bin(jnp.asarray(a), n_bins))
    got = tlut.angle_bin(torch.from_numpy(a), n_bins).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < n_bins


def test_world_to_cell_exact(rng):
    """Negative and out-of-map coordinates floor toward -inf."""
    shape = (37, 53)
    v = np.concatenate([rng.uniform(-80, 120, 4000),
                        np.arange(-5, 60, 0.5), [-1e-6, 0.0, 1e-6, -0.5, 36.0, 36.5]])
    x = v.astype(np.float32)
    y = rng.permutation(v).astype(np.float32)
    ji, jj = jgrid.world_to_cell(shape, jnp.asarray(x), jnp.asarray(y))
    ti, tj = tgrid.world_to_cell(shape, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(
        tgrid.in_bounds(shape, ti, tj).numpy(), np.asarray(jgrid.in_bounds(shape, ji, jj))
    )
    for t, j in zip(tgrid.clamp_cell(shape, ti, tj), jgrid.clamp_cell(shape, ji, jj)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for t, j in zip(tgrid.cell_to_world(shape, ti, tj), jgrid.cell_to_world(shape, ji, jj)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_stats_match(rng):
    """Densities and the beam log factor to rtol 1e-6 (exp/log ulps), the
    circular mean to 1e-5."""
    x = rng.uniform(-30, 30, 2000).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for tf, jf in (
        (lambda v: tstats.pdf_normal(5.0, v), lambda v: jstats.pdf_normal(5.0, v)),
        (lambda v: tstats.pdf_normal_clamp(5.0, v), lambda v: jstats.pdf_normal_clamp(5.0, v)),
        (lambda v: tstats.log_pdf_normal_clamp_eps(5.0, v, 0.1),
         lambda v: jstats.log_pdf_normal_clamp_eps(5.0, v, 0.1)),
    ):
        np.testing.assert_allclose(np_(tf(xt)), np_(jf(xj)), rtol=1e-6, atol=1e-12)
    y = rng.uniform(0, 50, 2000).astype(np.float32)
    th = rng.uniform(-1, 2, 2000).astype(np.float32)
    wts = rng.uniform(0, 1, 2000).astype(np.float32)
    for wt in (None, wts):
        j = jstats.average_pose(jnp.asarray(x), jnp.asarray(y), jnp.asarray(th),
                                None if wt is None else jnp.asarray(wt))
        t = tstats.average_pose(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(th),
                                None if wt is None else torch.from_numpy(wt))
        np.testing.assert_allclose([float(v) for v in t], [float(v) for v in j],
                                   rtol=1e-5, atol=1e-5)


def test_triangular_and_blocked_helpers_match(rng):
    """pdf_triangular to rtol 1e-6; sample_normal / sample_triangular with
    JAX's own draws injected to 1e-6; the blocked-mask helpers exact;
    random_cell with JAX's dtype, support and means (5 sigma); Velocity
    and Box carry their fields."""
    import jax

    x = rng.uniform(-20, 20, 3000).astype(np.float32)
    for sd in (2.0, 5.0):
        np.testing.assert_allclose(np_(tstats.pdf_triangular(sd, torch.from_numpy(x))),
                                   np_(jstats.pdf_triangular(sd, jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-9)
    key = jax.random.key(3)
    want = jstats.sample_normal(key, 2.5, (500,))
    got = tstats.sample_normal(2.5, noise=convert.tensor(jax.random.normal(key, (500,))))
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-6, atol=1e-6)
    k1, k2 = jax.random.split(key)
    u = tuple(convert.tensor(jax.random.uniform(k, (500,), minval=-1.0, maxval=1.0))
              for k in (k1, k2))
    np.testing.assert_allclose(np_(tstats.sample_triangular(1.5, u=u)),
                               np_(jstats.sample_triangular(key, 1.5, (500,))), rtol=1e-6, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    assert tstats.sample_triangular(1.0, (4000,), generator=g).abs().max() <= 1.0 + 6 ** 0.5 / 2
    # random_cell: the same dtype and half-open support as JAX's, and the
    # same per-axis means within 5 sigma over 4000 draws of each.
    m = 4000
    ti, tj = (torch.stack(v).numpy() for v in zip(*(
        tstats.random_cell((7, 9), generator=g) for _ in range(m))))
    ji, jj = (np.asarray(v) for v in jax.vmap(lambda k: jstats.random_cell(k, (7, 9)))(
        jax.random.split(jax.random.key(5), m)))
    assert ti.dtype == ji.dtype == np.int32
    for t_, j_, n_ in ((ti, ji, 7), (tj, jj, 9)):
        assert set(t_.tolist()) == set(j_.tolist()) == set(range(n_))
        sd = math.sqrt((n_ * n_ - 1) / 12.0 * 2.0 / m)  # std of the mean gap
        assert abs(t_.mean() - j_.mean()) < 5.0 * sd
    pf = rng.uniform(0, 1, (20, 30)).astype(np.float32)
    u8 = rng.integers(0, 256, (20, 30)).astype(np.uint8)
    b = rng.integers(0, 2, (20, 30)).astype(np.int32)
    for tf, jf, v in ((tgrid.blocked_from_prob_free, jgrid.blocked_from_prob_free, pf),
                      (tgrid.blocked_from_u8, jgrid.blocked_from_u8, u8),
                      (tgrid.blocked_from_binary, jgrid.blocked_from_binary, b)):
        np.testing.assert_array_equal(tf(torch.from_numpy(v)).numpy(), np.asarray(jf(jnp.asarray(v))))
    vel = Velocity.create(1.5, -0.25)
    assert vel.v.dtype == torch.float32 and float(vel.w) == -0.25
    box = Box(1, 2, 3, 4)
    assert (box.start_i, box.start_j, box.stop_i, box.stop_j) == (1, 2, 3, 4)


_IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|flax|slam_tpu)(\.|\s|$)", re.M)


def test_port_sources_import_no_jax():
    files = sorted((REPO / "slam_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for p in files:
        assert not _IMPORT_RE.search(p.read_text()), f"{p} imports jax/flax/slam_tpu"


def test_import_without_jax():
    """With jax (and the JAX package) unimportable, the port's main paths
    (MCL, SLAM, the RBPF, scan matching, the simulator, diagnostics, the
    planners, the CDDT, the fleet, the tools, utilities and apps) still
    import."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['slam_tpu'] = None\n"
        "import slam_tpu_torch.models.mcl, slam_tpu_torch.models.slam\n"
        "import slam_tpu_torch.utils.convert, slam_tpu_torch.utils.maps\n"
        "import slam_tpu_torch.utils.metrics, slam_tpu_torch.utils.logging\n"
        "import slam_tpu_torch.planners.astar, slam_tpu_torch.planners.hastar\n"
        "import slam_tpu_torch.planners.rrtstar, slam_tpu_torch.ops.spatial\n"
        "from slam_tpu_torch.planners import AStar, HybridAStar, RRTStar\n"
        "import slam_tpu_torch.ops._build\n"
        "import slam_tpu_torch.models.rbpf, slam_tpu_torch.ops.scanmatch\n"
        "import slam_tpu_torch.models.simulate, slam_tpu_torch.utils.diagnostics\n"
        "import slam_tpu_torch.tools.global_loc_bench\n"
        "import slam_tpu_torch.ops.cddt, slam_tpu_torch.models.fleet\n"
        "import slam_tpu_torch.tools.maze_bench, slam_tpu_torch.tools.fleet_bench\n"
        "import slam_tpu_torch.utils.checkpoint, slam_tpu_torch.utils.profiling\n"
        "import slam_tpu_torch.utils.render, slam_tpu_torch.native\n"
        "import slam_tpu_torch.apps.grid_slam, slam_tpu_torch.apps.slam_replan\n"
        "import slam_tpu_torch.apps.fleet_localization, slam_tpu_torch.apps.astar_planner\n"
        "import slam_tpu_torch.apps.hastar_planner, slam_tpu_torch.apps.rrt_planner\n"
        "import slam_tpu_torch.apps.nearest_neighbor, slam_tpu_torch.apps.regions\n"
        "from slam_tpu_torch.models.rbpf import RBPF\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


ENTRY_POINTS = {
    "MCL": lambda **kw: MCL(tcfg.MCLConfig(), **kw),
    "GridSLAM": lambda **kw: GridSLAM(tcfg.SLAMConfig(), **kw),
    "RBPF": lambda **kw: RBPF(tcfg.MCLConfig(n_particles=4), **kw),
    "MCLFleet": lambda **kw: MCLFleet(2, tcfg.MCLConfig(n_particles=4), **kw),
    "AStar": lambda **kw: AStar(np.ones((16, 16), bool), (1, 1), (9, 9), **kw),
    "RRTStar": lambda **kw: RRTStar(np.ones((16, 16), bool), (1.0, 1.0), (9.0, 9.0), **kw),
    "HybridAStar": lambda **kw: HybridAStar(
        np.ones((16, 16), bool), Pose.create(2.0, 2.0, 0.0), Pose.create(9.0, 9.0, 0.0),
        tcfg.HybridAStarConfig(mode="continuous"), **kw),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, name):
    """With no `device`, an entry point runs on the CUDA card; on a
    machine without one it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](device="cuda")
    assert entry_device("cpu") == torch.device("cpu")
