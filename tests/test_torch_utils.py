"""slam_tpu_torch's app utilities against the JAX package's: checkpoints
(`utils/checkpoint.py`, as tests/test_utils.py holds orbax's), rendering,
profiling on the CPU, the native bindings' CPU fallbacks and the map IO."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import native as jnative
from slam_tpu.ops.raycast import raycast_march as jmarch
from slam_tpu.utils import maps as jmaps
from slam_tpu.utils import render as jrender
from slam_tpu_torch import native as tnative
from slam_tpu_torch.core.config import MapConfig, MCLConfig, SLAMConfig
from slam_tpu_torch.core.types import Odometry, Particles, Pose
from slam_tpu_torch.models import fake_lidar
from slam_tpu_torch.models import slam as slam_mod
from slam_tpu_torch.utils import checkpoint, maps, profiling, render
from torch_port import room


def _state(n: int, seed: int = 7, shape=(32, 32)):
    cfg = SLAMConfig(mcl=MCLConfig(n_particles=n), map=MapConfig(height=shape[0], width=shape[1]))
    return cfg, slam_mod.init(seed, cfg, Pose.create(16.0, 16.0, 0.5))


def test_checkpoint_roundtrip_slam_state(tmp_path):
    """Grid, particles, counters and the generator round-trip: the
    restored generator draws what the saved one draws next."""
    cfg, state = _state(32)
    state = state.replace(grid=state.grid.clone().index_put_((torch.tensor(3), torch.tensor(4)),
                                                             torch.tensor(1.5)))
    state.mcl.generator.manual_seed(123)
    state = state.replace(mcl=state.mcl.replace(step=5, updates=4))
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, state)
    template = slam_mod.init(0, cfg, Pose.create(0.0, 0.0, 0.0))
    restored = checkpoint.restore(path, template)
    assert torch.equal(restored.grid, state.grid)
    assert torch.equal(restored.mcl.particles.pose.x, state.mcl.particles.pose.x)
    assert (restored.mcl.step, restored.mcl.updates) == (5, 4)
    assert restored.edt is None
    assert torch.equal(torch.rand(8, generator=restored.mcl.generator),
                       torch.rand(8, generator=state.mcl.generator))


def test_checkpoint_manager_rolls(tmp_path):
    cfg, state = _state(8, shape=(16, 16))
    mgr = checkpoint.CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    for step in range(3):
        mgr.save(step, state.replace(grid=state.grid + step))
    assert mgr.latest_step() == 2
    assert sorted(os.listdir(tmp_path / "run")) == ["1", "2"]
    assert float(mgr.restore(state).grid[0, 0]) == 2.0
    assert float(mgr.restore(state, step=1).grid[0, 0]) == 1.0
    mgr.close()


@dataclasses.dataclass
class OldMCLState:  # the first layout: no mode pose, EMAs or update counter
    particles: object
    generator: object
    best_pose: object
    step: int


@dataclasses.dataclass
class OldSLAMState:  # and no est_pose or EDT cache
    mcl: OldMCLState
    grid: object


def _old_state(seed: int = 7):
    pose = Pose.create(8.0, 8.0, 0.5)
    return OldSLAMState(
        mcl=OldMCLState(particles=Particles.uniform_at(pose, 8),
                        generator=torch.Generator().manual_seed(seed),
                        best_pose=Pose.create(9.0, 7.0, 0.25), step=42),
        grid=torch.full((16, 16), 0.75))


def test_checkpoint_migrates_old_format(tmp_path, caplog):
    """An older layout restores with the missing fields filled by the
    documented defaults: est_pose and mode_pose from the saved best
    particle, updates from the saved step, the EMAs NaN; the migrated
    state resumes (one SLAM step runs)."""
    old = _old_state()
    path = str(tmp_path / "old_ckpt")
    checkpoint.save(path, old)
    cfg, template = _state(8, seed=0, shape=(16, 16))
    restored = checkpoint.restore(path, template)
    assert "predates the current state format" in caplog.text
    assert torch.equal(restored.grid, old.grid)
    assert float(restored.est_pose.x) == 9.0 and float(restored.est_pose.theta) == 0.25
    assert float(restored.mcl.mode_pose.y) == 7.0
    assert restored.mcl.updates == 42 and restored.mcl.step == 42
    assert bool(torch.isnan(restored.mcl.log_w_slow)) and bool(torch.isnan(restored.mcl.log_w_fast))
    assert torch.equal(torch.rand(4, generator=restored.mcl.generator),
                       torch.rand(4, generator=torch.Generator().manual_seed(7)))
    blocked = torch.zeros((16, 16), dtype=torch.bool)
    blocked[2, :] = True
    scan = fake_lidar.scan(blocked, Pose.create(8.0, 8.0, 0.5), cfg.lidar, cfg.raycast)
    out = slam_mod.step(restored, Odometry.create(0.0, 0.5, 0.0), scan, cfg)
    assert out.mcl.updates == 43


def test_checkpoint_manager_migrates_old_format(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "run"))
    mgr.save(0, _old_state(3))
    mgr.close()
    _, template = _state(8, seed=0, shape=(16, 16))
    restored = checkpoint.CheckpointManager(str(tmp_path / "run")).restore(template)
    assert restored.mcl.updates == 42 and float(restored.est_pose.x) == 9.0


def test_checkpoint_migration_rejects_real_mismatch(tmp_path):
    """A shape mismatch (another particle count) is a config error, not a
    format change: the restore refuses with the cause."""
    _, state = _state(8, shape=(16, 16))
    path = str(tmp_path / "ck")
    checkpoint.save(path, state)
    _, template = _state(16, shape=(16, 16))
    with pytest.raises(ValueError, match="particle count|shape"):
        checkpoint.restore(path, template)


def test_render_primitives_match_jax(tmp_path):
    """The copy draws what the JAX package's module draws, pixel for
    pixel, and writes PNG and GIF."""
    imgs = []
    for mod in (render, jrender):
        img = mod.blocked_to_rgb(room(32, 40))
        mod.draw_disc(img, 5, 5, 2, mod.RED)
        mod.draw_line(img, 0, 0, 31, 39, mod.BLUE)
        mod.draw_pose(img, 16.0, 16.0, 0.5, mod.GREEN)
        mod.draw_particles(img, np.array([3.0, 4.0]), np.array([3.0, 4.0]))
        mod.draw_path_world(img, [(2.0, 2.0), (30.0, 20.0)], mod.CYAN)
        mod.draw_scan(img, 20.0, 10.0, 0.1, np.array([0.0, 1.0]), np.array([5.0, 8.0]))
        imgs.append(img)
    np.testing.assert_array_equal(imgs[0], imgs[1])
    p = str(tmp_path / "x.png")
    render.save_png(imgs[0], p)
    render.save_gif([imgs[0], imgs[1]], str(tmp_path / "x.gif"))
    assert os.path.getsize(p) > 0 and (tmp_path / "x.gif").exists()


def test_profiling_on_the_cpu(tmp_path, capsys):
    """fence is a no-op for CPU tensors and trees of them; device_timer
    and Stopwatch time blocks; trace writes a Chrome trace."""
    _, state = _state(8, shape=(16, 16))
    profiling.fence(state)
    profiling.fence({"a": [torch.zeros(2)], "b": None})
    box = {}
    with profiling.device_timer("block", box) as b:
        b["out"] = torch.ones(4) * 2
    assert box["seconds"] >= 0 and "block:" in capsys.readouterr().out
    sw = profiling.Stopwatch()
    for _ in range(3):
        with sw.phase("mul", result=torch.ones(2)):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert sw.counts["mul"] == 3 and "x3" in sw.report()
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


def test_native_fallbacks_match_jax():
    """Without the built library both packages fall back: the port to its
    march and `utils/maps.erode`, the JAX package to its Python loop and
    its erode. Hits agree and distances within 1e-3 (tests/test_native.py's
    tolerance against the march); the erosion exactly."""
    assert not tnative.available() or tnative.available() == jnative.available()
    blocked = room(64, 64)
    rng = np.random.default_rng(0)
    x, y = rng.uniform(5, 59, (2, 64)).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    td, th_ = tnative.raycast_batch(blocked, x, y, th, step=0.5, max_dist=60.0)
    jd, jh = jmarch(jnp.asarray(blocked), jnp.asarray(x), jnp.asarray(y), jnp.asarray(th),
                    step=0.5, max_dist=60.0)
    np.testing.assert_array_equal(th_, np.asarray(jh))
    np.testing.assert_allclose(td, np.asarray(jd), atol=1e-3)
    angles = np.linspace(0, 2 * np.pi, 16, endpoint=False).astype(np.float32)
    d, hit = tnative.scan_poses(blocked, [32.0, 40.0], [32.0, 20.0], [0.0, 1.0], angles,
                                max_dist=60.0)
    assert d.shape == hit.shape == (2, 16)
    d1, _ = tnative.raycast_batch(blocked, np.full(16, 32.0), np.full(16, 32.0), angles,
                                  max_dist=60.0)
    np.testing.assert_allclose(d[0], d1, atol=1e-5)
    binary = (rng.random((48, 56)) > 0.3).astype(np.int32)
    np.testing.assert_array_equal(tnative.erode_disc(binary, 3), jmaps.erode(binary, 3))
    pf = tnative.ScanPrefetcher(blocked, angles, max_dist=60.0)
    pf.submit(32.0, 32.0, 0.0)
    d0, _ = pf.get()
    pf.close()
    np.testing.assert_allclose(d0, d[0], atol=1e-5)


def test_load_binary_map_matches_jax(tmp_path):
    from PIL import Image

    g = np.random.default_rng(1).integers(0, 256, (20, 30)).astype(np.uint8)
    path = str(tmp_path / "m.png")
    Image.fromarray(g).save(path)
    got = maps.load_binary_map(path)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jmaps.load_binary_map(path))
    np.testing.assert_array_equal(maps.load_grayscale(path), g)
