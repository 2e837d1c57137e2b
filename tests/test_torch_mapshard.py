"""slam_tpu_torch.parallel's map-block sharding at D = 2 and 4 ranks over
gloo, against the JAX package's replicated functions (the counterparts of
tests/test_mapshard.py): the block march, the row-window march, the
block-local mapping scatter, the halo-exchanged JFA and capped EDT and
their refusals, the LF window and the direct LF, the map-sharded SLAM
tiers and the engine's four refusals.

One world per rank count (tests/torch_parallel_worker.py, suite
"mapshard"); the JAX references are its replicated (single-device)
functions, which tests/test_mapshard.py holds JAX's sharded ones to.
Tolerances: bit for bit for the EDTs, the LF window and the march's hit
flags (its distances rtol 1e-6, as JAX's test); the mapping scatter
atol 1e-6 (tests/test_torch_mapping.py); the SLAM steps the JAX test's
(grid atol 1e-5, poses rtol 1e-4, log weights 1e-4).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import LidarConfig, MapConfig, MCLConfig, MotionConfig
from slam_tpu.core.config import RaycastConfig, SLAMConfig
from slam_tpu.core.types import Odometry as JOdometry
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.models import slam as jslam
from slam_tpu.models.simulate import synthetic_room
from slam_tpu.ops import mapping as jmapping
from slam_tpu.ops.edt import edt_capped as jedt_capped
from slam_tpu.ops.edt import edt_jfa as jedt_jfa
from slam_tpu.ops.measurement import lf_log_score_field as jlf_score
from slam_tpu.ops.measurement import particle_log_weights_likelihood_field as jlf_direct
from slam_tpu.ops.raycast import raycast_march as jmarch
from slam_tpu.ops.rayfield import RayField as JRayField
from slam_tpu_torch.ops.measurement import lf_log_score_field as tlf_score
from slam_tpu_torch.ops.raycast import raycast_march as tmarch
from torch_port import D, draws, start_worlds

H = W = 64
N = 64
EDT_CASES = ((0.03, 7.0), (0.2, 12.0), (0.0, 7.0))


def _cfg(size=H, measurement="beam", box=None, backend="march"):
    return SLAMConfig(
        mcl=MCLConfig(n_particles=N, meas_stddev=3.0, measurement=measurement,
                      lf_table_box=box),
        map=MapConfig(height=size, width=size),
        lidar=LidarConfig(n_rays=16, max_dist=60.0),
        motion=MotionConfig(alphas=(1e-3, 1e-3, 1e-3, 1e-3)),
        raycast=RaycastConfig(step=1.0, max_dist=60.0, chunk=16, backend=backend),
    )


SLAM_CASES = (("beam", H, "beam", None, "march", 2),
              ("lf", 128, "likelihood_field", None, "sdf", 3),
              ("lft", 128, "likelihood_field_table", 32, "sdf", 3))


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    blocked = synthetic_room(H, W)
    cfg = _cfg()
    mapscan = jfake.scan(jnp.asarray(blocked), JPose.create(30.0, 30.0, 0.8), cfg.lidar,
                         cfg.raycast)
    inp = {"blocked": blocked,
           "rays.x": rng.uniform(-4, W + 4, 256).astype(np.float32),
           "rays.y": rng.uniform(-4, H + 4, 256).astype(np.float32),
           "rays.th": rng.uniform(-7, 7, 256).astype(np.float32),
           "mapscan.angles": np.asarray(mapscan.angles),
           "mapscan.dists": np.asarray(mapscan.dists),
           "edt.cases": np.array(len(EDT_CASES))}
    for k, (density, cap) in enumerate(EDT_CASES):
        inp[f"edt.blocked{k}"] = rng.random((96, 80)) < density
        inp[f"edt.cap{k}"] = np.array(cap)
    jfa = jax.jit(jedt_jfa, static_argnames=("max_dist",))
    lfw_blocked = jnp.asarray(rng.random((96, 80)) < 0.05)
    inp["lfw.edt"] = np.asarray(jfa(lfw_blocked, max_dist=12.0))
    inp["lfw.pad"] = np.array(int(math.ceil(30.0)) + 1)
    inp["dlf.edt"] = np.asarray(jfa(jnp.asarray(blocked), max_dist=5.0 * 3.0 + 2.0))
    inp["dlf.x"] = rng.uniform(-5, W + 5, 32).astype(np.float32)
    inp["dlf.y"] = rng.uniform(-5, H + 5, 32).astype(np.float32)
    inp["dlf.th"] = rng.uniform(-4, 4, 32).astype(np.float32)
    key = jax.random.key(0)
    for k in range(3):
        inp[f"ms.noise{k}"], inp[f"ms.u0{k}"], key = draws(key, N)
    scans = {}
    for name, size, meas, box, backend, _ in SLAM_CASES:
        c = _cfg(size, meas, box, backend)
        scans[name] = jfake.scan(jnp.asarray(synthetic_room(size, size)),
                                 JPose.create(size / 2.0, size / 2.0, np.pi / 2), c.lidar,
                                 c.raycast)
        inp[f"ms.{name}.scan.angles"] = np.asarray(scans[name].angles)
        inp[f"ms.{name}.scan.dists"] = np.asarray(scans[name].dists)
    wait = start_worlds("mapshard", inp)

    ref = {"inp": inp}
    ref["march"] = jmarch(jnp.asarray(blocked), inp["rays.x"], inp["rays.y"], inp["rays.th"],
                          step=0.7, max_dist=90.0)
    ref["mapping"] = jmapping.scan_logodds_update(
        jnp.zeros((H, W), jnp.float32), JPose.create(30.0, 30.0, 0.8), mapscan,
        scanner_offset=cfg.mcl.scanner_offset, step=cfg.raycast.step,
        max_dist=cfg.raycast.max_dist, l_occ=cfg.map.l_occ, l_free=cfg.map.l_free,
        l_min=cfg.map.l_min, l_max=cfg.map.l_max)
    capped = jax.jit(jedt_capped, static_argnames=("max_dist",))
    for k, (_, cap) in enumerate(EDT_CASES):
        b = jnp.asarray(inp[f"edt.blocked{k}"])
        ref[f"jfa{k}"] = jfa(b, max_dist=cap)
        ref[f"capped{k}"] = capped(b, max_dist=cap)
    ref["dlf"] = jlf_direct(
        JRayField(blocked=jnp.asarray(blocked), edt=jnp.asarray(inp["dlf.edt"])),
        JPose.create(inp["dlf.x"], inp["dlf.y"], inp["dlf.th"]), mapscan, rc=cfg.raycast,
        scanner_offset=cfg.mcl.scanner_offset, stddev=cfg.mcl.meas_stddev)
    for name, size, meas, box, backend, steps in SLAM_CASES:
        c = _cfg(size, meas, box, backend)
        step = jax.jit(lambda s, o, z, c=c: jslam.step(s, o, z, c))
        js = jslam.init(jax.random.key(0), c, JPose.create(size / 2.0, size / 2.0, np.pi / 2))
        for _ in range(steps):
            js = step(js, JOdometry.create(0.05, 1.5, 0.05), scans[name])
        ref[f"ms.{name}"] = js
    return ref, wait()


@pytest.mark.parametrize("d", D)
def test_block_sharded_march_matches_replicated(run, d):
    ref, out = run
    d0, h0 = ref["march"]
    for o in out[d]:
        np.testing.assert_array_equal(o["march.hit"], np.asarray(h0))
        np.testing.assert_allclose(o["march.dist"], np.asarray(d0), rtol=1e-6)


def test_row_window_march_composes():
    """The op-level contract, on one process: the min over row-block
    marches equals the full march, in the port and in JAX."""
    blocked = synthetic_room(H, W)
    xs = np.asarray([10.0, 30.0, 50.0], np.float32)
    ys = np.asarray([10.0, 30.0, 50.0], np.float32)
    ths = np.asarray([0.3, 2.0, -1.7], np.float32)
    d0, h0 = tmarch(torch.from_numpy(blocked.copy()), xs, ys, ths, step=0.5, max_dist=80.0)
    lh = H // 4
    dmin = torch.full_like(d0, 80.0)
    for b in range(4):
        blk = torch.from_numpy(blocked[b * lh:(b + 1) * lh].copy())
        d, hh = tmarch(blk, xs, ys, ths, step=0.5, max_dist=80.0, row_offset=b * lh, full_h=H)
        jd, jh = jmarch(jnp.asarray(blocked[b * lh:(b + 1) * lh]), xs, ys, ths, step=0.5,
                        max_dist=80.0, row_offset=b * lh, full_h=H)
        np.testing.assert_array_equal(hh.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        dmin = torch.minimum(dmin, torch.where(hh, d, 80.0))
    np.testing.assert_allclose(torch.where(h0, d0, 80.0).numpy(), dmin.numpy(), rtol=1e-6)


@pytest.mark.parametrize("d", D)
def test_sharded_mapping_scatter_matches(run, d):
    ref, out = run
    np.testing.assert_allclose(out[d][0]["mapping.grid"], np.asarray(ref["mapping"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("d", D)
@pytest.mark.parametrize("kind", ["jfa", "capped"])
def test_sharded_edt_matches_replicated(run, d, kind):
    """The halo-exchanged JFA and capped EDT equal the replicated transforms
    bit for bit, map-edge blocks and the no-seed sentinel included."""
    ref, out = run
    for k in range(len(EDT_CASES)):
        np.testing.assert_array_equal(out[d][0][f"edt.{kind}{k}"], np.asarray(ref[f"{kind}{k}"]),
                                      err_msg=f"case {EDT_CASES[k]}")


@pytest.mark.parametrize("d", D)
@pytest.mark.parametrize("kind", ["jfa", "capped"])
def test_sharded_edt_rejects_small_blocks(run, d, kind):
    _, out = run
    for o in out[d]:
        assert "block height" in str(o[f"refuse.{kind}"])


@pytest.mark.parametrize("d", D)
def test_sharded_lf_window_matches_replicated_box_build(run, d):
    """lf_window_sharded assembles the padded score window of the replicated
    box build (`lf_score_table`'s origin branch), the off-map floor ring
    included: bit for bit from the port's per-cell score, and within
    JAX's per-cell score's ulp (the CPU's log and exp round apart)."""
    ref, out = run
    inp = ref["inp"]
    h, w = inp["lfw.edt"].shape
    pad, si, i0, j0 = int(inp["lfw.pad"]), 24, 5, 60
    floor_val = np.float32(math.log(max(0.05 / 30.0, 1e-30)))
    rows = i0 - pad + np.arange(si + 2 * pad)
    cols = j0 - pad + np.arange(si + 2 * pad)
    inside = ((rows >= 0) & (rows < h))[:, None] & ((cols >= 0) & (cols < w))[None, :]
    lf = dict(stddev=2.0, z_hit=0.95, z_rand=0.05, max_dist=30.0)
    for score, exact in ((tlf_score(torch.tensor(inp["lfw.edt"]), **lf).numpy(), True),
                         (np.asarray(jlf_score(jnp.asarray(inp["lfw.edt"]), **lf)), False)):
        core = score[np.clip(rows, 0, h - 1)][:, np.clip(cols, 0, w - 1)]
        want = np.where(inside, core, floor_val)
        for o in out[d]:
            if exact:
                np.testing.assert_array_equal(o["lfw.window"], want)
            else:
                np.testing.assert_allclose(o["lfw.window"], want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", D)
def test_sharded_direct_lf_matches_replicated(run, d):
    ref, out = run
    np.testing.assert_allclose(out[d][0]["dlf.lw"], np.asarray(ref["dlf"]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", D)
@pytest.mark.parametrize("name", [c[0] for c in SLAM_CASES])
def test_map_sharded_slam_tiers_match_single_device(run, d, name):
    """MapShardedGridSLAM's march, direct LF and boxed-table tiers against
    the replicated JAX step with its draws injected; the grid is held in
    row blocks of H / 2 (the mesh is (D / 2) x 2)."""
    ref, out = run
    o, j = out[d][0], ref[f"ms.{name}"]
    np.testing.assert_allclose(o[f"ms.{name}.grid"], np.asarray(j.grid), atol=1e-5)
    np.testing.assert_allclose(o[f"ms.{name}.x"], np.asarray(j.mcl.particles.pose.x), rtol=1e-4)
    np.testing.assert_allclose(o[f"ms.{name}.lw"], np.asarray(j.mcl.particles.log_weight),
                               rtol=1e-4, atol=1e-4)
    size = j.grid.shape[0]
    assert int(o[f"ms.{name}.block_rows"]) == size // 2
    assert int(o[f"ms.{name}.n_local"]) == N * 2 // d


@pytest.mark.parametrize("d", D)
@pytest.mark.parametrize("what,match", [
    ("scanmatch", "scanmatch"), ("auto", "likelihood_field_auto"),
    ("nobox", "lf_table_box"), ("edt_box", "edt_box")])
def test_map_sharded_refusals(run, d, what, match):
    """JAX's four refusals, word for word."""
    _, out = run
    assert match in str(out[d][0][f"refuse.{what}"])
