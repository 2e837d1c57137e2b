"""slam_tpu_torch/entry.py, the port's top-level entry points, against
__graft_entry__.py: `entry()`'s configuration, scan and one step from
JAX's state with JAX's draws injected; the step through its block
(`StepGraphs`) against the free step; and `dryrun_multichip` over worlds
of 1 and 4 gloo ranks on the CPU, whose lattice HA* results must equal
JAX's unsharded `HybridAStar.solve_many` on the same room and queries.

Tolerances: the scan 1e-5; the step at tests/test_torch_slam.py's (poses
1e-3 px / rad, log weights rtol 1e-5 / atol 1e-2 on the particles that
agree, the grid 1e-6); the block route bit for bit; HA* exact."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as graft
from slam_tpu.core.config import HybridAStarConfig as JHACfg
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models.simulate import synthetic_room
from slam_tpu.planners import HybridAStar as JHybridAStar
from slam_tpu_torch import entry as tentry
from slam_tpu_torch.models._graph import StepGraphs
from slam_tpu_torch.utils import convert
from torch_port import assert_angles_close, jax_noise, np_, t_pose

WORLDS = (1, 4)


@pytest.fixture(scope="module")
def dryruns():
    """The port's dryrun worlds, run while the JAX side computes; then
    JAX's unsharded solve_many of the largest world's queries."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        runs = pool.submit(lambda: {n: tentry.dryrun_multichip(n, device="cpu") for n in WORLDS})
        n = max(WORLDS)
        hcfg = JHACfg(velocity=4.0, theta_res=24, branching_factor=3, tol=4.0, batch=32,
                      max_rounds=256, mode="lattice")
        planner = JHybridAStar(jnp.asarray(~synthetic_room(64, 64)), JPose.create(12.0, 32.0, 0.0),
                               JPose.create(52.0, 32.0, 0.0), hcfg)
        queries = [(JPose.create(12.0, 20.0 + 3.0 * q, 0.0), JPose.create(52.0, 32.0, 0.0))
                   for q in range(n)]
        want = planner.solve_many(queries)
        return runs.result(), want


def test_entry_config_and_scan_match_jax():
    jcfg, jpose, jscan, jodom = graft._tiny_setup(256, 32)
    fn, (state, odom, scan) = tentry.entry(device="cpu")
    tcfg = tentry.tiny_setup(256, 32, device="cpu")[0]
    for name, sub in dataclasses.asdict(jcfg).items():
        got = getattr(tcfg, name)
        if isinstance(sub, dict):
            for k, v in sub.items():
                assert getattr(got, k) == v, f"cfg.{name}.{k}: {getattr(got, k)} != {v}"
        else:
            assert got == sub, f"cfg.{name}: {got} != {sub}"
    assert state.mcl.particles.n == 256 and state.grid.shape == (64, 64)
    np.testing.assert_allclose(np_(scan.angles), np.asarray(jscan.angles), atol=1e-5)
    np.testing.assert_allclose(np_(scan.dists), np.asarray(jscan.dists), atol=1e-5)
    for f in ("rot1", "trans", "rot2"):
        assert float(getattr(odom, f)) == float(getattr(jodom, f))
    for f in ("x", "y", "theta"):
        assert float(getattr(state.est_pose, f)) == float(getattr(jpose, f))


def _assert_pose_close(tp, jp, atol):
    np.testing.assert_allclose(np_(tp.x), np.asarray(jp.x), rtol=1e-6, atol=atol)
    np.testing.assert_allclose(np_(tp.y), np.asarray(jp.y), rtol=1e-6, atol=atol)
    assert_angles_close(np_(tp.theta), np.asarray(jp.theta), atol=atol)


def test_entry_step_matches_jax():
    """One step of `entry()`'s step_fn from JAX's example state (carried
    across by `utils/convert.slam_state`) with JAX's motion noise and
    resampler uniform injected, against `jax.jit(fn)(*args)`."""
    jfn, (js, jodom, jscan) = graft.entry()
    js1 = jax.jit(jfn)(js, jodom, jscan)
    fn, (_, odom, scan) = tentry.entry(device="cpu")
    m, n = js.mcl, js.mcl.particles.n
    key, sub = jax.random.split(m.key)
    _, k_rs, _ = jax.random.split(key, 3)
    p = m.particles
    ts = convert.slam_state(
        np.asarray(js.grid), None, convert.particles(p.pose.x, p.pose.y, p.pose.theta,
                                                     p.log_weight),
        t_pose(m.best_pose), t_pose(m.mode_pose), t_pose(js.est_pose), int(m.step),
        int(m.updates), seed=0)
    ts1 = fn(ts, odom, scan, noise=jax_noise(sub, (n,)),
             u0=convert.tensor(jax.random.uniform(k_rs, ())))
    for tp, jp in ((ts1.mcl.best_pose, js1.mcl.best_pose), (ts1.mcl.mode_pose, js1.mcl.mode_pose),
                   (ts1.est_pose, js1.est_pose)):
        _assert_pose_close(tp, jp, 1e-3)
    tpp, jpp = ts1.mcl.particles, js1.mcl.particles
    close = (np.isclose(np_(tpp.pose.x), np.asarray(jpp.pose.x), rtol=1e-6, atol=1e-3)
             & np.isclose(np_(tpp.pose.y), np.asarray(jpp.pose.y), rtol=1e-6, atol=1e-3))
    assert close.mean() >= 0.995, f"{(~close).sum()} particles differ"
    np.testing.assert_allclose(np_(tpp.log_weight)[close], np.asarray(jpp.log_weight)[close],
                               rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(np_(ts1.grid), np.asarray(js1.grid), rtol=0, atol=1e-6)
    assert (ts1.mcl.step, ts1.mcl.updates) == (int(js1.mcl.step), int(js1.mcl.updates))


def test_entry_block_route_equals_free_step():
    """`StepGraphs().run(step_fn, ...)` (a CUDA graph on the card, the same
    block code here) == step_fn bit for bit, over two chained steps from
    cloned states."""
    fn, args = tentry.entry(device="cpu")
    graphs = StepGraphs()
    a, b = tentry.clone_state(args[0]), tentry.clone_state(args[0])
    for _ in range(2):
        a = graphs.run(fn, a, args[1], args[2])
        b = fn(b, args[1], args[2])
        assert tentry.state_difference(a, b) is None
    assert a.mcl.updates == 2 and len(graphs.cache.blocks) == 1


@pytest.mark.parametrize("n", WORLDS)
def test_dryrun_multichip_matches_jax_hastar(dryruns, n):
    """Every rank exits 0 (`dryrun_multichip` raises otherwise) with finite
    states in every layout the world's mesh allows, and the HA* (success,
    cost) of the queries spread over 'p' equal JAX's unsharded solve."""
    runs, want = dryruns
    got = runs[n]
    assert len(got["ranks"]) == n
    layouts = {"sharded_slam", "mapsharded_slam", "sharded_slam_table", "sharded_fleet"}
    if n % 2 == 0:
        layouts.add("mapsharded_slam_table128")
    for r in got["ranks"]:
        assert set(r["finite"]) == layouts and all(r["finite"].values()), r
        assert r["backend"] == "gloo" and r["beam_axis"] == (2 if n % 2 == 0 else 1)
        assert [tuple(v) for v in r["hastar"]] == got["hastar"]
    assert got["hastar"] == [(bool(s), float(c)) for s, c in want[:n]]
