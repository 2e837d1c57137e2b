"""The planners' search chains (`slam_tpu_torch/planners/_graph.py`): on the
card each run of a chain is a CUDA graph replay; here, on the CPU, the
same block code runs eagerly through the same host loop.

  * No host sync inside a block: each block runs under a guard that makes
    every host read of a tensor raise (a sync on the card, which a capture
    cannot hold).
  * The fixed-count sphere trace and march (the blocks' ray form) equal the
    early-exit ones bit for bit.
  * Each search equals the JAX package's (lattice and A* bit for bit;
    continuous and RRT* to the tolerances of their own tests), also with
    `max_rounds` inside a block, where the rounds are JAX's and the chain
    launches, and draws for, whole blocks.
  * Each case runs with chains of one block a run (every block its own
    run, the host loop going on between them) and with the modules' own
    `_CHAIN_RUNS`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import RRTStarConfig as JRRTCfg
from slam_tpu.core.types import Pose as JPose
from slam_tpu.planners import astar as jastar
from slam_tpu.planners import rrtstar as jrrt
from slam_tpu_torch.core.config import HybridAStarConfig, RRTStarConfig
from slam_tpu_torch.core.types import Pose
from slam_tpu_torch.ops import edt as tedt
from slam_tpu_torch.ops import raycast as tray
from slam_tpu_torch.planners import AStar, HybridAStar, RRTStar, _graph
from slam_tpu_torch.planners import astar as tastar
from slam_tpu_torch.planners import hastar as th
from slam_tpu_torch.planners import rrtstar as trrt
from test_planners import wall_map
from test_torch_hastar import A, B, BASE, LAT_FIELDS, WALL, _pair
from test_torch_rrtstar import KW, jax_draws
from test_torch_sdf import MASKS, _rays
from torch_port import HostSync, no_host_reads, np_

RRT_A, RRT_B = (12.0, 32.0), (52.0, 32.0)
CONTINUOUS_RC = {"sdf": None, "lut": {"backend": "lut", "step": 1.0, "lut_bins": 90},
                 "march": {"backend": "march", "step": 0.5}}
LATTICE_MANY = [(A, B), ((10.0, 10.0, 0.0), (50.0, 50.0, 0.0))]
# Chain lengths: one block a run, and each module's own `_CHAIN_RUNS`.
RUNS = ["one", "default"]
_DEFAULT_RUNS = {mod: mod._CHAIN_RUNS for mod in (tastar, th, trrt)}


def chain_runs(monkeypatch, runs: str) -> None:
    """Set every planner module's chain length: 1 with `runs` "one", its
    own with "default"."""
    for mod, n in _DEFAULT_RUNS.items():
        monkeypatch.setattr(mod, "_CHAIN_RUNS", 1 if runs == "one" else n)


def test_guard_catches_host_reads():
    t = torch.arange(4)
    with no_host_reads():
        for read in (lambda: bool(t[0:1].sum()), lambda: t.sum().item(), lambda: t.tolist(),
                     lambda: t[torch.tensor(1)], lambda: t[t > 1], lambda: int(t[0:1].sum())):
            with pytest.raises(HostSync):
                read()
    assert bool(t.sum()) and t[torch.tensor(1)] == 1


def _continuous(backend: str):
    """The (JAX, port) continuous-mode planners of the wall-gap query with
    the `backend` edge checks; the port's blocks run under the guard."""
    jp, tp = _pair(WALL, A, B, CONTINUOUS_RC[backend], mode="continuous", theta_res=8)
    tp._graphs.guard = no_host_reads
    return jp, tp


@functools.cache
def _jax_search(search: str):
    """JAX's (answer, state or field) of `search` as
    `test_blocks_make_no_host_read` runs it."""
    if search == "lattice_many":
        jp, _ = _pair(WALL, A, B)
        return jp.solve_many([(JPose.create(*a), JPose.create(*b)) for a, b in LATTICE_MANY],
                             400), jp._fleet_state
    if search == "lattice":
        jp, _ = _pair(WALL, A, B)
        return jp.solve(400), jp.state
    if search.startswith("continuous"):
        jp, _ = _continuous(search.split("_")[1])
        return jp.solve(400), jp.state
    if search == "rrt_samples":
        jp = jrrt.RRTStar(jnp.asarray(WALL), RRT_A, RRT_B, JRRTCfg(**KW), seed=3)
        return jp.solve(max_rounds=120), jp.state
    return None, jastar.distance_field(jnp.asarray(WALL), jnp.asarray((5, 5), jnp.int32))


def _assert_close_ha(st, jst):
    """A continuous state to JAX's: the integer fields equal, the poses and
    costs to 1e-4 (sin / cos / atan2 ulps between XLA:CPU and torch)."""
    for f in ("parent", "goal_idx", "n_expanded", "start_idx"):
        np.testing.assert_array_equal(np_(getattr(st, f)), np_(getattr(jst, f)), f)
    for f in ("g", "px", "py", "pth", "open_f"):
        np.testing.assert_allclose(np_(getattr(st, f)), np_(getattr(jst, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)


def _assert_close_rrt(st, jst):
    """A tree to JAX's: exact topology, coordinates and costs to
    `tests/test_torch_rrtstar.py`'s tolerances."""
    assert int(st.size) == int(jst.size)
    assert int(st.best_goal_node) == int(jst.best_goal_node)
    for f in ("parent", "valid"):
        np.testing.assert_array_equal(np_(getattr(st, f)), np_(getattr(jst, f)), f)
    for f in ("x", "y"):
        np.testing.assert_allclose(np_(getattr(st, f)), np_(getattr(jst, f)), atol=1e-5)
    np.testing.assert_allclose(np_(st.cost), np_(jst.cost), rtol=1e-5)


def _whole_blocks_of_draws(seed: int, rounds: int) -> torch.Tensor:
    """The state of a generator seeded `seed` after the draws of the whole
    blocks that hold `rounds` rounds."""
    g = torch.Generator().manual_seed(seed)
    for _ in range(-(-rounds // trrt._FLAG_EVERY) * trrt._FLAG_EVERY):
        trrt._uniform_draw(g, WALL.shape, KW["batch"], "cpu")
    return g.get_state()


@pytest.mark.parametrize("runs", RUNS)
@pytest.mark.parametrize("search", ["lattice", "lattice_many", "continuous_sdf",
                                    "continuous_lut", "continuous_march", "rrt_generator",
                                    "rrt_samples", "astar"])
def test_blocks_make_no_host_read(search, runs, monkeypatch):
    """Each block runs under `no_host_reads` (the host loop's reads between
    blocks are outside it) and the search gives JAX's result. The RRT*
    that draws from its generator gives the tree of eager `pathfind`
    rounds from the same generator, which then stands the last block's
    remaining draws further."""
    chain_runs(monkeypatch, runs)
    answer, want = _jax_search(search)
    if search.startswith("lattice"):
        p = HybridAStar(WALL, Pose.create(*A), Pose.create(*B), HybridAStarConfig(**BASE),
                        device="cpu")
        p._graphs.guard = no_host_reads
        if search == "lattice_many":
            assert p.solve_many([(Pose.create(*a), Pose.create(*b)) for a, b in LATTICE_MANY],
                                400) == answer
            got = p._fleet_state
        else:
            assert answer and p.solve(400) == answer
            got = p.state
        for f in LAT_FIELDS:
            np.testing.assert_array_equal(np_(getattr(got, f)), np_(getattr(want, f)), f)
    elif search.startswith("continuous"):
        _, p = _continuous(search.split("_")[1])
        assert answer and p.solve(400) == answer
        _assert_close_ha(p.state, want)
    elif search.startswith("rrt"):
        p = RRTStar(WALL, RRT_A, RRT_B, RRTStarConfig(**KW), seed=5, device="cpu")
        p._graphs.guard = no_host_reads
        if search == "rrt_samples":
            samples = jax_draws(jax.random.key(3), 120, KW["batch"], WALL.shape)
            assert answer and p.solve(120, 0, samples) == answer
            _assert_close_rrt(p.state, want)
        else:
            assert p.solve(120, 0)
            q = RRTStar(WALL, RRT_A, RRT_B, RRTStarConfig(**KW), seed=5, device="cpu")
            while not q.pathfind():
                pass
            assert q.success and q.rounds == p.rounds
            for f in trrt._RRT_FIELDS:
                assert torch.equal(getattr(p.state, f), getattr(q.state, f)), f
            assert torch.equal(p.generator.get_state(), _whole_blocks_of_draws(5, p.rounds))
    else:
        p = AStar(WALL, (5, 5), (60, 60), device="cpu")
        p._graphs.guard = no_host_reads
        got = tastar.distance_field(p.free, (5, 5), p._graphs)
        np.testing.assert_array_equal(np_(got).view(np.int32), np.asarray(want).view(np.int32))
    copies = {k[-1] for k in p._graphs.blocks}
    assert copies and (copies == {1}) == (runs == "one")


@pytest.mark.parametrize("margin", [1.0, 1.5])
@pytest.mark.parametrize("name", ["room", "random", "dense", "single"])
def test_fixed_count_sphere_trace_is_bitwise(name, margin):
    """All `max_iters` iterations with no read == the early-exit trace, on
    `tests/test_torch_sdf.py`'s rays; the march likewise over every chunk."""
    blocked = MASKS[name]
    edt = tedt.edt_exact(torch.from_numpy(blocked))
    x, y, theta = (torch.from_numpy(v) for v in _rays(blocked, 3000, 3))
    kw = dict(step=0.5, max_dist=80.0, margin=margin)
    d0, h0 = tray.raycast_sdf(edt, x, y, theta, **kw)
    with no_host_reads():
        d1, h1 = tray.raycast_sdf(edt, x, y, theta, early_exit=False, **kw)
    assert torch.equal(d0.view(torch.int32), d1.view(torch.int32)) and torch.equal(h0, h1)
    b = torch.from_numpy(blocked)
    m0, k0 = tray.raycast_march(b, x, y, theta, step=0.5, max_dist=80.0, chunk=16)
    with no_host_reads():
        m1, k1 = tray.raycast_march(b, x, y, theta, step=0.5, max_dist=80.0, chunk=16,
                                    early_exit=False)
    assert torch.equal(m0.view(torch.int32), m1.view(torch.int32)) and torch.equal(k0, k1)


@pytest.mark.parametrize("runs", RUNS)
@pytest.mark.parametrize("mode, max_rounds", [("lattice", 5), ("lattice", 9),
                                              ("continuous", 6), ("continuous", 9)])
def test_hastar_cut_inside_a_block_matches_jax(mode, max_rounds, runs, monkeypatch):
    """`max_rounds` ends the search inside a block: the state is JAX's
    `solve(max_rounds)`'s and the rounds the JAX loop's (two a lattice
    iteration); the chain launches whole blocks and the host reads once a
    run of the chain, and once for the result."""
    chain_runs(monkeypatch, runs)
    over = {} if mode == "lattice" else {"mode": "continuous", "theta_res": 8}
    jp, tp = _pair(WALL, A, B, **over)
    assert not jp.solve(max_rounds)
    tp._graphs.guard = no_host_reads
    assert not tp.solve(max_rounds)
    iters = -(-max_rounds // 2) if mode == "lattice" else max_rounds
    blocks = -(-iters // th._FLAG_EVERY)
    assert tp.rounds == (2 * iters if mode == "lattice" else iters)
    assert tp.launched == blocks * th._FLAG_EVERY
    assert tp.host_reads == -(-blocks // th._CHAIN_RUNS) + 1
    if mode == "lattice":
        for f in LAT_FIELDS:
            np.testing.assert_array_equal(np_(getattr(tp.state, f)), np_(getattr(jp.state, f)),
                                          f)
    else:
        _assert_close_ha(tp.state, jp.state)


@pytest.mark.parametrize("runs", RUNS)
@pytest.mark.parametrize("max_rounds, min_nodes", [(3, 0), (13, 1000)])
def test_rrt_cut_inside_a_block_matches_jax(max_rounds, min_nodes, runs, monkeypatch):
    """RRT* with JAX's draws injected and `max_rounds` inside a block: the
    tree is JAX's `solve(max_rounds)`'s and the rounds max_rounds; the
    chain launches whole blocks, one host read a run of it. With the
    generator the chain draws for the last block's remaining rounds, at
    either chain length. `min_nodes` keeps the search going past its first
    goal connection, so the cut falls in the second block."""
    chain_runs(monkeypatch, runs)
    seed = 3
    jp = jrrt.RRTStar(jnp.asarray(WALL), RRT_A, RRT_B, JRRTCfg(**KW), seed=seed)
    jp.solve(max_rounds=max_rounds, min_nodes=min_nodes)
    size, goal = int(jp.state.size), int(jp.state.best_goal_node)
    assert (goal < 0 or size < min_nodes) and size < KW["max_nodes"]  # cut, not ended
    samples = jax_draws(jax.random.key(seed), max_rounds, KW["batch"], WALL.shape)
    tp = RRTStar(WALL, RRT_A, RRT_B, RRTStarConfig(**KW), seed=seed, device="cpu")
    tp._graphs.guard = no_host_reads
    tp.solve(max_rounds, min_nodes, samples)
    blocks = -(-max_rounds // trrt._FLAG_EVERY)
    assert tp.rounds == max_rounds
    assert tp.launched == blocks * trrt._FLAG_EVERY
    assert tp.host_reads == -(-blocks // trrt._CHAIN_RUNS) + 3
    _assert_close_rrt(tp.state, jp.state)
    gens = []
    for r in (runs, "default" if runs == "one" else "one"):
        chain_runs(monkeypatch, r)
        tp.reset_query(RRT_A, RRT_B, seed)
        tp.solve(max_rounds, min_nodes)
        gens.append(tp.generator.get_state())
    assert torch.equal(gens[0], gens[1])
    assert torch.equal(gens[0], _whole_blocks_of_draws(seed, max_rounds))


def test_cache_keys_and_reset():
    """A query reuses the map's chains; `reset` (a new map) drops them; an
    AStar holds a cache on every device."""
    cfg = HybridAStarConfig(**BASE)
    p = HybridAStar(WALL, Pose.create(*A), Pose.create(*B), cfg, device="cpu")
    p.solve(400)
    blocks = dict(p._graphs.blocks)
    assert {k[0] for k in blocks} == {"astar", "lattice"}
    p.reset_query(Pose.create(10.0, 10.0, 0.0), Pose.create(50.0, 50.0, 0.0))
    p.solve(400)
    assert all(p._graphs.blocks[k] is v for k, v in blocks.items())
    p.reset(wall_map(64, 64, gap=(20, 30)), Pose.create(*A), Pose.create(*B))
    assert not p._graphs.blocks
    q = AStar(WALL, (5, 5), (60, 60), device="cpu")
    q.solve()
    assert {k[0] for k in q._graphs.blocks} == {"astar"}
