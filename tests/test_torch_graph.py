"""The planners' search blocks (`slam_tpu_torch/planners/_graph.py`): on the
card each block is a CUDA graph replay; here, on the CPU, the same block
code runs eagerly through the same solve loops.

  * No host sync inside a block: each block runs under a guard that makes
    every host read of a tensor raise (a sync on the card, which a capture
    cannot hold).
  * The fixed-count sphere trace and march (the blocks' ray form) equal the
    early-exit ones bit for bit.
  * With `max_rounds` inside a block, the block path stops where the JAX
    loop stops: the state equals JAX's `solve` (lattice bit for bit;
    continuous and RRT* to the tolerances of their own tests), the round
    count is JAX's, and every field equals the eager loop's.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import RRTStarConfig as JRRTCfg
from slam_tpu.planners import rrtstar as jrrt
from slam_tpu_torch.core.config import HybridAStarConfig, RaycastConfig, RRTStarConfig
from slam_tpu_torch.core.types import Pose
from slam_tpu_torch.ops import edt as tedt
from slam_tpu_torch.ops import raycast as tray
from slam_tpu_torch.planners import AStar, HybridAStar, RRTStar, _graph
from slam_tpu_torch.planners import astar as tastar
from slam_tpu_torch.planners import hastar as th
from slam_tpu_torch.planners import rrtstar as trrt
from test_planners import wall_map
from test_torch_hastar import A, B, BASE, HA_FIELDS, LAT_FIELDS, WALL, _pair
from test_torch_rrtstar import KW, jax_draws
from test_torch_sdf import MASKS, _rays
from torch_port import np_

RRT_A, RRT_B = (12.0, 32.0), (52.0, 32.0)


class HostSync(RuntimeError):
    pass


def _raise(*_a, **_k):
    raise HostSync("a host read of a tensor inside a search block")


def _host_index(idx) -> bool:
    """An index the C++ side reads on the host: a 0-d integer tensor (made
    a Python int) or a bool mask (`nonzero`)."""
    items = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(i, torch.Tensor) and (i.dtype == torch.bool or i.dim() == 0)
               for i in items)


@contextlib.contextmanager
def no_host_reads():
    """Every host read of a tensor raises inside: `__bool__`, `item`,
    `tolist`, `cpu`, `numpy`, `nonzero`, int / float / index conversion,
    and indexing by a 0-d tensor or a bool mask."""
    get, put = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def checked_get(self, idx):
        if _host_index(idx):
            _raise()
        return get(self, idx)

    def checked_put(self, idx, v):
        if _host_index(idx):
            _raise()
        return put(self, idx, v)

    patches = {name: _raise for name in ("__bool__", "item", "tolist", "cpu", "numpy",
                                         "nonzero", "__int__", "__float__", "__index__")}
    patches.update(__getitem__=checked_get, __setitem__=checked_put)
    saved = {name: torch.Tensor.__dict__.get(name) for name in patches}
    saved_nonzero = torch.nonzero
    try:
        for name, fn in patches.items():
            setattr(torch.Tensor, name, fn)
        torch.nonzero = _raise
        yield
    finally:
        for name, fn in saved.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)
        torch.nonzero = saved_nonzero


def test_guard_catches_host_reads():
    t = torch.arange(4)
    with no_host_reads():
        for read in (lambda: bool(t[0:1].sum()), lambda: t.sum().item(), lambda: t.tolist(),
                     lambda: t[torch.tensor(1)], lambda: t[t > 1], lambda: int(t[0:1].sum())):
            with pytest.raises(HostSync):
                read()
    assert bool(t.sum()) and t[torch.tensor(1)] == 1


def _guarded_cache() -> _graph.Cache:
    cache = _graph.Cache()
    cache.guard = no_host_reads
    return cache


def _continuous(backend: str) -> HybridAStar:
    rc = {"sdf": None, "lut": {"backend": "lut", "step": 1.0, "lut_bins": 90},
          "march": {"backend": "march", "step": 0.5}}[backend]
    cfg = HybridAStarConfig(**{**BASE, "mode": "continuous", "theta_res": 8})
    if rc is None:
        return HybridAStar(WALL, Pose.create(*A), Pose.create(*B), cfg, device="cpu")
    return HybridAStar(WALL, Pose.create(*A), Pose.create(*B), cfg, RaycastConfig(**rc),
                       device="cpu")


@pytest.mark.parametrize("search", ["lattice", "lattice_many", "continuous_sdf",
                                    "continuous_lut", "continuous_march", "rrt_generator",
                                    "rrt_samples", "astar"])
def test_blocks_make_no_host_read(search):
    """Each block runs under `no_host_reads` (the solve loops' own flag reads
    between blocks are outside it) and gives the eager loop's result."""
    cache = _guarded_cache()
    if search.startswith("lattice"):
        p = HybridAStar(WALL, Pose.create(*A), Pose.create(*B), HybridAStarConfig(**BASE),
                        device="cpu")
        if search == "lattice_many":
            q = [(Pose.create(*A), Pose.create(*B)),
                 (Pose.create(10.0, 10.0, 0.0), Pose.create(50.0, 50.0, 0.0))]
            eager = p._solve_many(q, 400, None)
            want = p._fleet_state
            assert p._solve_many(q, 400, cache) == eager
            got = p._fleet_state
        else:
            p._solve(400, None)
            want = p.state
            p.reset_query(Pose.create(*A), Pose.create(*B))
            p._solve(400, cache)
            got = p.state
        fields = LAT_FIELDS
    elif search.startswith("continuous"):
        p = _continuous(search.split("_")[1])
        p._solve(400, None)
        want = p.state
        p.reset_query(Pose.create(*A), Pose.create(*B))
        assert p._solve(400, cache)
        got, fields = p.state, HA_FIELDS
    elif search.startswith("rrt"):
        p = RRTStar(WALL, RRT_A, RRT_B, RRTStarConfig(**KW), seed=5, device="cpu")
        samples = None
        if search == "rrt_samples":
            samples = jax_draws(jax.random.key(3), 120, KW["batch"], WALL.shape)
        p._solve(120, 0, samples, None)
        want = p.state
        p.reset_query(RRT_A, RRT_B, 5)
        assert p._solve(120, 0, samples, cache)
        got, fields = p.state, trrt._RRT_FIELDS
    else:
        free = torch.from_numpy(WALL)
        want = tastar.distance_field(free, (5, 5))
        got = tastar.distance_field(free, (5, 5), cache)
        assert torch.equal(got, want) and cache.blocks
        return
    assert cache.blocks
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


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


def _eager_and_blocks(p, solve):
    """(eager result, block result): each a dict of the state's fields and
    the counters, the same query from a fresh start."""
    out = []
    for graphs in (None, _guarded_cache()):
        p.reset_query(*p._query)
        solve(p, graphs)
        out.append({"state": p.state, "rounds": p.rounds, "launched": p.launched,
                    "host_reads": p.host_reads})
    return out


@pytest.mark.parametrize("mode, max_rounds", [("lattice", 5), ("lattice", 9),
                                              ("continuous", 6), ("continuous", 9)])
def test_hastar_cut_inside_a_block_matches_jax(mode, max_rounds):
    """`max_rounds` ends the search inside a block: the state is JAX's
    `solve(max_rounds)`'s, the rounds the JAX loop's (two a lattice
    iteration), and every field, round and host read the eager loop's;
    the blocks launch whole blocks."""
    over = {} if mode == "lattice" else {"mode": "continuous", "theta_res": 8}
    jp, tp = _pair(WALL, A, B, **over)
    assert not jp.solve(max_rounds)
    tp._query = (Pose.create(*A), Pose.create(*B))
    eager, blocks = _eager_and_blocks(tp, lambda p, g: p._solve(max_rounds, g))
    fields = LAT_FIELDS if mode == "lattice" else HA_FIELDS
    for f in fields:
        assert torch.equal(getattr(blocks["state"], f), getattr(eager["state"], f)), f
    iters = -(-max_rounds // 2) if mode == "lattice" else max_rounds
    assert blocks["rounds"] == eager["rounds"] == (2 * iters if mode == "lattice" else iters)
    assert blocks["host_reads"] == eager["host_reads"]
    assert eager["launched"] == iters
    assert blocks["launched"] == -(-iters // th._FLAG_EVERY) * th._FLAG_EVERY
    st = blocks["state"]
    if mode == "lattice":
        for f in LAT_FIELDS:
            np.testing.assert_array_equal(np_(getattr(st, f)), np_(getattr(jp.state, f)), f)
    else:
        for f in ("parent", "goal_idx", "n_expanded", "start_idx"):
            np.testing.assert_array_equal(np_(getattr(st, f)), np_(getattr(jp.state, f)), f)
        for f in ("g", "px", "py", "pth", "open_f"):
            np.testing.assert_allclose(np_(getattr(st, f)), np_(getattr(jp.state, f)),
                                       rtol=1e-4, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("max_rounds, min_nodes", [(3, 0), (13, 1000)])
def test_rrt_cut_inside_a_block_matches_jax(max_rounds, min_nodes):
    """RRT* with JAX's draws injected and `max_rounds` inside a block: the
    tree is JAX's `solve(max_rounds)`'s (exact topology, coordinates and
    costs to `tests/test_torch_rrtstar.py`'s tolerances), the rounds
    max_rounds, and the block path equals the eager loop; with the
    generator the block path draws for the block's remaining rounds.
    `min_nodes` keeps the search going past its first goal connection, so
    the cut falls in the second block."""
    seed = 3
    jp = jrrt.RRTStar(jnp.asarray(WALL), RRT_A, RRT_B, JRRTCfg(**KW), seed=seed)
    jp.solve(max_rounds=max_rounds, min_nodes=min_nodes)
    size, goal = int(jp.state.size), int(jp.state.best_goal_node)
    assert (goal < 0 or size < min_nodes) and size < KW["max_nodes"]  # cut, not ended
    samples = jax_draws(jax.random.key(seed), max_rounds, KW["batch"], WALL.shape)
    tp = RRTStar(WALL, RRT_A, RRT_B, RRTStarConfig(**KW), seed=seed, device="cpu")
    tp._query = (RRT_A, RRT_B, seed)
    eager, blocks = _eager_and_blocks(tp, lambda p, g: p._solve(max_rounds, min_nodes, samples,
                                                                 g))
    for f in trrt._RRT_FIELDS:
        assert torch.equal(getattr(blocks["state"], f), getattr(eager["state"], f)), f
    assert blocks["rounds"] == eager["rounds"] == max_rounds
    assert blocks["host_reads"] == eager["host_reads"]
    assert blocks["launched"] == -(-max_rounds // trrt._FLAG_EVERY) * trrt._FLAG_EVERY
    st = blocks["state"]
    assert int(st.size) == int(jp.state.size)
    assert int(st.best_goal_node) == int(jp.state.best_goal_node)
    for f in ("parent", "valid"):
        np.testing.assert_array_equal(np_(getattr(st, f)), np_(getattr(jp.state, f)), f)
    for f in ("x", "y"):
        np.testing.assert_allclose(np_(getattr(st, f)), np_(getattr(jp.state, f)), atol=1e-5)
    np.testing.assert_allclose(np_(st.cost), np_(jp.state.cost), rtol=1e-5)
    # The generator: the block path stands the block's remaining draws on.
    gens = []
    for graphs in (None, _graph.Cache()):
        tp.reset_query(RRT_A, RRT_B, seed)
        tp._solve(max_rounds, min_nodes, None, graphs)
        gens.append(tp.generator.get_state())
    tp.reset_query(RRT_A, RRT_B, seed)
    tp._solve(max_rounds, min_nodes, None, None)
    for _ in range(-max_rounds % trrt._FLAG_EVERY):
        tp._draw(None, 0)
    assert torch.equal(tp.generator.get_state(), gens[1])
    assert not torch.equal(gens[0], gens[1]) or max_rounds % trrt._FLAG_EVERY == 0


def test_cache_keys_and_reset():
    """A query reuses the map's blocks; `reset` (a new map) drops them; an
    AStar keeps a cache only on the card."""
    cfg = HybridAStarConfig(**BASE)
    p = HybridAStar(WALL, Pose.create(*A), Pose.create(*B), cfg, device="cpu")
    p._solve(400, p._graphs)
    blocks = dict(p._graphs.blocks)
    assert {k[0] for k in blocks} == {"astar", "lattice"}
    p.reset_query(Pose.create(10.0, 10.0, 0.0), Pose.create(50.0, 50.0, 0.0))
    p._solve(400, p._graphs)
    assert all(p._graphs.blocks[k] is v for k, v in blocks.items())
    p.reset(wall_map(64, 64, gap=(20, 30)), Pose.create(*A), Pose.create(*B))
    assert not p._graphs.blocks and p._card_graphs is None
    assert AStar(WALL, (5, 5), (60, 60), device="cpu")._graphs is None
