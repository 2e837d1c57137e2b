"""slam_tpu_torch.planners.hastar against slam_tpu.planners.hastar.

Lattice mode (the suite default) is held bit for bit: the tables, the
feasibility words, one round from carried JAX state, whole searches (the
packed words, the ring, every counter and the recovered path), fleets and
ring overflow. Its arithmetic is integer, min-based, or f32 products by
1/64 (exact, so an FMA changes nothing). Continuous mode runs sin / cos /
tan / atan2, which may differ by an ulp between XLA:CPU and torch: it is
held to the same success and goal, a feasible path, cost within 1e-4 and
poses within 1e-4."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import HybridAStarConfig as JCfg
from slam_tpu.core.config import RaycastConfig as JRaycast
from slam_tpu.core.types import Pose as JPose
from slam_tpu.planners import hastar as jh
from slam_tpu_torch.core.config import HybridAStarConfig, RaycastConfig
from slam_tpu_torch.core.types import Pose
from slam_tpu_torch.planners import HybridAStar
from slam_tpu_torch.planners import hastar as th
from slam_tpu_torch.planners._scatter import set_drop, set_drop_, with_spare
from slam_tpu_torch.utils import convert
from test_planners import wall_map
from torch_port import np_

BASE = dict(velocity=4.0, length=4.0 / math.tan(40 * math.pi / 180) * 2, theta_res=12,
            branching_factor=3, tol=4.0, batch=64, mode="lattice")
LAT_FIELDS = [f.name for f in dataclasses.fields(th.LatticeState)]
HA_FIELDS = [f.name for f in dataclasses.fields(th.HAState)]
WALL = wall_map(64, 64, gap=(28, 38))
A, B = (10.0, 32.0, 0.0), (54.0, 32.0, 0.0)


def _pair(free, a, b, rc=None, **over):
    jc, tc = JCfg(**{**BASE, **over}), HybridAStarConfig(**{**BASE, **over})
    if rc is None:
        jp = jh.HybridAStar(jnp.asarray(free), JPose.create(*a), JPose.create(*b), jc)
        tp = HybridAStar(free, Pose.create(*a), Pose.create(*b), tc, device="cpu")
    else:
        jp = jh.HybridAStar(jnp.asarray(free), JPose.create(*a), JPose.create(*b), jc,
                            JRaycast(**rc))
        tp = HybridAStar(free, Pose.create(*a), Pose.create(*b), tc, RaycastConfig(**rc),
                          device="cpu")
    return jp, tp


def _assert_states_equal(t, j, fields):
    for f in fields:
        np.testing.assert_array_equal(np_(getattr(t, f)), np_(getattr(j, f)), f)


@pytest.mark.parametrize("over", [{}, {"lattice_reps": 2}, {"lattice_depth": 2},
                                  {"theta_res": 8, "velocity": 6.0, "length": 6.0}])
def test_lattice_tables_and_feasibility_words(over):
    free = WALL.copy()
    free[5:9, 40:50] = False
    jp, tp = _pair(free, A, B, **over)
    for name in ("_lat_off", "_lat_di", "_lat_dj", "_lat_cost", "_lat_edge"):
        np.testing.assert_array_equal(np_(getattr(tp, name)), np_(getattr(jp, name)), name)
    np.testing.assert_array_equal(tp._lat_inv_off, jp._lat_inv_off)
    jw = np.asarray(jp._lat_feas)
    assert tp._lat_feas.dtype == torch.int32 and tp._lat_feas.shape == jw.shape
    np.testing.assert_array_equal(tp._lat_feas.numpy().view(np.uint32), jw)
    cfg = HybridAStarConfig(**{**BASE, **over})
    for t, j in zip(th._lattice_tables(cfg, free.shape), jh._lattice_tables(JCfg(**{**BASE, **over}),
                                                                            free.shape)):
        np.testing.assert_array_equal(t, j)
    assert th._lane_seqs(cfg, 6) == jh._lane_seqs(JCfg(**{**BASE, **over}), 6)


def test_lattice_round_from_carried_state():
    jp, tp = _pair(WALL, A, B)
    for _ in range(6):
        jp.pathfind()
    tp._ensure_query_state()
    st = convert.lattice_state(**{f: np.asarray(getattr(jp.state, f)) for f in LAT_FIELDS})
    args = (tp._lat_feas, tp._lat_off, tp._lat_di, tp._lat_dj, tp._lat_cost, tp._lat_edge)
    tnext = th._lattice_round(st, *args, tp._goal, tp._target_bin, tp._hfield, tp.cfg, tp.shape)
    jnext = jh._lattice_round_jit(jp.state, jp._lat_feas, jp._lat_off, jp._lat_di, jp._lat_dj,
                                  jp._lat_cost, jp._lat_edge, jp._goal, jp._target_bin,
                                  jp._hfield, jp.cfg, jp.shape)
    _assert_states_equal(tnext, jnext, LAT_FIELDS)
    np.testing.assert_array_equal(np_(tp._hfield), np_(jp._hfield))
    # An inactive round changes nothing.
    idle = th._lattice_round(st, *args, tp._goal, tp._target_bin, tp._hfield, tp.cfg,
                             tp.shape, torch.tensor(False))
    _assert_states_equal(idle, st, LAT_FIELDS)


@pytest.mark.parametrize("case", [
    ("wall", {}), ("open", {}), ("wall", {"lattice_reps": 3}),
    ("wall", {"heuristic_weight": 1.3}), ("open", {"heuristic": "euclid"}),
    ("unreachable", {}), ("open", {"open_capacity": 64, "batch": 16}),
])
def test_lattice_solve_bitwise(case):
    """The whole search: packed words, ring, counters (n_lost included,
    with a ring too small for a round) and the recovered path."""
    name, over = case
    if name == "open":
        free, a, b = np.ones((64, 64), bool), (10.0, 10.0, 0.0), (50.0, 50.0, 0.0)
    elif name == "unreachable":
        free = np.ones((48, 48), bool)
        free[:, 24] = False
        a, b = (8.0, 24.0, 0.0), (40.0, 24.0, 0.0)
    else:
        free, a, b = WALL, A, B
    jp, tp = _pair(free, a, b, **over)
    rounds = 300 if name == "unreachable" else 400
    assert tp.solve(rounds) == jp.solve(rounds) == (name != "unreachable")
    _assert_states_equal(tp.state, jp.state, LAT_FIELDS)
    assert tp.path_cost() == jp.path_cost()
    assert tp.recover_path() == jp.recover_path()
    if "open_capacity" in over:
        assert int(tp.state.n_lost) > 0


def test_lattice_pathfind_matches_solve_and_chunked_walk():
    jp, tp = _pair(WALL, A, B)
    n = 0
    while not tp.pathfind():
        assert not jp.pathfind()
        n += 1
        assert n < 500
    assert jp.pathfind() and tp.success
    _assert_states_equal(tp.state, jp.state, LAT_FIELDS)
    full = tp.recover_path()
    assert full == jp.recover_path() and len(full) > 8
    tp._chain_chunk = 4
    assert tp.recover_path() == full
    tp.reset_query(Pose.create(*A), Pose.create(*B))
    assert tp.solve(600) and tp.recover_path() == full


def test_solve_many_matches_single_and_jax():
    queries = [(A, B), ((10.0, 10.0, 0.0), (50.0, 50.0, 0.0)),
               ((54.0, 10.0, 0.0), (10.0, 50.0, 0.0))]
    jp, tp = _pair(WALL, *queries[0])
    jfleet = jp.solve_many([(JPose.create(*a), JPose.create(*b)) for a, b in queries], 400)
    tfleet = tp.solve_many([(Pose.create(*a), Pose.create(*b)) for a, b in queries], 400)
    assert tfleet == jfleet
    _assert_states_equal(tp._fleet_state, jp._fleet_state, LAT_FIELDS)
    paths = [tp.recover_path_for(q) for q in range(len(queries))]
    for q, (a, b) in enumerate(queries):
        assert paths[q] == jp.recover_path_for(q)
        tp.reset_query(Pose.create(*a), Pose.create(*b))
        assert tp.solve(400) == tfleet[q][0]
        assert tp.path_cost() == tfleet[q][1] and tp.recover_path() == paths[q]
    with pytest.raises(ValueError, match="solve_many"):
        tp.recover_path_for(0)
    with pytest.raises(NotImplementedError, match="item 5"):
        tp.solve_many(queries[:1], query_sharding=object())


def test_rejects_too_coarse_theta_res():
    free = np.ones((32, 32), bool)
    with pytest.raises(ValueError, match="lattice") as t_err:
        HybridAStar(free, Pose.create(5.0, 5.0, 0.0), Pose.create(25.0, 25.0, 0.0),
                    HybridAStarConfig(**{**BASE, "theta_res": 4}), device="cpu")
    with pytest.raises(ValueError) as j_err:
        jh.HybridAStar(jnp.asarray(free), JPose.create(5.0, 5.0, 0.0),
                       JPose.create(25.0, 25.0, 0.0), JCfg(**{**BASE, "theta_res": 4}))
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("rc", [None, {"backend": "lut", "step": 1.0, "lut_bins": 180}])
def test_continuous_mode(rc):
    """The wall-gap case: same success and goal state, cost within 1e-4,
    every path cell free; one round from carried JAX state matches."""
    over = {"mode": "continuous", "theta_res": 8}
    jp, tp = _pair(WALL, A, B, rc, **over)
    assert tp.solve(400) and jp.solve(400)
    assert int(tp.state.goal_idx) == int(jp.state.goal_idx)
    assert abs(tp.path_cost() - jp.path_cost()) <= 1e-4 * jp.path_cost()
    path = tp.recover_path()
    assert len(path) >= 5 and all(WALL[i, j] for i, j in path)
    for i, j in path:
        if j == 32:
            assert 28 <= i < 38
    # One round from a carried mid-search state.
    jp.reset_query(JPose.create(*A), JPose.create(*B))
    for _ in range(3):
        jp.pathfind()
    tp.reset_query(Pose.create(*A), Pose.create(*B))
    tp._ensure_query_state()
    st = convert.ha_state(**{f: np.asarray(getattr(jp.state, f)) for f in HA_FIELDS})
    tnext = th._ha_round(st, tp.field, tp._goal, tp._target_bin, tp._hfield, tp.cfg, tp.rc)
    jnext = jh._ha_round_jit(jp.state, jp.field, jp._goal, jp._target_bin, jp._hfield,
                             jp.cfg, jp.rc)
    _assert_states_equal(tnext, jnext, ["parent", "goal_idx", "n_expanded", "start_idx"])
    for f in ("g", "px", "py", "pth", "open_f"):
        np.testing.assert_allclose(np_(getattr(tnext, f)), np_(getattr(jnext, f)), rtol=1e-4,
                                   atol=1e-4, err_msg=f)


def test_continuous_unreachable_and_pathfind():
    free = np.ones((48, 48), bool)
    free[:, 24] = False
    over = {"mode": "continuous", "theta_res": 8}
    _, tp = _pair(free, (8.0, 24.0, 0.0), (40.0, 24.0, 0.0), **over)
    assert not tp.solve(300) and tp.recover_path() == []
    jp, tp = _pair(WALL, A, B, **over)
    n = 0
    while not tp.pathfind():
        n += 1
        assert n < 500
    assert jp.solve(400) and tp.success
    assert abs(tp.path_cost() - jp.path_cost()) <= 1e-4 * jp.path_cost()


def test_overflowed_exhaustion_warns(caplog):
    """An exhausted search whose ring overwrote live entries logs that the
    verdict is inconclusive, through the port's logger."""
    free = np.ones((24, 24), bool)
    free[:, 12] = False
    _, tp = _pair(free, (4.0, 12.0, 0.0), (20.0, 12.0, 0.0), open_capacity=32, batch=16)
    assert not tp.solve(4000)
    assert int(tp.state.n_lost) > 0 and not bool((tp.state.o_f < th.INF).any())
    assert "inconclusive" in caplog.text and "capacity 32" in caplog.text


def test_set_drop_spare_slot_in_place():
    """`.at[idx].set(v, mode="drop")` with index n dropped: `set_drop`
    leaves its input alone; `set_drop_` writes an array with a spare slot
    in place, and each row of a stacked array keeps its own spare slot."""
    a = torch.arange(6, dtype=torch.float32)
    idx = torch.tensor([4, 6, 1, 6])
    v = torch.tensor([10.0, 11.0, 12.0, 13.0])
    want = a.clone()
    want[4], want[1] = 10.0, 12.0
    assert torch.equal(set_drop(a, idx, v), want) and torch.equal(a, torch.arange(6.0))
    own = with_spare(a)
    ptr = own.data_ptr()
    assert set_drop_(own, idx, v) is own and own.data_ptr() == ptr
    assert torch.equal(own, want)
    rows = with_spare(torch.zeros((2, 5), dtype=torch.int32))
    set_drop_(rows, torch.tensor([[5, 0], [5, 4]]), 7)
    assert rows.tolist() == [[7, 0, 0, 0, 0], [0, 0, 0, 0, 7]]
    one = with_spare(torch.zeros(5))[None]  # the single-query form of a round
    set_drop_(one, torch.tensor([[5, 2]]), 1.0)
    assert one.tolist() == [[0.0, 0.0, 1.0, 0.0, 0.0]]
    with pytest.raises(ValueError, match="spare"):
        set_drop_(a.clone(), idx, v)
