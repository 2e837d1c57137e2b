"""slam_tpu_torch.planners.HybridAStar in lattice mode against the plain
lattice of the benchmark's plan judge (`portbench/reference/lattice.py`),
on the CPU (the eager route), and the planner's spans and counters.

The configuration is the plan cell's (36 heading bins, branching 3,
reverse factor 10, weight 1.3, the geodesic heuristic at coarse 4) at
batch 64 and a vehicle scaled to the small maps: velocity 5 with the
length that keeps a full-steer edge turning one bin (the cell's v = 10
turns on a 57 px radius, wider than these rooms). Each query's answer
must be a valid lattice path (every step a feasible edge from some bin),
end within tol of the goal, report exactly the total of a bin sequence
along its cells (every edge cost, 5, 7.5 and 30, is a multiple of the
1/64 quantum), stay within the cell's `cost_over_optimal` limit of the
lattice's optimum, and be found exactly where the reference finds one.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.maps import floor_plan_inflated
from portbench.reference.lattice import Lattice
from portbench.requests import plan
from slam_tpu_torch.core.types import Pose
from slam_tpu_torch.planners import HybridAStar
from slam_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "portbench/configs/plan_floorplan.json").read_text())
CELL = json.loads((ROOT / "portbench/workloads/plan_floorplan.hastar_lattice.json").read_text())
V = 5.0
PLANNER = {**CFG["planner"], "batch": 64, "velocity": V,
           "length": V * math.tan(math.radians(40.0)) / math.radians(10.0)}
LIMIT = CELL["limits"]["cost_over_optimal"]


def rooms_plan():
    return floor_plan_inflated.build(160, 220, 3, room_w=100, room_h=75, door=20)


def field_plan(seed):
    """A seeded random obstacle field: 14 rectangles in a walled 96 x 128
    map, inflated by 2."""
    rng = np.random.default_rng(seed)
    b = np.zeros((96, 128), bool)
    b[:2], b[-2:], b[:, :2], b[:, -2:] = True, True, True, True
    for _ in range(14):
        i, j = rng.integers(0, 86), rng.integers(0, 118)
        b[i:i + rng.integers(3, 12), j:j + rng.integers(3, 12)] = True
    pad = np.pad(b, 2, constant_values=True)
    out = np.zeros_like(b)
    for di in range(-2, 3):
        for dj in range(-2, 3):
            if di * di + dj * dj <= 4:
                out |= pad[2 + di:2 + di + 96, 2 + dj:2 + dj + 128]
    return out


def ij_pose(blocked, i, j, theta=0.0):
    return (float(j), float(blocked.shape[0] - i), float(theta))


def sealed_plan():
    """The rooms with every door walled up."""
    b = rooms_plan()
    b[:, 90:110] = True
    b[65:85, :] = True
    return b


# (map, start (i, j, heading bin), goal (i, j)): rooms through one and two
# doors, a start facing a wall, random fields around their obstacles, and
# a goal behind walls.
QUERIES = {
    "sealed": ("sealed", (30, 30, 0), (120, 180)),
    "rooms-door": ("rooms", (30, 30, 0), (120, 180)),
    "rooms-two-doors": ("rooms", (30, 40, 9), (130, 60)),
    "rooms-facing-wall": ("rooms", (40, 85, 0), (40, 150)),
    "field0": ("field0", (20, 20, 4), (80, 110)),
    "field1": ("field1", (80, 15, 27), (15, 110)),
    "field2": ("field2", (50, 10, 0), (50, 118)),
    # The goal's cost at its pop is 77.5 here, its path's 65 (below).
    "field2-improved-parent": ("field2", (44, 38, 24), (52, 51)),
}
MAPS = {"rooms": rooms_plan, "sealed": sealed_plan, "field0": lambda: field_plan(0), "field1": lambda: field_plan(1),
        "field2": lambda: field_plan(2)}


def _free_near(blocked, i, j):
    """The free cell nearest (i, j) whose row above is free too (the
    start's state cell)."""
    free = ~blocked
    ok = free.copy()
    ok[1:] &= free[:-1]
    ok[0] = False
    ii, jj = np.nonzero(ok)
    k = np.argmin((ii - i) ** 2 + (jj - j) ** 2)
    return int(ii[k]), int(jj[k])


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_lattice_answer_holds_to_the_plain_lattice(name):
    m, (si, sj, k), (gi, gj) = QUERIES[name]
    blocked = MAPS[m]()
    si, sj = _free_near(blocked, si, sj)
    gi, gj = _free_near(blocked, gi, gj)
    a = ij_pose(blocked, si, sj, (k + 0.5) * 2 * math.pi / PLANNER["theta_res"])
    b = ij_pose(blocked, gi, gj)
    cfg = plan.planner_config({"planner": PLANNER})
    p = HybridAStar(~blocked, Pose.create(*a), Pose.create(*b), cfg, device="cpu")
    ans = plan.Plan.step(p, (Pose.create(*a), Pose.create(*b)))

    lat = Lattice(PLANNER, ~blocked, "cpu")
    start = lat.start_state(*a)
    best = lat.optimum(start, b)
    assert math.isfinite(ans.cost) == math.isfinite(best), (ans.cost, best)
    if not math.isfinite(best):
        return
    totals, invalid = lat.chain_totals(start, ans.path)
    assert invalid == 0
    assert lat.goal_gap(*ans.path[-1], b) == 0.0
    assert min(abs(ans.cost - t) for t in totals) <= 1.0 / 64.0, (ans.cost, totals)
    assert best <= ans.cost <= (1.0 + LIMIT) * best, (ans.cost, best)


def test_the_reported_cost_is_the_returned_paths():
    """A state on the parent chain can improve after its successor was
    committed: the walk follows the improved parent, so the goal's cost at
    its pop (77.5) overstates the path returned; `path_cost` is the path's
    own (65), the cheapest of the heading sequences its cells allow."""
    _, (si, sj, k), (gi, gj) = QUERIES["field2-improved-parent"]
    blocked = field_plan(2)
    a = ij_pose(blocked, si, sj, (k + 0.5) * 2 * math.pi / PLANNER["theta_res"])
    b = ij_pose(blocked, gi, gj)
    p = HybridAStar(~blocked, Pose.create(*a), Pose.create(*b),
                    plan.planner_config({"planner": PLANNER}), device="cpu")
    assert p.solve()
    assert (p.path_cost(), float(p.state.goal_cost)) == (65.0, 77.5)
    lat = Lattice(PLANNER, ~blocked, "cpu")
    totals, invalid = lat.chain_totals(lat.start_state(*a), p.recover_path())
    assert invalid == 0 and min(totals) == 65.0 and 77.5 not in totals


def test_solve_many_reports_the_walked_cost():
    """`solve_many` reports what one query at a time reports: the path's
    own cost (65 where the goal popped at 77.5) and the same path."""
    blocked = field_plan(2)
    queries = []
    for name in ("field2", "field2-improved-parent"):
        _, (si, sj, k), (gi, gj) = QUERIES[name]
        si, sj = _free_near(blocked, si, sj)
        gi, gj = _free_near(blocked, gi, gj)
        a = ij_pose(blocked, si, sj, (k + 0.5) * 2 * math.pi / PLANNER["theta_res"])
        queries.append((Pose.create(*a), Pose.create(*ij_pose(blocked, gi, gj))))
    p = HybridAStar(~blocked, *queries[0], plan.planner_config({"planner": PLANNER}),
                    device="cpu")
    fleet = p.solve_many(queries)
    paths = [p.recover_path_for(q) for q in range(len(queries))]
    assert fleet[1] == (True, 65.0)
    for q, query in enumerate(queries):
        p.reset_query(*query)
        assert (p.solve(), p.path_cost()) == fleet[q]
        assert p.recover_path() == paths[q]


def test_the_reference_lattice_is_the_planners():
    """The rule written in the configuration gives the program's tables:
    offsets, next bins, chord samples and costs."""
    from slam_tpu_torch.planners import hastar

    for planner in (PLANNER, CFG["planner"]):
        lat = Lattice(planner, np.ones((40, 50), bool), "cpu")
        _, di, dj, cost, seg, _, nk = hastar._lattice_tables(plan.planner_config(
            {"planner": planner}), (40, 50))
        np.testing.assert_array_equal(di, lat.di)
        np.testing.assert_array_equal(dj, lat.dj)
        np.testing.assert_array_equal(nk, lat.nk)
        np.testing.assert_array_equal(seg, lat.seg)
        np.testing.assert_array_equal(cost, np.broadcast_to(lat.cost, cost.shape))


def test_the_optimum_of_an_open_floor_is_the_straight_run():
    """On an open floor the optimum to a goal straight ahead is the
    straight edges that reach it (10 a step at V = 10), and the chain of
    those cells costs as much; an edge through a wall is refused."""
    free = np.ones((40, 120), bool)
    planner = CFG["planner"]
    lat = Lattice(planner, free, "cpu")
    start = (20, 10, 0)  # heading bin 0: 5 deg, straight edges step (0, 10) or (-1, 10)
    cells = []
    i, j = 20, 10
    for _ in range(8):
        i, j = i + lat.di[0, 1], j + lat.dj[0, 1]
        cells.append((i, j))
    goal = (j + 0.5, 40 - i - 0.5)
    assert lat.chain_totals(start, cells) == ({80.0}, 0)
    assert lat.optimum(start, goal) == 80.0
    free[:, 45] = False
    assert lat.chain_totals(start, cells) == (set(), 1)
    assert Lattice(planner, free, "cpu").optimum(start, goal) == math.inf


@pytest.fixture
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _rooms_planner():
    blocked = rooms_plan()
    a = ij_pose(blocked, 30, 30)
    b = ij_pose(blocked, 120, 180)
    p = HybridAStar(~blocked, Pose.create(*a), Pose.create(*b),
                    plan.planner_config({"planner": PLANNER}), device="cpu")
    return p, (Pose.create(*a), Pose.create(*b)), (Pose.create(*b), Pose.create(*a))


def test_spans_and_counters_under_a_session_only(fresh):
    p, q1, q2 = _rooms_planner()
    plain = plan.Plan.step(p, q1)
    assert profiling.recorded()["records"] == [] and profiling.recorded()["counts"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        traced = [plan.Plan.step(p, q) for q in (q1, q2)]
    assert traced[0] == plain
    r = profiling.recorded()
    assert r["roots"] == 4
    assert r["root_names"] == {"HybridAStar.solve": 2, "HybridAStar.recover_path": 2}
    got = [(x.name, x.parent) for x in r["records"] if x.request == 0]
    assert got == [("hastar.init", "HybridAStar.solve"), ("hastar.search", "HybridAStar.solve"),
                   ("HybridAStar.solve", None)]
    assert [(x.name, x.parent) for x in r["records"] if x.request == 1] == [
        ("hastar.path", "HybridAStar.recover_path"), ("HybridAStar.recover_path", None)]
    s = p.stats()
    assert set(s) == {"rounds", "launched", "host_reads", "n_expanded", "n_lost", "path_reads",
                      "blocks"}
    assert s["rounds"] > 0 and s["n_expanded"] > 0 and s["n_lost"] == 0 and s["path_reads"] >= 3
    assert r["counts"]["hastar.rounds"] > s["rounds"] and r["counts"]["hastar.n_lost"] == 0
    assert r["device_ms"] == {}  # the CPU has no device time
    assert all(r["host_ms"][n] > 0.0 for n in ("hastar.init", "hastar.search", "hastar.path"))


def test_the_plan_readers_divide_by_the_queries(fresh):
    from portbench.layers import plan_path_host_ms, plan_round_us, plan_rounds

    assert plan_rounds.read(None) is None and plan_path_host_ms.read(None) is None
    p, q1, q2 = _rooms_planner()
    rounds = []
    with profile(activities=[ProfilerActivity.CPU]):
        for q in (q1, q2, q1):
            plan.Plan.step(p, q)
            rounds.append(p.rounds)
    r = profiling.recorded()
    assert plan_rounds.read(None) == pytest.approx(sum(rounds) / 3)
    assert plan_path_host_ms.read(None) == pytest.approx(r["host_ms"]["hastar.path"] / 3)
    assert plan_round_us.read(None) is None  # no device time on the CPU


def test_chained_blocks_are_made_once_across_queries(fresh):
    """A second and third query reuse the first query's chains (the card's
    captures; eager blocks here) and answer as the first queries did."""
    p, q1, q2 = _rooms_planner()
    want = [plan.Plan.step(p, q) for q in (q1, q2)]
    got, blocks = [], []
    for q in (q1, q2, q1):
        p.reset_query(*q)
        p.solve()
        got.append(plan.Answer(p.path_cost(), tuple(p.recover_path())))
        blocks.append(dict(p._graphs.blocks))
    assert got == want + want[:1]
    assert len(blocks[0]) == 2 and all(b == blocks[0] for b in blocks)
    assert set(p.stats()["blocks"]) == {"astar", "lattice"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_the_search_chain_is_timed_outside_its_body_on_the_card(card, fresh):
    blocked = rooms_plan()
    queries = [tuple(Pose.create(*ij_pose(blocked, *ij), device=card) for ij in pair)
               for pair in (((30, 30), (120, 180)), ((120, 180), (30, 30)))]
    p = HybridAStar(~blocked, *queries[0], plan.planner_config({"planner": PLANNER}),
                    device=card)
    plain = [plan.Plan.step(p, q) for q in queries]  # the captures, outside any session
    captures = {k: b.capture_ms for k, b in p._graphs.blocks.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = [plan.Plan.step(p, q) for q in queries]
    assert traced == plain
    assert {k: b.capture_ms for k, b in p._graphs.blocks.items()} == captures
    r = profiling.recorded()
    assert set(r["device_ms"]) == {"hastar.init", "hastar.search"}, r["device_ms"]
    assert all(v > 0.0 for v in r["device_ms"].values())
    assert "graph.capture" not in r["host_ms"]
