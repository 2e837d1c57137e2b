"""The plan cell on the CPU at a small size: the same pairs on every seed,
drawn by the data file's rules; a sound run is correct and a run with a
fault planted in the plan request (`faults_plan.py`) is not; a planner
whose reported cost is not its path's stops the run at set-up; the judge and
its lattice load neither JAX nor the program. On the card (marked `card`):
the cell at the small size is correct as the program states it and its
control (the workload file's looser heuristic weight) is not.

    python3 -m pytest portbench/tests/test_portbench_plan.py -q
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from portbench import control, faults_plan, run
from portbench.tests.test_portbench_harness import _blocked_python
from portbench.traffic import pairs

CELL = "plan_floorplan.hastar_lattice"
V = 5.0
# Rooms of 100 x 75 with doors of 40 and a vehicle of v = 5 (the cell's
# v = 10 turns on a 57 px radius), 4 pairs.
SMALL = {"config": {"plan": {"height": 160, "width": 220, "room_w": 100, "room_h": 75,
                             "door": 20, "radius": 3},
                    "planner": {"batch": 64, "velocity": V,
                                "length": V * math.tan(math.radians(40)) / math.radians(10)}},
         "traffic": {"queries": 4, "first": {"start_ij": [30, 30], "goal_ij": [120, 180],
                                             "start_theta": 0.0},
                     "length_px": [60, 250]},
         "cell": {"trace": {"start": 2, "requests": 2}, "point_at": 2, "sample": {"plan": 4}}}


def _traffic(seed, over=None):
    cfg = run.merged(run.load("configs", "plan_floorplan"), (over or {}).get("config", {}))
    spec = run.merged(run.load("traffic", "plan_pairs"), (over or {}).get("traffic", {}))
    plan = run.build_map(cfg["plan"])
    return pairs.Traffic(spec, cfg, plan, seed, 1.0), plan, spec


def test_every_seed_serves_the_same_pairs_in_its_own_order():
    a, plan, spec = _traffic(2**31 + 1)
    b, _, _ = _traffic(2**31 + 2)
    assert a.pairs == b.pairs and len(a.pairs) == spec["queries"] == 16
    h = plan.shape[0]
    (si, sj), (gi, gj) = spec["first"]["start_ij"], spec["first"]["goal_ij"]
    assert a.pairs[0] == ((sj, h - si, 0.0), (gj, h - gi, 0.0))
    ra, rb = [a.request(k).qid for k in range(64)], [b.request(k).qid for k in range(64)]
    assert ra != rb
    assert all(sorted(r[c:c + 16]) == list(range(16)) for r in (ra, rb) for c in range(0, 64, 16))
    rows, cols = pairs.rooms(plan)
    binw = 2 * math.pi / 36
    for (ax, ay, th), (bx, by, _) in a.pairs[1:]:
        (ai, aj), (bi, bj) = (h - int(ay), int(ax)), (h - int(by), int(bx))
        assert 400 <= math.hypot(ai - bi, aj - bj) <= 1100
        assert not plan[ai, aj] and not plan[ai - 1, aj] and not plan[bi, bj]
        assert (rows[ai], cols[aj]) != (rows[bi], cols[bj])
        assert abs(th / binw - 0.5 - round(th / binw - 0.5)) < 1e-9


def test_a_plan_with_no_pairs_to_draw_is_refused():
    with pytest.raises(ValueError, match="pairs"):
        _traffic(1, {"traffic": {"length_px": [5000, 6000]}})


@pytest.mark.parametrize("fault", ["sound", *sorted(faults_plan.FAULTS)])
def test_a_broken_plan_request_is_not_correct(fault):
    plant = contextlib.nullcontext() if fault == "sound" else faults_plan.planted(fault)
    with plant:
        out = run.run_cell(CELL, 2**31 + 99, 0.5, False, torch.device("cpu"), 0.0,
                           overrides=SMALL)
    assert out["correct"] == (fault == "sound"), out["checks"]
    assert out["checks"]["kinds_unjudged"]["value"] == 0
    if fault == "sound":
        assert all(math.isfinite(c["value"]) for c in out["checks"].values())


def test_a_planner_whose_cost_is_not_its_paths_is_refused_at_set_up(monkeypatch):
    from slam_tpu_torch.planners import HybridAStar

    walked = HybridAStar.path_cost
    monkeypatch.setattr(HybridAStar, "path_cost", lambda self: walked(self) + V)
    with pytest.raises(RuntimeError, match="not its path's"):
        run.run_cell(CELL, 2**31 + 99, 0.5, False, torch.device("cpu"), 0.0, overrides=SMALL)


def test_the_plan_judge_loads_neither_jax_nor_the_program():
    p = _blocked_python(("jax", "jaxlib", "flax", "slam_tpu", "slam_tpu_torch"), """
import importlib, sys
for m in ("lattice", "judge_plan"):
    importlib.import_module("portbench.reference." + m)
print("ok", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "slam_tpu_torch")))
""")
    assert p.returncode == 0 and p.stdout.split() == ["ok", "[]"], p.stderr[-3000:]


@pytest.mark.card
def test_sound_is_correct_and_the_control_is_not(card):
    for ctl in (False, True):
        for seed, out in control.readings(CELL, [2**31 + 3, 2**31 + 4], 1.0, ctl, card,
                                          overrides=SMALL):
            assert out["correct"] != ctl, (seed, out["checks"])


def test_the_small_plan_has_rooms():
    rows, cols = pairs.rooms(run.build_map({**run.load("configs", "plan_floorplan")["plan"],
                                            **SMALL["config"]["plan"]}))
    assert len(np.unique(rows)) >= 2 and len(np.unique(cols)) >= 2
