"""Requests to a robot's planner on the map it localizes on, through the
port's `slam_tpu_torch.planners.HybridAStar` in lattice mode, one object
for the run, as upstream's benchmark resets one planner a query. Its map
tables (the lane-feasibility words, the lattice's tables) are built once
at set-up; a request is `Plan.step`:

  plan  `reset_query(start, goal)`, `solve()` (on the card the query
        init's wavefront chain and the lattice search chain, CUDA graph
        replays), `recover_path()` and `path_cost()`

A request ends when the path's cells and its cost are on the host; it
returns (cost, cells in the path, the last cell's centre x, y), the cost
inf where the planner found no path (its own cost is then 1e30). The
reference that judges these requests is `reference/judge_plan.py`.

Set-up holds the planner to the configuration's guarantee that a plan's
reported cost is its own path's, once, on the traffic's first pair: a
planner that reports another cost (the goal's cost at its pop, which
exceeds its path's where a state on the chain improved after its
successor was committed) cannot serve this cell, and the run stops
there with an error, before its window.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from portbench.reference.lattice import Lattice
from slam_tpu_torch.core.config import HybridAStarConfig
from slam_tpu_torch.core.types import Pose
from slam_tpu_torch.planners import HybridAStar


@dataclasses.dataclass(frozen=True)
class Answer:
    cost: float
    path: tuple  # the cells (i, j) after the start, to the goal


class Plan:
    """The one call a plan request makes, which `faults_plan.py` breaks."""

    @staticmethod
    def step(planner: HybridAStar, query) -> Answer:
        """`query`: (start, goal) Poses."""
        planner.reset_query(*query)
        found = planner.solve()
        path = planner.recover_path()
        return Answer(planner.path_cost() if found else math.inf, tuple(path))


# The entry point whose `step` the window drives.
ENTRY = Plan


def planner_config(cfg: dict) -> HybridAStarConfig:
    p = dict(cfg["planner"])
    p["max_steering"] = math.radians(p.pop("max_steering_deg"))
    return HybridAStarConfig(**p)


class Engine:
    """The planner of one run on the configuration's map, with every
    query's poses made on its device at set-up."""

    def __init__(self, cfg: dict, cell: dict, blocked: np.ndarray, traffic, seed: int, dev):
        self.h = blocked.shape[0]
        self.queries = [tuple(Pose.create(*p, device=dev) for p in pair) for pair in traffic.pairs]
        self.planner = HybridAStar(~blocked, *self.queries[0], planner_config(cfg), device=dev)
        self._hold_cost_to_path(cfg, blocked, traffic.pairs[0], cell["limits"]["cost_gap"])
        self.state = None

    def _hold_cost_to_path(self, cfg: dict, blocked: np.ndarray, pair, within: float) -> None:
        """Raise unless the first pair's reported cost lies `within` of a
        total of a heading sequence along its returned cells on the plain
        lattice (the judge's `cost_gap`), called on the planner itself."""
        p = self.planner
        p.reset_query(*self.queries[0])
        if not p.solve():
            return  # the judge counts an unsolved query
        path, cost = p.recover_path(), p.path_cost()
        lat = Lattice(cfg["planner"], ~blocked, "cpu")
        totals, _ = lat.chain_totals(lat.start_state(*pair[0]), path)
        gap = min((abs(cost - t) for t in totals), default=math.inf)
        if gap > within:
            raise RuntimeError(
                f"plan: the planner reports cost {cost} for a path of {len(path)} cells whose "
                f"lattice totals are {sorted(totals)[:4]}: its cost is not its path's, so it "
                "cannot serve this cell")

    def reset(self) -> None:
        self.state = None

    def serve(self, req, keep=None):
        """Serve one request; with `keep` (a list) append to it ("plan",
        None, None, the answer, the request). Returns what was read."""
        ans = ENTRY.step(self.planner, self.queries[req.qid])
        if keep is not None:
            keep.append(("plan", None, None, ans, req))
        self.state = ans
        i, j = ans.path[-1] if ans.path else (self.h - req.start[1] - 1.0, req.start[0])
        return ans.cost, float(len(ans.path)), j + 0.5, self.h - i - 0.5

    def release(self) -> None:
        """Drop the planner's tables, search state and graphs."""
        self.planner = None
        self.state = None
