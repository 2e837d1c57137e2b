"""The judge of `requests/plan.py`'s requests: each sampled answer of the
lattice Hybrid A* planner held to the plain lattice of the configuration's
written rule (`reference/lattice.py`), on the free mask the program was
given. The numbers, each the widest over the sampled requests (the last a
count):

  path_invalid_edges  steps of the returned chain of cells, from the
                      query's start state, that no feasible lattice edge
                      from any heading bin joins
  goal_gap_px         how far the chain's last cell's centre lies beyond
                      `tol` of the goal
  cost_gap            the distance from the reported cost to the nearest
                      total of a heading sequence along the returned cells
                      (the cells do not fix the headings, so more than one
                      total may fit; every total is exact in f32 at this
                      configuration's edge costs 10, 15 and 60)
  cost_over_optimal   the reported cost over the lattice's optimum C*,
                      less 1 (the planner is a batched weighted A*)
  unsolved_queries    sampled queries the reference reaches and the
                      program reports unreachable (inf)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.lattice import Lattice


def judge(records, cfg: dict, blocked: np.ndarray, angles, dev) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lat = Lattice(cfg["planner"], ~np.asarray(blocked, bool), dev)
    optimum = {}
    out = {"path_invalid_edges": 0.0, "goal_gap_px": 0.0, "cost_gap": 0.0,
           "cost_over_optimal": 0.0, "unsolved_queries": 0.0}
    for rec in records:
        q, ans = rec["req"], rec["after"]
        start = lat.start_state(*q.start)
        if q.qid not in optimum:
            optimum[q.qid] = lat.optimum(start, q.goal)
        best = optimum[q.qid]
        if not math.isfinite(ans.cost):
            out["unsolved_queries"] += float(math.isfinite(best))
            continue
        totals, invalid = lat.chain_totals(start, ans.path)
        end = ans.path[-1] if ans.path else start[:2]
        over = ans.cost / best - 1.0 if math.isfinite(best) and best > 0 else 0.0
        for name, v in (("path_invalid_edges", float(invalid)),
                        ("goal_gap_px", lat.goal_gap(*end, q.goal)),
                        ("cost_gap", min((abs(ans.cost - t) for t in totals), default=math.inf)),
                        ("cost_over_optimal", over)):
            out[name] = max(out[name], v)
    return out
