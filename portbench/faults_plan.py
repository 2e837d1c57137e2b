"""Faults planted in a plan request (`requests/plan.py:Plan.step`), for
the readings that show the plan judge catches them
(`portbench/tests/test_portbench_plan.py` on the CPU):

  wall       the search runs on the plan before its inflation, so a path
             may pass closer to a wall than the vehicle's disc allows
  truncated  the path's last cell left out
  cost       the reported cost off by one edge: a straight edge's cost
             (the velocity) left out of the sum
  stale      the previous query's answer returned
"""

from __future__ import annotations

import contextlib
import dataclasses

from portbench.maps import floor_plan
from portbench.requests import plan


def _wall(step, planner, query, last):
    if not getattr(planner, "uninflated", False):
        planner.reset(~floor_plan.build(*planner.shape), *query)
        planner.uninflated = True
    return step(planner, query)


def _stale(step, planner, query, last):
    ans = step(planner, query)
    last.append(ans)
    return last[-2] if len(last) > 1 else ans


def _truncated(step, planner, query, last):
    ans = step(planner, query)
    return dataclasses.replace(ans, path=ans.path[:-1])


def _cost(step, planner, query, last):
    ans = step(planner, query)
    return dataclasses.replace(ans, cost=ans.cost - planner.cfg.velocity)


FAULTS = {"wall": _wall, "truncated": _truncated, "cost": _cost, "stale": _stale}


@contextlib.contextmanager
def planted(fault: str):
    """`plan.ENTRY.step` broken by `fault` inside the block."""
    cls = plan.ENTRY
    saved = cls.__dict__["step"]
    step, last = saved.__func__, []
    cls.step = staticmethod(lambda planner, query: FAULTS[fault](step, planner, query, last))
    try:
        yield
    finally:
        cls.step = saved
