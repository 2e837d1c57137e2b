"""Plan queries on the planner's map: a fixed set of start-goal pairs,
served one at a time in an order the run's seed shuffles.

The pairs come from the data file alone (its `pairs_seed`), so every run
serves the same work: the first is the file's `first` pair (image
coordinates (i, j) of start and goal, and the start heading); the others
are drawn from the plan's free cells with

  * the straight-line length between the two in `length_px`;
  * start and goal in different rooms, so the path passes at least one
    door gap (a room: the cells between two of the plan's wall rows and
    two of its wall columns, a wall line being a row or column that is
    mostly blocked), and joined by the plan's free cells (8-connected: the
    stand-in has rooms whose doors the inflation closes);
  * the start's own state cell free (the planner's start cell is the row
    above the point, `reference/lattice.py`);
  * a start heading at the centre of a heading bin drawn uniformly; the
    goal's heading 0 (the vehicle drives both ways, so any is taken).

A pose is (x, y, theta) with x = j and y = H - i, as the suite places its
queries. The run's seed draws a fresh order of all the pairs for each
cycle through them. One query outstanding: a request ends when the path's
cells and its cost are on the host.
"""

from __future__ import annotations

import dataclasses
import math
import random

import numpy as np
from scipy import ndimage

# Candidate pairs drawn at most.
DRAWS = 100_000


@dataclasses.dataclass(frozen=True)
class Query:
    kind: str
    scan: None
    qid: int
    start: tuple  # (x, y, theta)
    goal: tuple  # (x, y, theta)


def rooms(blocked: np.ndarray):
    """(a room index per row, per column): the wall lines (rows or columns
    mostly blocked) crossed from the top or the left."""
    def bands(frac):
        wall = frac > 0.5
        rising = np.concatenate([[wall[0]], wall[1:] & ~wall[:-1]])
        return np.cumsum(rising)
    return bands(blocked.mean(1)), bands(blocked.mean(0))


def draw_pairs(spec: dict, theta_res: int, blocked: np.ndarray) -> list:
    """The `spec["queries"]` (start, goal) pose pairs of the data file."""
    h, w = blocked.shape
    row_room, col_room = rooms(blocked)
    part = ndimage.label(~blocked, structure=np.ones((3, 3)))[0]
    binw = 2.0 * math.pi / theta_res

    def pose(i, j, theta):
        return (float(j), float(h - i), float(theta))

    first = spec["first"]
    pairs = [(pose(*first["start_ij"], first["start_theta"]), pose(*first["goal_ij"], 0.0))]
    rng = np.random.default_rng(spec["pairs_seed"])
    free = np.flatnonzero(~blocked.ravel())
    lo, hi = spec["length_px"]
    for _ in range(DRAWS):
        if len(pairs) == spec["queries"]:
            return pairs
        (ai, aj), (bi, bj) = (divmod(int(c), w) for c in rng.choice(free, 2))
        k = int(rng.integers(theta_res))
        if ai < 1 or blocked[ai - 1, aj]:
            continue
        if not lo <= math.hypot(ai - bi, aj - bj) <= hi:
            continue
        if (row_room[ai], col_room[aj]) == (row_room[bi], col_room[bj]):
            continue
        if part[ai - 1, aj] != part[bi, bj]:
            continue
        pairs.append((pose(ai, aj, (k + 0.5) * binw), pose(bi, bj, 0.0)))
    raise ValueError(f"{len(pairs)} of {spec['queries']} pairs in {DRAWS} draws: no two rooms "
                     f"{lo}-{hi} px apart on this plan")


class Traffic:
    """The queries of one run (`request(k)`); no scans (`angles` and
    `dists` are None)."""

    def __init__(self, spec: dict, cfg: dict, plan: np.ndarray, seed: int, seconds: float,
                 scan_device=None):
        self.pairs = draw_pairs(spec, int(cfg["planner"]["theta_res"]), plan)
        self.rng = random.Random(seed)
        self.order: list = []
        self.angles = self.dists = None

    def request(self, k: int) -> Query:
        while len(self.order) <= k:
            cycle = list(range(len(self.pairs)))
            self.rng.shuffle(cycle)
            self.order += cycle
        q = self.order[k]
        return Query("plan", None, q, *self.pairs[q])
