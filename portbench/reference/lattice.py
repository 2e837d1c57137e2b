"""A plain state lattice of the Hybrid A* planner's configuration, rebuilt
from its written rule (the configuration's `assumed.lattice`), and two
questions asked of it: what the heading sequences along a given chain of
cells cost, and what the cheapest path from a start to the goal costs.

The rule. A state is a cell (i, j) of the image (row i from the top; its
centre is at x = j + 1/2, y = H - i - 1/2) and one of K heading bins of
2 pi / K, its heading at the bin's centre, thc = (k + 1/2) 2 pi / K. For
each velocity v of (+V, -V) and each of the B steering angles s spread
evenly over [-S, S]:

  * the next heading is th = thc + (v / L) tan(s), its bin the bin of
    th mod 2 pi;
  * the cell offset is v (cos th, -sin th) rounded half up:
    di = floor(1/2 - v sin th), dj = floor(1/2 + v cos th);
  * the edge crosses T = max(2, ceil(V)) cells, at f = t / T for
    t = 1..T: (floor(1/2 - f v sin th), floor(1/2 + f v cos th)) from the
    state's cell; it is feasible when each of them lies on the map and is
    free (the last is the next state's cell);
  * it costs V + |b - B // 2| V / (B - 1) for steering angle b, times 1
    going forward and the reverse factor going backward on the steering
    part.

A start pose (x, y, theta) is the state i = floor(H - y - 1), j =
floor(x), k = floor((theta mod 2 pi) / (2 pi / K)). A state is at the
goal when its cell's centre lies within `tol` of the goal point (any
heading: the vehicle drives both ways).

Plain PyTorch, float32, nothing of the program: the optimum is a
Bellman-Ford relaxation over every state, each round the K * 2B
(bin, edge) shifted-plane mins, pulled through each edge's inverse bin
map.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INF = float("inf")


class Lattice:
    """The lattice of `planner` (the configuration's `planner` entry) on
    the free mask `free` (bool [H, W], host numpy), its optimum computed on
    `dev`."""

    def __init__(self, planner: dict, free: np.ndarray, dev):
        self.p, self.dev = planner, dev
        self.free = np.asarray(free, bool)
        self.h, self.w = self.free.shape
        k, b = int(planner["theta_res"]), int(planner["branching_factor"])
        vel, steer = float(planner["velocity"]), math.radians(planner["max_steering_deg"])
        length, rev = float(planner["length"]), float(planner["reverse_factor"])
        self.k, self.binw = k, 2.0 * math.pi / k
        n_t = max(2, math.ceil(vel))
        edges = [(v, i) for v in (vel, -vel) for i in range(b)]
        self.e = len(edges)
        self.di = np.zeros((k, self.e), np.int64)
        self.dj = np.zeros((k, self.e), np.int64)
        self.nk = np.zeros((k, self.e), np.int64)
        self.seg = np.zeros((k, self.e, n_t, 2), np.int64)
        self.cost = np.zeros(self.e, np.float32)
        for e, (v, i) in enumerate(edges):
            s = -steer + i * (2.0 * steer / (b - 1))
            side = abs(i - b // 2) * vel / (b - 1)
            self.cost[e] = vel + side * (1.0 if v > 0 else rev)
            for kk in range(k):
                th = (kk + 0.5) * self.binw + (v / length) * math.tan(s)
                dx, dy = v * math.cos(th), v * math.sin(th)
                self.di[kk, e] = math.floor(0.5 - dy)
                self.dj[kk, e] = math.floor(0.5 + dx)
                self.nk[kk, e] = int((th % (2.0 * math.pi)) / self.binw) % k
                for t in range(n_t):
                    f = (t + 1) / n_t
                    self.seg[kk, e, t] = (math.floor(0.5 - f * dy), math.floor(0.5 + f * dx))
        self.pad = int(np.abs(self.seg).max()) + 1
        self._planes = None

    # -- states ---------------------------------------------------------

    def start_state(self, x: float, y: float, theta: float):
        i = min(max(math.floor(self.h - y - 1.0), 0), self.h - 1)
        j = min(max(math.floor(x), 0), self.w - 1)
        k = min(int((theta % (2.0 * math.pi)) / self.binw), self.k - 1)
        return i, j, k

    def goal_gap(self, i: int, j: int, goal) -> float:
        """How far cell (i, j)'s centre lies beyond `tol` of the goal."""
        d = math.hypot(j + 0.5 - goal[0], self.h - i - 0.5 - goal[1])
        return max(0.0, d - float(self.p["tol"]))

    def feasible(self, i: int, j: int, k: int, e: int) -> bool:
        for si, sj in self.seg[k, e]:
            a, b = i + si, j + sj
            if not (0 <= a < self.h and 0 <= b < self.w and self.free[a, b]):
                return False
        return True

    # -- (a) the heading sequences along given cells -----------------------

    def chain_totals(self, start, cells):
        """(the totals of every heading sequence that joins `cells` ((i, j)
        after the start state `start` = (i, j, k)) by feasible edges,
        empty if none does; the steps that no feasible edge from any bin
        joins). A chain of cells does not fix its headings: (bin k, steer
        one way) and (bin k + 1, straight) can step to the same cell and
        bin at different costs. After a step that nothing joins, every bin
        goes on from the cell at the least total so far, so later steps
        are still checked."""
        i, j, k0 = start
        totals = {k0: {np.float32(0.0)}}
        invalid, broken = 0, False
        for ni, nj in cells:
            nxt = {}
            for k, ts in totals.items():
                for e in range(self.e):
                    if (i + self.di[k, e], j + self.dj[k, e]) != (ni, nj):
                        continue
                    if self.feasible(i, j, k, e):
                        nxt.setdefault(int(self.nk[k, e]), set()).update(
                            np.float32(t + self.cost[e]) for t in ts)
            if not nxt:
                invalid += 1
                broken = True
                least = min(min(ts) for ts in totals.values())
                nxt = {k: {least} for k in range(self.k)}
            totals, i, j = nxt, ni, nj
        return (set() if broken else {float(t) for ts in totals.values() for t in ts}), invalid

    # -- (b) the optimum -------------------------------------------------

    def _padded(self, planes, fill):
        p = self.pad
        return torch.nn.functional.pad(planes, (p, p, p, p), value=fill)

    def _shift(self, padded, src, di, dj):
        """[K, H, W]: out[n][i, j] = planes[src[n]][i + di[n], j + dj[n]],
        the pad's fill off the map (`padded` = `_padded(planes, fill)`)."""
        p = self.pad
        rows = torch.as_tensor(p + di[:, None] + np.arange(self.h), device=self.dev)
        cols = torch.as_tensor(p + dj[:, None] + np.arange(self.w), device=self.dev)
        src = torch.as_tensor(src, device=self.dev)
        return padded[src[:, None, None], rows[:, :, None], cols[:, None, :]]

    def planes(self):
        """Per edge e, bool [K, H, W]: the edge into bin n at cell (i, j)
        comes from a state whose edge e is feasible (pulled through e's
        inverse bin map); and per edge the source bin and cell shifts."""
        if self._planes is None:
            free = torch.as_tensor(self.free, dtype=torch.uint8, device=self.dev)
            free = self._padded(free[None], 0)
            ks = np.arange(self.k)
            pulled = []
            for e in range(self.e):
                ok = None
                for t in range(self.seg.shape[2]):
                    m = self._shift(free, np.zeros(self.k, np.int64), self.seg[:, e, t, 0],
                                    self.seg[:, e, t, 1]) > 0
                    ok = m if ok is None else ok & m
                if len(set(self.nk[:, e])) != self.k:
                    raise ValueError("an edge's bin map is not a bijection")
                src = np.zeros(self.k, np.int64)
                src[self.nk[:, e]] = ks
                di, dj = -self.di[src, e], -self.dj[src, e]
                ok = self._shift(self._padded(ok.to(torch.uint8), 0), src, di, dj) > 0
                pulled.append((ok, src, di, dj))
            self._planes = pulled
        return self._planes

    def goal_mask(self, goal) -> torch.Tensor:
        """bool [H, W]: cells at the goal, in f32 as the goal test runs."""
        ii = torch.arange(self.h, dtype=torch.float32, device=self.dev)[:, None]
        jj = torch.arange(self.w, dtype=torch.float32, device=self.dev)[None, :]
        gx, gy = (torch.tensor(float(v), dtype=torch.float32, device=self.dev) for v in goal[:2])
        tol = float(self.p["tol"])
        return ((jj + 0.5) - gx) ** 2 + (((self.h - ii) - 0.5) - gy) ** 2 <= tol * tol

    def optimum(self, start, goal) -> float:
        """The least cost from state `start` = (i, j, k) to any state at
        `goal` (x, y), inf when none is reachable: rounds of
        dist <- min(dist, pulled dist + edge cost) until no state improved
        on a value below the best goal value found (edge costs are
        positive, so no later round can lower it)."""
        at_goal = self.goal_mask(goal)
        dist = torch.full((self.k, self.h, self.w), INF, dtype=torch.float32, device=self.dev)
        i, j, k = start
        dist[k, i, j] = 0.0
        planes = self.planes()
        for _ in range(self.k * self.h * self.w):
            new = dist.clone()
            padded = self._padded(dist, INF)
            for e, (ok, src, di, dj) in enumerate(planes):
                came = self._shift(padded, src, di, dj) + float(self.cost[e])
                torch.minimum(new, torch.where(ok, came, INF), out=new)
            better = new < dist
            reach = torch.where(better, new, INF).min()
            goal_best = torch.where(at_goal, new.min(0).values, INF).min()
            dist = new
            reach, goal_best = torch.stack([reach, goal_best]).tolist()
            if reach >= goal_best or not math.isfinite(reach):
                return goal_best
        return float(torch.where(at_goal, dist.min(0).values, INF).min())
