"""Grid shortest paths as batched wavefront relaxation (port of
`slam_tpu/planners/astar.py`).

The reference's A* (`slam/astar.cpp:40-106`) pops one heap node at a time
over an 8-connected grid with edge costs 1 / sqrt(2). Here the Bellman
relaxation

    dist <- min(dist, shift_d(dist) + cost_d)  over the 8 directions

runs over the whole grid to its fixpoint, the exact Dijkstra distance
field from the start; the number of rounds is the longest geodesic, not
the node count. Path recovery is the reference's pointerless greedy
descent (`slam/astar.cpp:108-133`).

The JAX package's `while_loop` becomes a host loop over chunks of 32
rounds with one host read of `changed` per chunk. A round after the
fixpoint changes nothing, so the result is the JAX package's bit for bit:
min is exact and every sum is one correctly rounded f32 add. Given a
block cache (`planners/_graph.py`, as the planners pass on the card), the
chunk is a captured CUDA graph over static `free` and `dist` buffers,
replayed with the same host reads.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.planners import _graph

INF = 1e30
SQRT2 = float(np.sqrt(2.0))

# (di, dj, cost) for the 8-connected neighbourhood (`slam/util.h:76-98`).
DIRS = [
    (-1, 0, 1.0),
    (1, 0, 1.0),
    (0, -1, 1.0),
    (0, 1, 1.0),
    (-1, -1, SQRT2),
    (-1, 1, SQRT2),
    (1, -1, SQRT2),
    (1, 1, SQRT2),
]

# Relaxation rounds between two host reads of `changed`.
_CHUNK = 32


def _min_pool(a: torch.Tensor, window) -> torch.Tensor:
    """Windowed min, "SAME" size: -max_pool(-a), whose implicit -inf
    padding is +inf here (the JAX package pads with 1e30; every window
    holds its own centre, which is <= 1e30, so the mins agree)."""
    kh, kw = window
    return -torch.nn.functional.max_pool2d(
        -a[None, None], (kh, kw), stride=1, padding=(kh // 2, kw // 2)
    )[0, 0]


def relax_round(dist: torch.Tensor, free: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    """`rounds` Bellman relaxation sweeps: min(d, cross_min(d) + 1,
    pool3x3(d) + sqrt2), INF on blocked cells (the 3x3 pool also covers the
    cross and centre, which never win at cost sqrt2)."""
    for _ in range(rounds):
        cross = torch.minimum(_min_pool(dist, (3, 1)), _min_pool(dist, (1, 3)))
        best = torch.minimum(dist, cross + 1.0)
        best = torch.minimum(best, _min_pool(dist, (3, 3)) + SQRT2)
        dist = torch.where(free, best, INF)
    return dist


def _init_dist(free: torch.Tensor, start_ij) -> torch.Tensor:
    dist = torch.full(free.shape, INF, dtype=torch.float32, device=free.device)
    dist[start_ij[0], start_ij[1]] = 0.0
    return torch.where(free, dist, INF)


def distance_field(free: torch.Tensor, start_ij, graphs: "_graph.Cache | None" = None
                   ) -> torch.Tensor:
    """Exact geodesic (8-connected, 1 / sqrt2 costs) distance field from
    `start_ij` = (i, j) (host ints or 0-d tensors on `free`'s device), INF
    on blocked and unreachable cells. With a block cache `graphs` each
    chunk of rounds runs as one block (a CUDA graph replay on the card);
    without one, as eager rounds."""
    free = free.to(torch.bool)
    dist = _init_dist(free, start_ij)
    if graphs is None:
        return _relax_eager(free, dist)
    return _relax_blocks(free, dist, graphs)


def _relax_eager(free: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    h, w = free.shape
    rounds = 0
    while rounds < h * w:
        new = relax_round(dist, free, _CHUNK)
        changed = bool(torch.any(new < dist))
        dist = new
        rounds += _CHUNK
        if not changed:
            break
    return dist


def _relax_chunk(v):
    """The block of `_relax_eager`: `_CHUNK` rounds on the buffers `free`
    and `dist`, and whether they changed `dist`."""
    new = relax_round(v["dist"], v["free"], _CHUNK)
    return {"dist": new, "flag": torch.any(new < v["dist"])}


def _relax_blocks(free: torch.Tensor, dist: torch.Tensor, graphs: "_graph.Cache") -> torch.Tensor:
    """`_relax_eager` as replays of `_relax_chunk`, with the same reads."""
    h, w = free.shape
    block = graphs.get(("astar", (h, w), _CHUNK), lambda: _graph.Block(
        _relax_chunk, _graph.buffers({"free": free, "dist": dist,
                                   "flag": torch.ones((), dtype=torch.bool, device=free.device)})))
    block.load(free=free, dist=dist)
    rounds = 0
    while rounds < h * w:
        block.run()
        rounds += _CHUNK
        if not bool(block.static["flag"]):
            break
    return block.static["dist"].clone()


def recover_path(
    dist: np.ndarray, start: Tuple[int, int], goal: Tuple[int, int]
) -> List[Tuple[int, int]]:
    """Greedy steepest descent from goal to start over the distance field,
    on the host (a copy of the JAX package's)."""
    h, w = dist.shape
    path = []
    cur = tuple(goal)
    start = tuple(start)
    limit = h * w
    while cur != start and limit > 0:
        path.append(cur)
        best, best_d = None, np.inf
        for di, dj, _ in DIRS:
            ni, nj = cur[0] + di, cur[1] + dj
            if 0 <= ni < h and 0 <= nj < w and dist[ni, nj] < best_d:
                best, best_d = (ni, nj), dist[ni, nj]
        if best is None or not np.isfinite(best_d):
            return []
        cur = best
        limit -= 1
    if cur != start:
        return []
    path.append(start)
    path.reverse()
    return path


class AStar:
    """Planner facade of the reference's incremental API (`slam/astar.h:
    10-48`): construct with (map, A, B), call `pathfind()` until it
    returns True (or `solve()`), then `recover_path()`. A and B are image
    coordinates (i, j); the map is bool free cells, moved to `device`: the
    CUDA card unless the caller asks for another (`device="cpu"`)."""

    def __init__(self, free, a: Tuple[int, int], b: Tuple[int, int], device=None):
        self.free = torch.as_tensor(free, dtype=torch.bool, device=entry_device(device))
        self._graphs = _graph.Cache() if self.free.is_cuda else None
        self.a = tuple(int(v) for v in a)
        self.b = tuple(int(v) for v in b)
        self.dist = _init_dist(self.free, self.a)
        self.success = False
        self.used_up = False

    def pathfind(self, rounds: int = 32) -> bool:
        """Advance the wavefront by `rounds` rings; True once settled
        (success or exhausted)."""
        if self.used_up:
            return True
        new = relax_round(self.dist, self.free, rounds)
        done = bool(torch.all(new >= self.dist))
        self.dist = new
        if done:
            self.used_up = True
            self.success = bool(self.dist[self.b[0], self.b[1]] < INF)
        return done

    def solve(self) -> bool:
        self.dist = distance_field(self.free, self.a, self._graphs)
        self.used_up = True
        self.success = bool(self.dist[self.b[0], self.b[1]] < INF)
        return self.success

    def recover_path(self) -> List[Tuple[int, int]]:
        if not self.success:
            return []
        return recover_path(self.dist.cpu().numpy(), self.a, self.b)

    def path_cost(self) -> float:
        return float(self.dist[self.b[0], self.b[1]])
