"""RRT*: sampling-based optimal planning, batched (port of
`slam_tpu/planners/rrtstar.py`).

Reference: `slam/rrtstar.cpp`, one sample per iteration. Here each round
draws a batch of samples, answers every nearest-neighbour and radius
query as a dense masked distance tile (`ops/spatial.py`), collision-checks
every candidate edge in one raycast call and commits the batch with a
scatter-min cost resolution, over a fixed-capacity SoA node buffer. The
JAX package's deliberate fixes against the reference (steer distance
min(reach, dist), true edge lengths for the rays, full-edge neighbour
checks, a Euclidean rewire radius) are kept.

Differences of form:
  * Samples: JAX splits a key every round. Philox never reproduces those
    draws, so `solve` / `pathfind` take optional `samples` (the JAX
    draws, for tests); without them the planner draws from its
    `torch.Generator` on the device.
  * The search loop: a round past the JAX loop's stop condition would
    grow the tree, so each round runs gated by an `active` flag (the
    loop's condition evaluated on the device); an inactive round commits
    nothing. The host reads the flag once every `_FLAG_EVERY` rounds.
  * On the card `solve` is the counterpart of the JAX package's one
    device program (`_rrt_solve_query_jit`): the `_FLAG_EVERY` rounds
    between two host reads of the flag are captured once as a CUDA graph
    (`planners/_graph.py`) that draws from the planner's generator
    (registered with the graph, so a replay draws what the eager rounds
    would) and replayed until the flag says done; a device round counter
    inside the gate stops the search at `max_rounds`. The eager loop is
    the CPU path and the reference the graph is held to; `pathfind`
    stays eager.
  * Ties: `top_k` returns equal values lowest index first, which
    `torch.topk` does not promise, so the neighbours come from a stable
    sort. The rewire writes each re-parented node from one candidate,
    the highest-numbered one (the one XLA:CPU's sequential scatter
    keeps), so CUDA's unordered scatter cannot pick another.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from slam_tpu_torch.core.config import RaycastConfig, RRTStarConfig
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.ops import spatial
from slam_tpu_torch.ops.edt import _sqrt
from slam_tpu_torch.ops.rayfield import RayField, make_ray_field, raycast_field
from slam_tpu_torch.planners import _graph
from slam_tpu_torch.planners._scatter import last_writer, set_drop

INF = 1e30

# Search rounds between two host reads of the loop's `active` flag.
_FLAG_EVERY = 8


@dataclasses.dataclass
class RRTState:
    x: torch.Tensor  # f32[N] node world-x
    y: torch.Tensor  # f32[N]
    cost: torch.Tensor  # f32[N] cost from root
    parent: torch.Tensor  # i32[N] (-1 for root / unset)
    valid: torch.Tensor  # bool[N]
    size: torch.Tensor  # i32 nodes used
    best_goal_node: torch.Tensor  # i32 (-1 until success)
    best_goal_cost: torch.Tensor  # f32 total cost through that node to goal

    def replace(self, **changes) -> "RRTState":
        return dataclasses.replace(self, **changes)


def _edges_clear(field: RayField, rc: RaycastConfig, x0, y0, x1, y1, early_exit: bool = True):
    """Straight-line feasibility of a batch of edges: the endpoint is free
    and in bounds and no obstacle lies strictly before it. `early_exit`
    False traces the rays' whole count with no host read (the same
    result)."""
    h, w = field.blocked.shape
    dx = x1 - x0
    dy = y1 - y0
    d = _sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)
    i = torch.floor(h - y1 - 1.0).to(torch.int32)
    j = torch.floor(x1).to(torch.int32)
    inb = (i >= 0) & (i < h) & (j >= 0) & (j < w)
    ic = torch.clamp(i, 0, h - 1).long()
    jc = torch.clamp(j, 0, w - 1).long()
    dst_free = ~field.blocked[ic, jc] & inb
    hd, hit = raycast_field(field, x0, y0, ang, rc, early_exit)
    return dst_free & (~hit | (hd >= d)) & (d > 0)


def _rrt_round(
    st: RRTState,
    field: RayField,
    goal: torch.Tensor,
    cfg: RRTStarConfig,
    rc: RaycastConfig,
    neighbor_cap: int,
    sx: torch.Tensor,
    sy: torch.Tensor,
    active: Optional[torch.Tensor] = None,
    early_exit: bool = True,
) -> RRTState:
    """One batched round on the samples (sx, sy) f32[batch]; with
    `active` False (a 0-d bool tensor) it changes nothing. `early_exit`
    False: the edge rays run their whole count (a captured block's form)."""
    k = cfg.batch
    m = neighbor_cap
    n = cfg.max_nodes
    bx, by = goal[0], goal[1]

    # Nearest tree node per sample, then steer min(reach, dist) toward it.
    nn_idx, nn_dist = spatial.nearest_neighbor(st.x, st.y, st.valid, sx, sy)
    nn_l = nn_idx.long()
    rx = st.x[nn_l]
    ry = st.y[nn_l]
    step_d = torch.clamp(nn_dist, max=cfg.reach)
    scale = step_d / torch.clamp(nn_dist, min=1e-9)
    cx = rx + (sx - rx) * scale
    cy = ry + (sy - ry) * scale

    # The m nearest in-radius nodes of each candidate; a stable descending
    # sort ranks equal keys lowest index first, as top_k.
    d2 = spatial.sq_dist_tile(st.x, st.y, cx, cy)
    d2 = torch.where(st.valid[None, :], d2, INF)
    in_rad = d2 <= cfg.radius * cfg.radius
    key = torch.where(in_rad, -d2, -INF)
    neg_d2, nbr = torch.sort(key, dim=1, descending=True, stable=True)
    neg_d2, nbr = neg_d2[:, :m], nbr[:, :m]
    nbr_ok = -neg_d2 < INF  # [K, M]
    nbx = st.x[nbr]
    nby = st.y[nbr]

    # One collision check for the steer edges, the neighbour edges and the
    # goal edges (a ray's result does not depend on its batch).
    cxm = cx[:, None].expand_as(nbx).reshape(-1)
    cym = cy[:, None].expand_as(nbx).reshape(-1)
    clear = _edges_clear(
        field, rc,
        torch.cat([rx, nbx.reshape(-1), cx]), torch.cat([ry, nby.reshape(-1), cy]),
        torch.cat([cx, cxm, bx.expand(k)]), torch.cat([cy, cym, by.expand(k)]),
        early_exit,
    )
    ok, nbr_clear, goal_clear = clear.split([k, k * m, k])
    if active is not None:
        ok = ok & active

    # Choose the parent among the neighbours (`slam/rrtstar.cpp:91-105`).
    ndist = _sqrt((nbx - cx[:, None]) ** 2 + (nby - cy[:, None]) ** 2)
    reach_ok = nbr_ok & nbr_clear.reshape(k, m)
    through = torch.where(reach_ok, st.cost[nbr] + ndist, INF)
    pbest = torch.argmin(through, dim=1, keepdim=True)
    new_cost = torch.gather(through, 1, pbest)[:, 0]
    new_parent = torch.gather(nbr, 1, pbest)[:, 0].to(torch.int32)
    ok = ok & (new_cost < INF)

    # Compact the accepted candidates into fresh slots.
    offs = torch.cumsum(ok.to(torch.int32), 0, dtype=torch.int32) - 1
    slots = torch.where(ok, st.size + offs, n)
    ok = ok & (slots < n)
    slots = torch.where(ok, slots, n)

    x = set_drop(st.x, slots, cx)
    y = set_drop(st.y, slots, cy)
    cost = set_drop(st.cost, slots, new_cost)
    parent = set_drop(st.parent, slots, new_parent)
    valid = set_drop(st.valid, slots, True)
    size = st.size + ok.sum(dtype=torch.int32)

    # Rewire in-radius neighbours through the new nodes when cheaper.
    rew_cand = torch.where(reach_ok & ok[:, None], new_cost[:, None] + ndist, INF)
    nbr_f = nbr.reshape(-1)
    cand_f = rew_cand.reshape(-1)
    improved = cost.scatter_reduce(0, nbr_f, cand_f, "amin", include_self=True)
    won = (cand_f <= improved[nbr_f]) & (cand_f < INF) & (cand_f < cost[nbr_f])
    won = last_writer(won, nbr_f, n)
    slot_src = slots[:, None].expand(k, m).reshape(-1).to(torch.int32)
    parent = set_drop(parent, torch.where(won, nbr_f, n), slot_src)
    cost = improved

    # Goal connection (`slam/rrtstar.cpp:146-155`).
    dgoal = _sqrt((cx - bx) ** 2 + (cy - by) ** 2)
    can_goal = ok & (dgoal <= cfg.reach) & goal_clear
    total = torch.where(can_goal, new_cost + dgoal, INF)
    # A 0-d index tensor would be read on the host: gather instead.
    gbest = torch.argmin(total).reshape(1)
    gcost = total.gather(0, gbest)[0]
    better = gcost < st.best_goal_cost
    return RRTState(
        x=x,
        y=y,
        cost=cost,
        parent=parent,
        valid=valid,
        size=size,
        best_goal_node=torch.where(better, slots.gather(0, gbest)[0], st.best_goal_node),
        best_goal_cost=torch.where(better, gcost, st.best_goal_cost),
    )


def _rrt_query_init(a_xy, n: int, device) -> RRTState:
    """A fresh tree holding the root `a_xy` = (x, y)."""

    def fill(v, dtype):
        return torch.full((n,), v, dtype=dtype, device=device)

    x, y, valid = fill(0.0, torch.float32), fill(0.0, torch.float32), fill(False, torch.bool)
    x[0], y[0], valid[0] = float(a_xy[0]), float(a_xy[1]), True
    cost = fill(INF, torch.float32)
    cost[0] = 0.0

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    return RRTState(
        x=x, y=y, cost=cost, parent=fill(-1, torch.int32), valid=valid,
        size=scalar(1, torch.int32), best_goal_node=scalar(-1, torch.int32),
        best_goal_cost=scalar(INF, torch.float32),
    )


def _rrt_flag(st, min_nodes, max_nodes: int):
    """The loop's condition without its round bound."""
    want_more = (st.best_goal_node < 0) | (st.size < min_nodes)
    return want_more & (st.size < max_nodes)


def _rrt_solve(st, field, goal, max_rounds, min_nodes, cfg, rc, neighbor_cap, draw):
    """The JAX loop: rounds until a goal connection exists AND the tree
    holds `min_nodes` (`apps/rrt_planner.cpp:50`), the node budget is
    spent, or `max_rounds` pass. `draw(r)` gives round r's samples.
    Returns (state, rounds run: an i32 tensor counted on the device,
    rounds launched, host reads of the flag)."""
    rounds = torch.zeros((), dtype=torch.int32, device=st.size.device)
    r = reads = 0
    while r < max_rounds:
        active = _rrt_flag(st, min_nodes, cfg.max_nodes)
        if r % _FLAG_EVERY == 0:
            reads += 1
            if not bool(active):
                break
        sx, sy = draw(r)
        st = _rrt_round(st, field, goal, cfg, rc, neighbor_cap, sx, sy, active)
        rounds = rounds + active.to(torch.int32)
        r += 1
    return st, rounds, r, reads


_RRT_FIELDS = tuple(f.name for f in dataclasses.fields(RRTState))


def _uniform_draw(generator, shape, k: int, dev):
    """One round's uniform samples over a map of `shape` from `generator`."""
    h, w = shape
    u = torch.rand((2, k), generator=generator, device=dev)
    return u[0] * float(w), u[1] * float(h)


def _rrt_block(v, field, cfg, rc, neighbor_cap, shape, generator):
    """`_FLAG_EVERY` rounds of `_rrt_solve`'s loop on the block buffers
    `v` (the state's fields, goal, rounds, min_nodes, the round counter
    `it` and its `limit`; with `generator` None, the injected draws
    `samples` f32[_FLAG_EVERY, 2, batch]). The counter is in the gate, so
    rounds past `limit` commit nothing; every round draws, as the eager
    loop's do. The edge rays run their whole count, with no host read."""
    st = RRTState(**{f: v[f] for f in _RRT_FIELDS})
    rounds, it = v["rounds"], v["it"]
    for r in range(_FLAG_EVERY):
        active = _rrt_flag(st, v["min_nodes"], cfg.max_nodes) & (it < v["limit"])
        if generator is None:
            sx, sy = v["samples"][r, 0], v["samples"][r, 1]
        else:
            sx, sy = _uniform_draw(generator, shape, cfg.batch, st.x.device)
        st = _rrt_round(st, field, v["goal"], cfg, rc, neighbor_cap, sx, sy, active,
                        early_exit=False)
        rounds = rounds + active.to(torch.int32)
        it = it + 1
    return {**{f: getattr(st, f) for f in _RRT_FIELDS}, "rounds": rounds, "it": it,
            "flag": _rrt_flag(st, v["min_nodes"], cfg.max_nodes)}


def _rrt_solve_blocks(st, field, goal, max_rounds, min_nodes, cfg, rc, neighbor_cap, shape,
                      generator, samples, graphs):
    """`_rrt_solve` as runs of `_rrt_block` from the cache `graphs` (a
    CUDA graph replay each on the card): the same state, rounds and draws.
    `samples` (f32[R, 2, batch] on the device, R >= max_rounds) injects the
    draws, copied block by block into the block's buffer before its run;
    else the block draws from `generator`. Where `max_rounds` ends the
    search, the last block runs (and draws for) up to `_FLAG_EVERY - 1`
    gated rounds past it. Returns as `_rrt_solve`, rounds launched counted
    in whole blocks."""
    dev = st.size.device
    init = {**{f: getattr(st, f) for f in _RRT_FIELDS}, "goal": goal,
            "rounds": torch.zeros_like(st.size),
            "min_nodes": torch.full((), min_nodes, dtype=torch.int32, device=dev),
            "it": torch.zeros((), dtype=torch.int32, device=dev),
            "limit": torch.full((), max_rounds, dtype=torch.int32, device=dev),
            "flag": _rrt_flag(st, min_nodes, cfg.max_nodes)}
    if samples is not None:
        rows = -(-max_rounds // _FLAG_EVERY) * _FLAG_EVERY
        samples = torch.nn.functional.pad(samples[:max_rounds],
                                          (0, 0, 0, 0, 0, rows - min(max_rounds, len(samples))))
        init["samples"] = samples[:_FLAG_EVERY]
    gen = None if samples is not None else generator
    block = graphs.get(
        ("rrt", shape, cfg, rc, neighbor_cap, gen is None, _FLAG_EVERY),
        lambda: _graph.Block(functools.partial(_rrt_block, field=field, cfg=cfg, rc=rc,
                                               neighbor_cap=neighbor_cap, shape=shape,
                                               generator=gen),
                             _graph.buffers(init), generators=() if gen is None else (gen,)),
    )
    block.load(**init)
    it = reads = 0
    while it < max_rounds:
        reads += 1
        if not bool(block.static["flag"]):
            break
        if samples is not None:
            block.load(samples=samples[it:it + _FLAG_EVERY])
        block.run()
        it += _FLAG_EVERY
    out = RRTState(**{f: block.static[f].clone() for f in _RRT_FIELDS})
    return out, block.static["rounds"].clone(), it, reads


class RRTStar:
    """Facade of `slam/rrtstar.h:12-64`: `pathfind()` per round or
    `solve()`, then `recover_path()`. Coordinates are world (x, y); the
    map moves to `device`, where the search runs: the CUDA card unless the
    caller asks for another (`device="cpu"`)."""

    def __init__(
        self,
        free,
        a: Tuple[float, float],
        b: Tuple[float, float],
        cfg: RRTStarConfig = RRTStarConfig(),
        rc: RaycastConfig = RaycastConfig(backend="sdf", step=1.0),
        seed: int = 0,
        neighbor_cap: int = 16,
        device=None,
    ):
        if cfg.radius < cfg.reach:
            raise ValueError("radius must cover reach")
        self.cfg = cfg
        # Edges are bounded by the rewire radius; clamping the rays keeps
        # every sphere trace to a handful of iterations.
        self.rc = dataclasses.replace(rc, max_dist=min(rc.max_dist, cfg.radius + 2.0))
        self.neighbor_cap = neighbor_cap
        free = torch.as_tensor(free, dtype=torch.bool, device=entry_device(device))
        self.device = free.device
        self.shape = tuple(free.shape)
        self.field = make_ray_field(~free, self.rc)
        # One generator for the planner's life (a query reseeds it): the
        # search block's CUDA graph is registered with it.
        self.generator = torch.Generator(device=self.device)
        self._graphs = _graph.Cache()
        self.reset_query(a, b, seed)

    def reset_query(self, a, b, seed: int = 0):
        """Re-target start and goal on the same map (the ray field stays);
        `seed` seeds the planner's generator."""
        self.a = (float(a[0]), float(a[1]))
        self.b = (float(b[0]), float(b[1]))
        self._goal = torch.tensor(self.b, dtype=torch.float32, device=self.device)
        self.success = False
        self.used_up = False
        self.generator.manual_seed(seed)
        self.state = _rrt_query_init(self.a, self.cfg.max_nodes, self.device)
        # Rounds run since the query began; of the last solve, rounds
        # launched (gated ones included) and host reads (the loop's flag
        # reads and the final reads of rounds, goal node and size).
        self.rounds = self.launched = self.host_reads = 0

    def _draw(self, samples, r: int):
        """Round r's samples: row r of the injected (sx, sy) f32[R, batch]
        arrays, else uniform draws over the map from the generator."""
        if samples is not None:
            sx, sy = samples
            return (torch.as_tensor(sx[r], dtype=torch.float32, device=self.device),
                    torch.as_tensor(sy[r], dtype=torch.float32, device=self.device))
        return _uniform_draw(self.generator, self.shape, self.cfg.batch, self.device)

    @property
    def size(self) -> int:
        return int(self.state.size)

    def _latch(self):
        if int(self.state.best_goal_node) >= 0:
            self.success = True
        if int(self.state.size) >= self.cfg.max_nodes:
            self.used_up = True

    def pathfind(self, samples=None) -> bool:
        """One batched round; True once a goal connection exists or the
        node budget is spent. `samples` = (sx, sy) f32[batch] injects the
        round's draws."""
        if self.used_up:
            return True
        if samples is None:
            sx, sy = self._draw(None, 0)
        else:
            sx, sy = self._draw(([samples[0]], [samples[1]]), 0)
        self.state = _rrt_round(self.state, self.field, self._goal, self.cfg, self.rc,
                                self.neighbor_cap, sx, sy)
        self.rounds += 1
        self._latch()
        return self.success or self.used_up

    def solve(self, max_rounds: int = 256, min_nodes: int = 0, samples=None) -> bool:
        """Search until a goal connection exists and the tree holds
        `min_nodes`, the budget is spent or `max_rounds` pass. `samples` =
        (sx, sy) f32[max_rounds, batch] injects every round's draws. On the
        card the search runs as CUDA graph replays, elsewhere as an eager
        loop (the same result)."""
        graphs = self._graphs if self.device.type == "cuda" else None
        return self._solve(max_rounds, min_nodes, samples, graphs)

    def _solve(self, max_rounds: int, min_nodes: int, samples, graphs) -> bool:
        """`solve` through the blocks of `graphs`, or the eager loop when
        None (the reference a check on the card holds the graph to)."""
        if graphs is None:
            self.state, rounds, self.launched, reads = _rrt_solve(
                self.state, self.field, self._goal, max_rounds, min_nodes, self.cfg,
                self.rc, self.neighbor_cap, lambda r: self._draw(samples, r),
            )
        else:
            if samples is not None:
                samples = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=self.device)
                                       for v in samples], 1)
            self.state, rounds, self.launched, reads = _rrt_solve_blocks(
                self.state, self.field, self._goal, max_rounds, min_nodes, self.cfg,
                self.rc, self.neighbor_cap, self.shape, self.generator, samples, graphs,
            )
        self.rounds += int(rounds)
        self.host_reads = reads + 3
        self._latch()
        return self.success

    def recover_path(self) -> List[Tuple[float, float]]:
        """Goal -> start node chain (`slam/rrtstar.cpp:166-179` order)."""
        if not self.success:
            return []
        xs = self.state.x.cpu().numpy()
        ys = self.state.y.cpu().numpy()
        parent = self.state.parent.cpu().numpy()
        path = [(self.b[0], self.b[1])]
        idx = int(self.state.best_goal_node)
        hops = 0
        while idx >= 0 and hops <= len(parent):
            path.append((float(xs[idx]), float(ys[idx])))
            idx = int(parent[idx])
            hops += 1
        return path

    def path_cost(self) -> float:
        return float(self.state.best_goal_cost)
