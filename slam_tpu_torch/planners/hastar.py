"""Hybrid A*: kinematically feasible SE(2) planning, batched (port of
`slam_tpu/planners/hastar.py`).

Reference: `slam/hastar.{h,cpp}`. A state is a continuous pose deduplicated
into a rows x cols x theta_res cuboid; successors are bicycle-model
steering arcs for `branching_factor` steer angles and velocities {+v, -v}
(`slam/hastar.cpp:88-112`); success is the first expansion within `tol` of
the goal. Each round pops `batch` open states at once, expands all their
successors and commits improvements with a scatter-min. Two modes, as in
the JAX package:

  * ``lattice`` (the suite's default): states snap to cell and bin
    centres, so successors are static per-bin offset tables, edge
    feasibility is a precomputed bit per (state, lane) and the frontier is
    a compact ring of (state, f) entries. One i32 word per state packs the
    quantized cost with the parent edge id.
  * ``continuous``: the exact entrant pose per cuboid cell, edge checks by
    raycast through the configured ray backend.

What differs in form, and why the results stay the JAX package's:
  * A round past the loop's stop condition is not a no-op (it pops,
    commits and counts), so every round is gated by an `active` flag, the
    loop's condition evaluated on the device: an inactive round pops
    nothing, and a round with no pops changes nothing. The lattice loop
    runs two rounds per iteration and tests its condition only between
    pairs, as the JAX loop does.
  * `solve_many` stacks Q queries on a leading axis (JAX's `vmap`): each
    query has its own flag, so a finished query stays frozen while the
    others go on.
  * `mode="drop"` scatters write a spare slot past the end of the array;
    `.at[].min` is `scatter_reduce(..., "amin")`. The search loops own
    their state, so they keep the spare slot in the arrays and commit
    every scatter in place: a round copies no [S] or ring array.
  * Duplicate-target `set` scatters (continuous mode's parent and pose,
    ring slots when one round inserts more than the ring holds) write
    every array from ONE lane per target, the last one, which is the lane
    XLA:CPU's sequential scatter keeps; CUDA's unordered scatter could
    otherwise mix a parent from one candidate with a pose from another.
  * The u32 feasibility words are int32 here (bit b is read as
    `(w >> b) & 1`); the bits equal the JAX package's.
  * The feasibility build gathers every (bin, lane) shift of a plane in
    one batched indexing op per sample, not one eager op per shift.
  * Spans and counters (`utils/profiling.py`, recorded only while a
    profiler session records): `solve` is the root `HybridAStar.solve`,
    with `hastar.init` (the query init, timed on the device) and
    `hastar.search` (the search's host loop; on the card the search
    chain's graph stamps the device time of each replay under the same
    name, outside its WHILE node's body); `recover_path` is the root
    `HybridAStar.recover_path` with the host span `hastar.path`. Each
    solve counts `hastar.rounds`, `hastar.n_expanded`, `hastar.n_lost` and
    `hastar.host_reads`; a lattice path walk counts its host reads and
    its kernel launches (`hastar.path_launches`); `stats()` gives the last
    query's counters and the search blocks' captures and replays.
  * The lattice parent-chain walk (JAX's `lax.scan`) is one kernel launch
    a chunk on the card (`csrc/lattice_chain.cu`), which reads the goal
    and start indices on the device and stops where the chain ends, with
    one host read of the chunk's header and cells; on the CPU it is the
    eager walk, `_lattice_chain_device` and `_lattice_chain_cost`, the
    kernel's reference. The route follows the words' device.
  * A search is the counterpart of the JAX package's one device program
    (`_lattice_solve_query_jit`, `_ha_solve_query_jit`,
    `_lattice_solve_many_jit`): the run of `_FLAG_EVERY` loop iterations
    between two tests of the flag is one block, and a chain of up to
    `_CHAIN_RUNS` such blocks runs with one host read of the flag, each
    block behind the flag the one before it wrote (`planners/_graph.py`).
    On the card a run of the chain is one replay of a captured CUDA graph
    (one WHILE node); on the CPU the same block code runs eagerly. The
    query init's A* wavefront runs the same way. A device iteration
    counter inside the gate stops the rounds at `max_rounds`, as the JAX
    loop's condition does. `pathfind` runs one round eagerly.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from slam_tpu_torch.core.config import HybridAStarConfig, RaycastConfig
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Pose
from slam_tpu_torch.ops import lattice_chain_cuda
from slam_tpu_torch.ops.edt import _sqrt
from slam_tpu_torch.ops.rayfield import RayField, make_ray_field, raycast_field
from slam_tpu_torch.planners import _graph
from slam_tpu_torch.planners import astar as astar_mod
from slam_tpu_torch.planners._scatter import last_writer, set_drop, set_drop_
from slam_tpu_torch.utils import profiling

INF = 1e30

# Search loop iterations in one block (the loop's flag is tested between
# blocks).
_FLAG_EVERY = 4
# Blocks a chain runs a replay at most: the suite's lattice query (122
# rounds, 16 blocks) and a continuous query fit in one replay.
_CHAIN_RUNS = 32
# Eager (CPU) parent-chain walk steps between two host reads of `done`.
_CHAIN_CHECK = 64


@dataclasses.dataclass
class HAState:
    g: torch.Tensor  # f32[S] best committed cost per cuboid cell
    parent: torch.Tensor  # i32[S] predecessor cuboid index (-1 = none)
    px: torch.Tensor  # f32[S] continuous pose of the best entrant
    py: torch.Tensor
    pth: torch.Tensor
    open_f: torch.Tensor  # f32[S] g + h of open cells, INF otherwise
    goal_idx: torch.Tensor  # i32 cuboid index of the first in-tolerance pop
    goal_cost: torch.Tensor  # f32
    n_expanded: torch.Tensor  # i32
    start_idx: torch.Tensor  # i32 the seeded start cuboid index

    def replace(self, **changes) -> "HAState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class LatticeState:
    """Lattice search state: one packed (cost << _EDGE_BITS | parent edge)
    word per cuboid state and a [capacity] ring of not-yet-popped (state,
    f) entries. A `solve_many` state has a leading query axis on every
    field."""

    gp: torch.Tensor  # i32[S] packed words; _INF_PACKED = unset
    o_idx: torch.Tensor  # i32[C] cuboid index per open entry
    o_f: torch.Tensor  # f32[C] f = g + h at insert time (INF = empty slot)
    wp: torch.Tensor  # i32 ring write pointer (total insertions)
    goal_idx: torch.Tensor
    goal_cost: torch.Tensor
    n_expanded: torch.Tensor
    # i32: live ring entries overwritten by wraparound; > 0 makes an
    # exhaustion verdict inconclusive (solve logs a warning).
    n_lost: torch.Tensor
    start_idx: torch.Tensor

    def replace(self, **changes) -> "LatticeState":
        return dataclasses.replace(self, **changes)


def _map_state(st, fn):
    return dataclasses.replace(
        st, **{f.name: fn(getattr(st, f.name)) for f in dataclasses.fields(st)}
    )


def _pose_to_cuboid(shape, k, x, y, theta):
    """Cuboid flat index of pose(s) (`slam/hastar.cpp:234-241`)."""
    h, w = shape
    i = torch.clamp(torch.floor(h - y - 1.0).to(torch.int32), 0, h - 1)
    j = torch.clamp(torch.floor(x).to(torch.int32), 0, w - 1)
    ang = torch.remainder(theta + 2 * math.pi, 2 * math.pi)
    kk = torch.clamp((ang / (2 * math.pi / k)).to(torch.int32), 0, k - 1)
    return (i * w + j) * k + kk


def _steering_tables(cfg: HybridAStarConfig):
    """Steer angles and their costs (`slam/hastar.cpp:68-80`)."""
    b = cfg.branching_factor
    if b <= 2 or b % 2 == 0:
        raise ValueError("branching_factor must be odd >= 3")
    cost_slope = cfg.velocity / (b - 1)
    dtheta = cfg.max_steering * 2 / (b - 1)
    mid = b // 2
    thetas = [-cfg.max_steering + i * dtheta for i in range(b)]
    costs = [abs(i - mid) * cost_slope for i in range(b)]
    return np.asarray(thetas, np.float32), np.asarray(costs, np.float32)


@functools.lru_cache(maxsize=16)
def _fan_tables(cfg: HybridAStarConfig, dev: torch.device):
    """The successor fan's constants on `dev`, [1, 2, B] each: velocity,
    heading change (v / L) tan(steer), edge cost. Built once per (cfg,
    device): a host-to-device copy in every round would sync the stream."""
    thetas, steer_costs = _steering_tables(cfg)
    vels = torch.tensor([cfg.velocity, -cfg.velocity], dtype=torch.float32)[None, :, None]
    cost_factor = torch.tensor([1.0, cfg.reverse_factor], dtype=torch.float32)
    tan_t = torch.tan(torch.from_numpy(thetas).to(dev))[None, None, :]
    vels = vels.to(dev)
    turn = (vels / cfg.length) * tan_t
    ecost = cfg.velocity + (
        torch.from_numpy(steer_costs)[None, None, :] * cost_factor[None, :, None]
    ).to(dev)
    return vels, turn, ecost


def _ha_round(
    st: HAState,
    field: RayField,
    goal: torch.Tensor,
    target_bin: torch.Tensor,
    hfield: torch.Tensor,
    cfg: HybridAStarConfig,
    rc: RaycastConfig,
    active: Optional[torch.Tensor] = None,
    inplace: bool = False,
    early_exit: bool = True,
) -> HAState:
    """One continuous-mode expansion round; with `active` False (a 0-d
    bool tensor) it changes nothing. `inplace` commits into the state's
    own arrays (a search block's buffers, with spare slots);
    `early_exit` False runs the edge rays' whole count with no host read
    (the same result; the form a captured block needs)."""
    h, w = field.blocked.shape
    shape = (h, w)
    dev = st.g.device
    kbins = cfg.theta_res
    kpop = cfg.batch
    bx, by = goal[0], goal[1]

    f = st.open_f
    s = f.shape[0]
    if cfg.selection == "grouped":
        # Best open node per strided index group.
        pad = (-s) % kpop
        f2 = torch.nn.functional.pad(f, (0, pad), value=INF).reshape(-1, kpop)
        rel = torch.argmin(f2, dim=0)
        cols = torch.arange(kpop, dtype=torch.int32, device=dev)
        pop = rel.to(torch.int32) * kpop + cols
        fpop = torch.gather(f2, 0, rel[None, :])[0]
        pop_valid = (fpop < INF) & (pop < s)
        pop = torch.where(pop_valid, pop, 0)
    elif cfg.selection == "topk":
        # top_k of -f: the smallest f, equal values lowest index first.
        fs, order = torch.sort(f, stable=True)
        fpop, pop = fs[:kpop], order[:kpop].to(torch.int32)
        pop_valid = fpop < INF
    else:
        raise ValueError(f"unknown selection: {cfg.selection}")
    if active is not None:
        pop_valid = pop_valid & active

    drop = set_drop_ if inplace else set_drop
    open_f = drop(f, torch.where(pop_valid, pop, s), INF)
    pop_l = pop.long()
    gx = st.px[pop_l]
    gy = st.py[pop_l]
    gth = st.pth[pop_l]
    gg = st.g[pop_l]

    # Goal test on popped nodes (`slam/hastar.cpp:178-184`).
    d2goal = (gx - bx) ** 2 + (gy - by) ** 2
    bin_of = _pose_to_cuboid(shape, kbins, gx, gy, gth) % kbins
    bin_ok = cfg.diff_drive | (bin_of == target_bin)
    at_goal = (d2goal <= cfg.tol * cfg.tol) & bin_ok & pop_valid
    first = torch.argmin(torch.where(at_goal, fpop, INF))
    goal_better = at_goal.any() & (st.goal_idx < 0)
    # A 0-d index tensor would be read on the host: gather instead.
    first = first.reshape(1)
    goal_idx = torch.where(goal_better, pop.gather(0, first)[0], st.goal_idx)
    goal_cost = torch.where(goal_better, gg.gather(0, first)[0], st.goal_cost)

    # Successor fan [batch, 2, B] (`slam/hastar.cpp:88-112`).
    vels, turn, ecost = _fan_tables(cfg, dev)
    nth = gth[:, None, None] + turn
    nx = gx[:, None, None] + vels * torch.cos(nth)
    ny = gy[:, None, None] + vels * torch.sin(nth)

    # Feasibility: a free in-bounds destination and a clear straight line.
    dx = nx - gx[:, None, None]
    dy = ny - gy[:, None, None]
    edge_len = _sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)
    di = torch.floor(h - ny - 1.0).to(torch.int32)
    dj = torch.floor(nx).to(torch.int32)
    inb = (di >= 0) & (di < h) & (dj >= 0) & (dj < w)
    dic = torch.clamp(di, 0, h - 1).long()
    djc = torch.clamp(dj, 0, w - 1).long()
    dst_free = ~field.blocked[dic, djc] & inb
    hit_d, hit = raycast_field(
        field, gx[:, None, None].expand_as(nx), gy[:, None, None].expand_as(nx), ang, rc,
        early_exit,
    )
    clear = ~hit | (hit_d >= edge_len)
    ok = dst_free & clear & pop_valid[:, None, None]

    tgt = _pose_to_cuboid(shape, kbins, nx, ny, nth).long()
    cand = torch.where(ok, gg[:, None, None] + ecost, INF)
    cand = torch.where(cand < st.g[tgt], cand, INF)  # improvements only

    tgt_f = tgt.reshape(-1)
    cand_f = cand.reshape(-1)
    commit = st.g.scatter_reduce_ if inplace else st.g.scatter_reduce
    g = commit(0, tgt_f, cand_f, "amin", include_self=True)
    won = (cand_f <= g[tgt_f]) & (cand_f < INF)
    tgt_w = torch.where(last_writer(won, tgt_f, s), tgt_f, s)
    parent = drop(st.parent, tgt_w, pop[:, None, None].expand(nx.shape).reshape(-1))
    px = drop(st.px, tgt_w, nx.reshape(-1))
    py = drop(st.py, tgt_w, ny.reshape(-1))
    pth = drop(st.pth, tgt_w, nth.reshape(-1))

    # Open priority for the winners; an INF heuristic keeps a cell dead.
    if cfg.heuristic == "geodesic":
        hnew = hfield[tgt_f]
    else:
        hnew = cfg.heuristic_weight * _sqrt(
            (nx.reshape(-1) - bx) ** 2 + (ny.reshape(-1) - by) ** 2
        )
    fnew = torch.where((cand_f < INF) & (hnew < INF), cand_f + hnew, INF)
    commit = open_f.scatter_reduce_ if inplace else open_f.scatter_reduce
    open_f = commit(0, tgt_f, torch.where(won, fnew, INF), "amin")

    return HAState(
        g=g,
        parent=parent,
        px=px,
        py=py,
        pth=pth,
        open_f=open_f,
        goal_idx=goal_idx,
        goal_cost=goal_cost,
        n_expanded=st.n_expanded + pop_valid.sum(dtype=torch.int32),
        start_idx=st.start_idx,
    )


def _lattice_tables(cfg: HybridAStarConfig, shape):
    """Per-theta-bin successor tables for cell-centre lattice states (a
    copy of the JAX package's host build): flat_off, di, dj, cost [K, E],
    seg [K, E, T, 2] (cell shifts sampled along each edge), inv_off [K, E]
    (flat_off of the edge-e predecessor of a node in bin k) and nk [K, E]
    (target bin)."""
    h, w = shape
    k = cfg.theta_res
    thetas, steer_costs = _steering_tables(cfg)
    vels = np.asarray([cfg.velocity, -cfg.velocity], np.float32)
    cfac = np.asarray([1.0, cfg.reverse_factor], np.float32)
    n_samples = max(2, int(math.ceil(cfg.velocity)))

    e = 2 * len(thetas)
    flat_off = np.zeros((k, e), np.int32)
    di_t = np.zeros((k, e), np.int32)
    dj_t = np.zeros((k, e), np.int32)
    cost_t = np.zeros((k, e), np.float32)
    nk_t = np.zeros((k, e), np.int32)
    seg = np.zeros((k, e, n_samples, 2), np.int32)
    binw = 2.0 * math.pi / k
    for kk in range(k):
        thc = (kk + 0.5) * binw
        ei = 0
        for vi, v in enumerate(vels):
            for si, st_ang in enumerate(thetas):
                nth = thc + (v / cfg.length) * math.tan(st_ang)
                dx = float(v * math.cos(nth))
                dy = float(v * math.sin(nth))
                dj = math.floor(0.5 + dx)
                di = math.floor(0.5 - dy)
                nk = int((nth % (2 * math.pi)) / binw) % k
                flat_off[kk, ei] = (di * w + dj) * k + (nk - kk)
                di_t[kk, ei] = di
                dj_t[kk, ei] = dj
                cost_t[kk, ei] = cfg.velocity + steer_costs[si] * cfac[vi]
                nk_t[kk, ei] = nk
                for t in range(n_samples):
                    f = (t + 1) / n_samples
                    seg[kk, ei, t, 0] = math.floor(0.5 - f * dy)
                    seg[kk, ei, t, 1] = math.floor(0.5 + f * dx)
                ei += 1
    inv_off = np.zeros((k, e), np.int32)
    for ei in range(e):
        if len(set(nk_t[:, ei])) != k:
            raise ValueError("edge bin shift must be a bijection")
        for kk in range(k):
            inv_off[nk_t[kk, ei], ei] = flat_off[kk, ei]
    # Headings snap to bin centres, so a max-steer edge must cross half a
    # bin or the search can never turn.
    turn = cfg.velocity / cfg.length * math.tan(cfg.max_steering)
    if turn < binw / 2:
        need = int(math.ceil(math.pi / turn))
        raise ValueError(
            f"lattice mode: per-edge heading change {math.degrees(turn):.1f} "
            f"deg cannot cross a {math.degrees(binw):.1f}-deg theta bin; "
            f"raise theta_res to >= {need} (or use mode='continuous')"
        )
    return flat_off, di_t, dj_t, cost_t, seg, inv_off, nk_t


def _lane_seqs(cfg, e: int):
    """Expansion lanes as edge-id sequences: the E single edges, the
    repetitions e^r (r = 2..lattice_reps), and at lattice_depth=2 all E^2
    pairs (deduplicated, order kept)."""
    if cfg.lattice_depth not in (1, 2):
        raise ValueError(f"lattice_depth must be 1 or 2, got {cfg.lattice_depth}")
    if cfg.lattice_reps < 1:
        raise ValueError(f"lattice_reps must be >= 1, got {cfg.lattice_reps}")
    seqs = [(ei,) for ei in range(e)]
    for r in range(2, cfg.lattice_reps + 1):
        seqs += [(ei,) * r for ei in range(e)]
    if cfg.lattice_depth == 2:
        seqs += [(e1, e2) for e1 in range(e) for e2 in range(e)]
    return list(dict.fromkeys(seqs))


def _lattice_lane_tables(cfg, flat_off, di_t, dj_t, cost_t, nk_t):
    """Per-bin lane tables (off, di, dj, cost [K, L], edge [L]): each lane
    composes its edge sequence through the evolving theta bin; cost
    accumulates in `cost_t`'s dtype (pre-quantized i32 single-edge costs
    make a macro lane cost exactly the sum of its steps)."""
    k, e = flat_off.shape
    seqs = _lane_seqs(cfg, e)
    ln = len(seqs)
    off = np.zeros((k, ln), np.int32)
    di = np.zeros((k, ln), np.int32)
    dj = np.zeros((k, ln), np.int32)
    cost = np.zeros((k, ln), cost_t.dtype)
    edge = np.asarray([seq[-1] for seq in seqs], np.int32)
    for p, seq in enumerate(seqs):
        for kk in range(k):
            kb = kk
            for ei in seq:
                off[kk, p] += flat_off[kb, ei]
                di[kk, p] += di_t[kb, ei]
                dj[kk, p] += dj_t[kb, ei]
                cost[kk, p] += cost_t[kb, ei]
                kb = nk_t[kb, ei]
    return off, di, dj, cost, edge


# Packed lattice cost word: i32 = (g quantized to 1/_G_SCALE) << _EDGE_BITS
# | parent edge id. One scatter-min commits cost and parent together.
_EDGE_BITS = 3
_G_SCALE = 64.0
_INF_PACKED = np.int32(2**31 - 1)


def _lattice_chain_device(gp, inv_off, goal_idx, start_idx, k, max_len):
    """The CPU route of the walk, and the reference of the card's kernel
    (`csrc/lattice_chain.cu`): walk up to `max_len` steps of the lattice
    parent chain eagerly, from `goal_idx`: returns (cells i64[max_len],
    the visited state indices goal -> start with -1 once finished;
    next_idx; done; the host reads of `done`), so the host can continue a
    chain that outruns one chunk. The walk stops early once `done` (read every
    `_CHAIN_CHECK` steps); the remaining outputs are -1, as the JAX
    scan's."""
    dev = gp.device
    s = gp.shape[0]
    emask = (1 << _EDGE_BITS) - 1
    idx = torch.as_tensor(goal_idx, dtype=torch.int64, device=dev)
    start = torch.as_tensor(start_idx, dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    out = []
    reads = 0
    for t in range(max_len):
        if t and t % _CHAIN_CHECK == 0:
            reads += 1
            if bool(done):
                break
        safe = torch.clamp(idx, 0, s - 1)
        word = gp[safe]
        stop = done | (idx < 0) | (idx == start) | (word == int(_INF_PACKED))
        out.append(torch.where(stop, -1, idx))
        nxt = idx - inv_off[safe % k, (word & emask).long()]
        idx = torch.where(stop, idx, nxt)
        done = stop
    cells = torch.full((max_len,), -1, dtype=torch.int64, device=dev)
    if out:
        cells[: len(out)] = torch.stack(out)
    return cells, idx, done, reads


def _lattice_chain_cost(gp, inv_off, edge_cost, cells, k):
    """The quantized cost of the edges into the visited states `cells`
    (a chunk of `_lattice_chain_device`, -1 past its end): each state's
    parent edge from its word, its cost from `edge_cost` [K, E] by the
    parent's bin. A handful of ops a chunk, on the device."""
    emask = (1 << _EDGE_BITS) - 1
    safe = torch.clamp(cells, min=0)
    edge = torch.where(cells >= 0, gp[safe] & emask, 0).long()
    parent = torch.clamp(safe - inv_off[safe % k, edge], 0, gp.shape[0] - 1)
    return torch.where(cells >= 0, edge_cost[parent % k, edge], 0).sum()


def _lattice_chain_chunk(gp, inv_off, edge_cost, idx, start, k, max_len):
    """One chunk of the parent-chain walk from `idx` towards `start`:
    (the visited states goal -> start, i64 numpy; the quantized cost of
    their parent edges; done; the next chunk's `idx`; host reads; kernel
    launches). On the card one `lattice_chain_cuda` launch and one read of
    its output, `idx` / `start` one-element device tensors (the next index
    stays on the device); on the CPU the eager walk and its cost."""
    if gp.is_cuda:
        out = lattice_chain_cuda.launch(gp, inv_off, edge_cost, idx, start, max_len)
        host = out.cpu().numpy()
        n, cost, done = (int(v) for v in host[:3])
        head = lattice_chain_cuda.HEADER
        return host[head:head + n], cost, bool(done), out[3:4], 1, 1
    cells, nxt, done, reads = _lattice_chain_device(gp, inv_off, idx, start, k, max_len)
    cost = _lattice_chain_cost(gp, inv_off, edge_cost, cells, k)
    host = torch.cat([cells, cost.reshape(1)]).cpu().numpy()
    cells = host[:-1]
    return cells[cells >= 0], int(host[-1]), bool(done), nxt, reads + 2, 0


def _shift_gather(planes, src, di, dj, shape):
    """bool[M, H, W]: out[m][i, j] = planes[src[m]][i + di[m], j + dj[m]],
    False outside the map. One indexing op for all M shifts."""
    h, w = shape
    dev = planes.device
    pi = int(np.abs(di).max(initial=0))
    pj = int(np.abs(dj).max(initial=0))
    padded = torch.nn.functional.pad(planes, (pj, pj, pi, pi), value=False)
    rows = torch.from_numpy(pi + di[:, None] + np.arange(h)).to(dev)
    cols = torch.from_numpy(pj + dj[:, None] + np.arange(w)).to(dev)
    src_t = torch.from_numpy(np.asarray(src)).to(dev)
    return padded[src_t[:, None, None], rows[:, :, None], cols[:, None, :]]


def _lattice_feas_words(free, seg, di_t, dj_t, nk_t, cfg):
    """i32[S, Wn] per-state lane-feasibility words: bit l % 32 of word
    l // 32 says lane l is clear from state n (the JAX package's u32
    words, bit for bit). A single-edge lane (k, e) is clear iff every
    sampled cell is free and in bounds: an AND of shifted copies of the
    free mask. A macro lane ANDs each constituent edge's map shifted by
    the cumulative cell offset of its prefix.

    The build is batched: one shifted gather per edge sample gives the
    single-edge maps of every (bin, edge), one per lane position gives
    every (bin, lane) map."""
    h, w = free.shape
    k, e, t, _ = seg.shape
    seqs = _lane_seqs(cfg, e)
    lanes_n = len(seqs)
    words = -(-lanes_n // 32)
    free = free.to(torch.bool)[None]

    # Single-edge maps F[k * E + e].
    zeros = np.zeros(k * e, np.int64)
    fmap = None
    for ti in range(t):
        m = _shift_gather(free, zeros, seg[:, :, ti, 0].ravel(), seg[:, :, ti, 1].ravel(),
                          (h, w))
        fmap = m if fmap is None else fmap & m

    # Lane maps: AND over lane positions of the shifted edge maps.
    depth = max(len(sq) for sq in seqs)
    src = np.zeros((depth, k, lanes_n), np.int64)
    ci = np.zeros((depth, k, lanes_n), np.int64)
    cj = np.zeros((depth, k, lanes_n), np.int64)
    used = np.zeros((depth, k, lanes_n), bool)
    for kk in range(k):
        for li, seq in enumerate(seqs):
            oi = oj = 0
            kb = kk
            for p, ei in enumerate(seq):
                src[p, kk, li] = kb * e + ei
                ci[p, kk, li], cj[p, kk, li] = oi, oj
                used[p, kk, li] = True
                oi += int(di_t[kb, ei])
                oj += int(dj_t[kb, ei])
                kb = int(nk_t[kb, ei])
    lanes = None
    for p in range(depth):
        m = _shift_gather(fmap, src[p].ravel(), ci[p].ravel(), cj[p].ravel(), (h, w))
        if not used[p].all():
            unused = torch.from_numpy(~used[p].ravel()).to(m.device)
            m = m | unused[:, None, None]
        lanes = m if lanes is None else lanes & m
    lanes = lanes.reshape(k, lanes_n, h, w)

    per_word = []
    for wi in range(words):
        acc = torch.zeros((k, h, w), dtype=torch.int32, device=free.device)
        for b in range(min(32, lanes_n - wi * 32)):
            acc = acc | (lanes[:, wi * 32 + b].to(torch.int32) << b)
        per_word.append(acc)
    allw = torch.stack(per_word, dim=1)  # [K, Wn, H, W]
    # State-major [S, Wn], S = cell * K + k: one word-row gather per pop.
    return allw.reshape(k, words, h * w).permute(2, 0, 1).reshape(h * w * k, words).contiguous()


def _lattice_round(
    st: LatticeState, feasw, off_t, di_t, dj_t, cost_q, edge_t, goal,
    target_bin, hfield, cfg, shape, active=None, inplace=False,
):
    """One batched expansion over the compact open list. Tables are
    [K, L]-laned device tensors; `feasw` is the i32[S, Wn] lane-bit table.
    A state with a leading query axis ([Q, S] gp, with goal [Q, 2],
    target_bin [Q], hfield [Q, H*W] and `active` [Q]) runs every query at
    once; a query whose `active` is False pops nothing and changes
    nothing. `inplace` commits into the state's own arrays (a search
    block's buffers, with spare slots) instead of new ones."""
    if st.gp.dim() == 1:
        out = _lattice_round(
            _map_state(st, lambda a: a[None]), feasw, off_t, di_t, dj_t, cost_q,
            edge_t, goal[None], target_bin[None], hfield[None], cfg, shape,
            None if active is None else active[None], inplace,
        )
        return _map_state(out, lambda a: a[0])
    h, w = shape
    kbins = cfg.theta_res
    kpop = cfg.batch
    q, s = st.gp.shape
    c = st.o_f.shape[1]
    dev = st.gp.device
    inv_scale = float(np.float32(1.0 / _G_SCALE))

    # Grouped best-of pops from the [C] ring (not the [S] cuboid).
    f2 = st.o_f.reshape(q, -1, kpop)
    rel = torch.argmin(f2, dim=1)  # [Q, batch]
    cols = torch.arange(kpop, dtype=torch.int32, device=dev)
    pos = rel.to(torch.int32) * kpop + cols
    fpop = torch.gather(f2, 1, rel[:, None, :])[:, 0]
    pop_valid = fpop < INF
    if active is not None:
        pop_valid = pop_valid & active[:, None]
    pos_l = pos.long()
    pop = torch.where(pop_valid, torch.gather(st.o_idx, 1, pos_l), 0)
    if inplace:
        o_f = st.o_f.scatter_(1, pos_l, torch.where(pop_valid, INF, fpop))
    else:
        o_f = st.o_f.scatter(1, pos_l, torch.where(pop_valid, INF, fpop))

    pop_l = pop.long()
    cell = pop // kbins
    gq = torch.gather(st.gp, 1, pop_l) >> _EDGE_BITS  # i32 quantized g
    gg = gq.to(torch.float32) * inv_scale
    # Lazy deletion: an entry whose state improved after insertion is stale.
    fresh = fpop <= gg + torch.gather(hfield, 1, cell.long()) + 1e-3
    pop_valid = pop_valid & fresh
    kk = (pop % kbins).long()
    i = cell // w
    j = cell % w

    # Goal test on the cell-centre pose.
    cx = j.to(torch.float32) + 0.5
    cy = (h - i).to(torch.float32) - 0.5
    d2goal = (cx - goal[:, :1]) ** 2 + (cy - goal[:, 1:2]) ** 2
    bin_ok = cfg.diff_drive | (kk == target_bin[:, None])
    at_goal = (d2goal <= cfg.tol * cfg.tol) & bin_ok & pop_valid
    first = torch.argmin(torch.where(at_goal, fpop, INF), dim=1, keepdim=True)
    goal_better = at_goal.any(1) & (st.goal_idx < 0)
    goal_idx = torch.where(goal_better, torch.gather(pop, 1, first)[:, 0], st.goal_idx)
    goal_cost = torch.where(goal_better, torch.gather(gg, 1, first)[:, 0], st.goal_cost)

    # Successors: static per-bin tables, [Q, batch, L].
    off = off_t[kk]
    ni = i[..., None] + di_t[kk]
    nj = j[..., None] + dj_t[kk]
    inb = (ni >= 0) & (ni < h) & (nj >= 0) & (nj < w)
    lanes_n = di_t.shape[1]
    fw = feasw[pop_l]  # [Q, batch, Wn]
    lane_word = torch.arange(lanes_n, device=dev) // 32
    lane_bit = torch.arange(lanes_n, dtype=torch.int32, device=dev) % 32
    clear = (fw[..., lane_word] >> lane_bit) & 1
    ok = inb & (clear > 0) & pop_valid[..., None]

    tgt = torch.clamp(pop[..., None] + off, 0, s - 1)
    tgt_f = tgt.reshape(q, -1).long()
    candq = gq[..., None] + cost_q[kk]  # i32
    if cfg.lattice_skip_precheck:
        imp = ok
    else:
        old = torch.gather(st.gp, 1, tgt_f).reshape(tgt.shape)
        imp = ok & (candq < (old >> _EDGE_BITS))
    packed = torch.where(imp, (candq << _EDGE_BITS) | edge_t, int(_INF_PACKED))

    packed_f = packed.reshape(q, -1)
    commit = st.gp.scatter_reduce_ if inplace else st.gp.scatter_reduce
    gp = commit(1, tgt_f, packed_f, "amin", include_self=True)

    # Insert the scatter-min winners into consecutive ring slots.
    imp_f = imp.reshape(q, -1)
    fnew = (
        candq.reshape(q, -1).to(torch.float32) * inv_scale
        + torch.gather(hfield, 1, tgt_f // kbins)
    )
    insert = imp_f & (fnew < INF) & (packed_f == torch.gather(gp, 1, tgt_f))
    rank = torch.cumsum(insert.to(torch.int32), 1, dtype=torch.int32) - 1
    slot = torch.where(insert, (st.wp[:, None] + rank) % c, c)
    n_ins = insert.sum(1, dtype=torch.int32)
    # Wraparound audit: live entries in recycled slots, plus the inserts
    # that collide within a round larger than the ring.
    live = torch.gather(o_f, 1, torch.clamp(slot, max=c - 1).long()) < INF
    lost = (insert & live).sum(1, dtype=torch.int32) + torch.clamp(n_ins - c, min=0)
    # A round larger than the ring keeps the last c inserts of each slot
    # cycle, as a sequential scatter does.
    slot = torch.where(insert & (rank >= (n_ins - c)[:, None]), slot, c)
    drop = set_drop_ if inplace else set_drop
    o_idx = drop(st.o_idx, slot, tgt_f.to(torch.int32))
    o_f = drop(o_f, slot, fnew)

    return LatticeState(
        gp=gp,
        o_idx=o_idx,
        o_f=o_f,
        wp=st.wp + n_ins,
        goal_idx=goal_idx,
        goal_cost=goal_cost,
        n_expanded=st.n_expanded + pop_valid.sum(1, dtype=torch.int32),
        n_lost=st.n_lost + lost,
        start_idx=st.start_idx,
    )


def _weight_h(hfield, cfg):
    """Weighted-A* heuristic inflation, keeping INF exactly."""
    if cfg.heuristic_weight == 1.0:
        return hfield
    return torch.where(hfield < INF, hfield * cfg.heuristic_weight, INF)


def _coarse_geodesic_cells(free, bx, by, cfg, shape, graphs):
    """Per-cell [H*W] goal-distance heuristic: the A* wavefront on a
    `coarse`-downsampled grid (max-pooled free space, an admissible
    underestimate), tiled back to full resolution; its chunks run as a
    chain from the cache `graphs` (`astar.distance_field`)."""
    h, w = shape
    f4 = max(1, cfg.coarse)
    ph = (-h) % f4
    pw = (-w) % f4
    fpad = torch.nn.functional.pad(free, (0, pw, 0, ph), value=False)
    free_c = fpad.reshape((h + ph) // f4, f4, (w + pw) // f4, f4).any(3).any(1)
    gi = torch.clamp(torch.floor(h - by - 1.0).to(torch.int32), 0, h - 1) // f4
    gj = torch.clamp(torch.floor(bx).to(torch.int32), 0, w - 1) // f4
    dc = astar_mod.distance_field(free_c, (gi.long(), gj.long()), graphs)
    h2d = (dc * f4).repeat_interleave(f4, 0).repeat_interleave(f4, 1)[:h, :w]
    return torch.clamp(h2d, max=INF).reshape(-1)


def _scalar(v, dtype, dev):
    return torch.tensor(v, dtype=dtype, device=dev)


def _lattice_query_init(free, a_xyt, b_xyt, cfg, shape, cap, graphs):
    """A fresh lattice query: start / goal indexing, the heuristic (the
    coarse geodesic wavefront, a chain from the cache `graphs`), and the
    initial state."""
    h, w = shape
    k = cfg.theta_res
    s = h * w * k
    dev = free.device
    start_idx = _pose_to_cuboid(shape, k, a_xyt[0], a_xyt[1], a_xyt[2])
    target_bin = (_pose_to_cuboid(shape, k, b_xyt[0], b_xyt[1], b_xyt[2]) % k).to(torch.int32)
    goal = b_xyt[:2]
    if cfg.heuristic == "geodesic":
        hfield = _coarse_geodesic_cells(free, b_xyt[0], b_xyt[1], cfg, shape, graphs)
    else:
        ii = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        jj = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        d = _sqrt((jj + 0.5 - b_xyt[0]) ** 2 + ((h - ii) - 0.5 - b_xyt[1]) ** 2)
        hfield = d.reshape(-1)
    hfield = _weight_h(hfield, cfg)
    start_l = start_idx.long()
    gp = torch.full((s,), int(_INF_PACKED), dtype=torch.int32, device=dev)
    gp[start_l] = 0
    o_idx = torch.zeros((cap,), dtype=torch.int32, device=dev)
    o_idx[0] = start_idx
    o_f = torch.full((cap,), INF, dtype=torch.float32, device=dev)
    o_f[0] = hfield[start_l // k]
    state = LatticeState(
        gp=gp, o_idx=o_idx, o_f=o_f,
        wp=_scalar(1, torch.int32, dev),
        goal_idx=_scalar(-1, torch.int32, dev),
        goal_cost=_scalar(INF, torch.float32, dev),
        n_expanded=_scalar(0, torch.int32, dev),
        n_lost=_scalar(0, torch.int32, dev),
        start_idx=start_idx.to(torch.int32),
    )
    return goal, target_bin, hfield, state


def _lattice_flag(st):
    """The lattice loop's condition without its round bound, per query."""
    return (st.goal_idx < 0) & (st.o_f < INF).any(-1)


def _ha_flag(st):
    """The continuous loop's condition without its round bound."""
    return (st.goal_idx < 0) & (st.open_f < INF).any()


_LAT_FIELDS = tuple(f.name for f in dataclasses.fields(LatticeState))
_HA_FIELDS = tuple(f.name for f in dataclasses.fields(HAState))


def _lattice_block(v, feasw, off_t, di_t, dj_t, cost_q, edge_t, cfg, shape):
    """`_FLAG_EVERY` iterations of the lattice loop on the block buffers
    `v` (the state's fields, goal, target_bin, hfield, rounds, the
    iteration counter `it` and its `limit`): each iteration two rounds,
    both gated by the iteration's flag. The counter is in the gate, so
    iterations past `limit` change nothing, as the JAX loop stops at
    `max_rounds`. Returns the new state, rounds, counter and `flag` (the
    condition tested before the next block)."""
    st = LatticeState(**{f: v[f] for f in _LAT_FIELDS})
    rounds, it = v["rounds"], v["it"]
    for _ in range(_FLAG_EVERY):
        active = _lattice_flag(st) & (it < v["limit"])
        for _ in range(2):
            st = _lattice_round(
                st, feasw, off_t, di_t, dj_t, cost_q, edge_t, v["goal"], v["target_bin"],
                v["hfield"], cfg, shape, active, inplace=True,
            )
        rounds = rounds + 2 * active.to(torch.int32)
        it = it + 1
    return {**{f: getattr(st, f) for f in _LAT_FIELDS}, "rounds": rounds, "it": it,
            "flag": _lattice_flag(st)}


def _lattice_search(
    st, feasw, off_t, di_t, dj_t, cost_q, edge_t, goal, target_bin, hfield,
    max_rounds, cfg, shape, graphs,
):
    """The JAX loop: while no goal, an open entry and rounds < max_rounds,
    run TWO rounds (the condition is tested only between pairs), as a
    chain of `_lattice_block`s from the cache `graphs`. Works on single or
    query-stacked states; each query count Q has its own chain. Returns
    (state, rounds: the JAX loop's round count, i32 per query on the
    device, iterations launched in whole blocks, host reads)."""
    values = {**{f: getattr(st, f) for f in _LAT_FIELDS}, "goal": goal,
              "target_bin": target_bin, "hfield": hfield,
              "rounds": torch.zeros_like(st.goal_idx), "flag": _lattice_flag(st)}
    out, launched, reads = _graph.search(
        graphs, ("lattice", shape, cfg, tuple(st.gp.shape[:-1]), _FLAG_EVERY),
        functools.partial(_lattice_block, feasw=feasw, off_t=off_t, di_t=di_t, dj_t=dj_t,
                          cost_q=cost_q, edge_t=edge_t, cfg=cfg, shape=shape),
        values, -(-max_rounds // 2), _FLAG_EVERY, _CHAIN_RUNS, _LAT_FIELDS + ("rounds",),
        spare=("o_idx", "o_f"), span="hastar.search")
    return LatticeState(**{f: out[f] for f in _LAT_FIELDS}), out["rounds"], launched, reads


def _ha_query_init(free, a_xyt, b_xyt, cfg, shape, graphs):
    """A fresh continuous-mode query: start / goal indexing, the
    heuristic (its wavefront a chain from the cache `graphs`) and the
    initial state."""
    h, w = shape
    k = cfg.theta_res
    s = h * w * k
    dev = free.device
    start_idx = _pose_to_cuboid(shape, k, a_xyt[0], a_xyt[1], a_xyt[2])
    target_bin = (_pose_to_cuboid(shape, k, b_xyt[0], b_xyt[1], b_xyt[2]) % k).to(torch.int32)
    goal = b_xyt[:2]
    start_l = start_idx.long()
    if cfg.heuristic == "geodesic":
        cells = _weight_h(
            _coarse_geodesic_cells(free, b_xyt[0], b_xyt[1], cfg, shape, graphs), cfg)
        hfield = cells.repeat_interleave(k)
        h_start = hfield[start_l]
    else:
        hfield = torch.zeros((1,), dtype=torch.float32, device=dev)  # computed in-round
        h_start = cfg.heuristic_weight * _sqrt(
            (a_xyt[0] - b_xyt[0]) ** 2 + (a_xyt[1] - b_xyt[1]) ** 2
        )

    def fill(v, dtype=torch.float32):
        return torch.full((s,), v, dtype=dtype, device=dev)

    g, px, py, pth, open_f = fill(INF), fill(0.0), fill(0.0), fill(0.0), fill(INF)
    g[start_l] = 0.0
    px[start_l], py[start_l], pth[start_l] = a_xyt[0], a_xyt[1], a_xyt[2]
    open_f[start_l] = h_start
    state = HAState(
        g=g, parent=fill(-1, torch.int32), px=px, py=py, pth=pth, open_f=open_f,
        goal_idx=_scalar(-1, torch.int32, dev),
        goal_cost=_scalar(INF, torch.float32, dev),
        n_expanded=_scalar(0, torch.int32, dev),
        start_idx=start_idx.to(torch.int32),
    )
    return goal, target_bin, hfield, state


def _ha_block(v, field, cfg, rc):
    """`_FLAG_EVERY` rounds of the continuous loop on the block buffers
    `v` (as `_lattice_block`: the counter `it` gates rounds past `limit`,
    one round an iteration); the edge rays run their whole count, with no
    host read."""
    st = HAState(**{f: v[f] for f in _HA_FIELDS})
    rounds, it = v["rounds"], v["it"]
    for _ in range(_FLAG_EVERY):
        active = _ha_flag(st) & (it < v["limit"])
        st = _ha_round(st, field, v["goal"], v["target_bin"], v["hfield"], cfg, rc, active,
                       inplace=True, early_exit=False)
        rounds = rounds + active.to(torch.int32)
        it = it + 1
    return {**{f: getattr(st, f) for f in _HA_FIELDS}, "rounds": rounds, "it": it,
            "flag": _ha_flag(st)}


def _ha_search(st, field, goal, target_bin, hfield, max_rounds, cfg, rc, graphs):
    """The JAX loop: one round while no goal, an open cell and rounds <
    max_rounds, as a chain of `_ha_block`s from the cache `graphs`.
    Returns as `_lattice_search`, one round an iteration."""
    _fan_tables(cfg, st.g.device)  # built outside the block: a host-to-device copy
    values = {**{f: getattr(st, f) for f in _HA_FIELDS}, "goal": goal,
              "target_bin": target_bin, "hfield": hfield,
              "rounds": torch.zeros_like(st.goal_idx), "flag": _ha_flag(st)}
    out, launched, reads = _graph.search(
        graphs, ("continuous", tuple(field.blocked.shape), cfg, rc, _FLAG_EVERY),
        functools.partial(_ha_block, field=field, cfg=cfg, rc=rc),
        values, max_rounds, _FLAG_EVERY, _CHAIN_RUNS, _HA_FIELDS + ("rounds",),
        spare=("parent", "px", "py", "pth", "open_f"), span="hastar.search")
    return HAState(**{f: out[f] for f in _HA_FIELDS}), out["rounds"], launched, reads


def _pose_xyt(p: Pose, dev) -> torch.Tensor:
    return torch.stack([torch.as_tensor(v, dtype=torch.float32).reshape(())
                        for v in (p.x, p.y, p.theta)]).to(dev)


class HybridAStar:
    """Facade of `slam/hastar.h:14-119` (reset / pathfind / recover_path)
    with a batched round. The map moves to `device`, where the search
    runs: the CUDA card unless the caller asks for another
    (`device="cpu"`)."""

    def __init__(
        self,
        free,
        a: Pose,
        b: Pose,
        cfg: HybridAStarConfig = HybridAStarConfig(),
        rc: RaycastConfig = RaycastConfig(backend="sdf", step=1.0),
        device=None,
    ):
        self.cfg = cfg
        # Collision rays only need to cover one steering arc (length = v).
        self.rc = dataclasses.replace(rc, max_dist=min(rc.max_dist, cfg.velocity + 2.0))
        self.device = entry_device(device)
        # The search blocks of this map (CUDA graphs on the card).
        self._graphs = _graph.Cache()
        self.reset(free, a, b)

    def _pose_to_cuboid(self, x, y, theta):
        return _pose_to_cuboid(self.shape, self.cfg.theta_res, x, y, theta)

    def reset(self, free, a: Pose, b: Pose):
        """New map + new query (`slam/hastar.cpp:30-81`). For a new query
        on the same map use `reset_query`, which keeps the map's tables."""
        free = torch.as_tensor(free, dtype=torch.bool, device=self.device)
        self.shape = tuple(free.shape)
        self._free = free
        self._graphs.clear()
        if self.cfg.mode == "lattice":
            # No raycasts: feasibility is the precomputed lane-bit table.
            self.field = RayField(blocked=~free)
            flat_off, di_t, dj_t, cost_t, seg, inv_off, nk_t = _lattice_tables(
                self.cfg, self.shape
            )
            e_n = di_t.shape[1]
            if e_n > (1 << _EDGE_BITS):
                raise ValueError(
                    f"lattice mode packs the parent edge in {_EDGE_BITS} bits; "
                    f"branching_factor {self.cfg.branching_factor} needs {e_n} edge ids"
                )
            cost_q = np.round(cost_t * _G_SCALE).astype(np.int32)
            tables = _lattice_lane_tables(self.cfg, flat_off, di_t, dj_t, cost_q, nk_t)
            self._lat_feas = _lattice_feas_words(free, seg, di_t, dj_t, nk_t, self.cfg)
            (self._lat_off, self._lat_di, self._lat_dj, self._lat_cost,
             self._lat_edge) = (torch.from_numpy(t).to(self.device) for t in tables)
            self._lat_inv_off = inv_off
            self._lat_inv_off_dev = torch.from_numpy(inv_off.astype(np.int64)).to(self.device)
            # The single edges' quantized costs, [K, E] (the first E lanes).
            self._lat_edge_cost = self._lat_cost[:, :e_n].long()
        else:
            self.field = make_ray_field(~free, self.rc)
        self.reset_query(a, b)

    def reset_query(self, a: Pose, b: Pose):
        """Re-target start and goal, reusing the map's tables; the query
        state is built at the first `pathfind` or `solve`."""
        self.a = a
        self.b = b
        self.success = False
        self.used_up = False
        self._pending = (_pose_xyt(a, self.device), _pose_xyt(b, self.device))
        self.state = None
        self._fleet_state = None
        self._fleet_paths = None
        # The last solve's rounds (as the JAX loop counts them), loop
        # iterations launched (gated ones included), host reads (the
        # loop's flag reads and the final read of rounds and goal), states
        # expanded and ring entries lost; the last path walk's host reads
        # and kernel launches.
        self.rounds = self.launched = self.host_reads = 0
        self.n_expanded = self.n_lost = self.path_reads = self.path_launches = 0
        # The cost of the lattice path walked for this query (`path_cost`).
        self._walked_cost = None

    def _ring_capacity(self) -> int:
        # The default (None -> 1M) is clamped to ~4x the cuboid; an
        # explicit capacity is honoured as is.
        cap = self.cfg.open_capacity
        if cap is None:
            s = self.shape[0] * self.shape[1] * self.cfg.theta_res
            cap = min(1 << 20, 4 * s)
        cap = max(cap, self.cfg.batch)
        return -(-cap // self.cfg.batch) * self.cfg.batch

    def _ensure_query_state(self):
        if self.state is not None:
            return
        a_xyt, b_xyt = self._pending
        if self.cfg.mode == "lattice":
            self._goal, self._target_bin, self._hfield, self.state = _lattice_query_init(
                self._free, a_xyt, b_xyt, self.cfg, self.shape, self._ring_capacity(),
                self._graphs
            )
        else:
            self._goal, self._target_bin, self._hfield, self.state = _ha_query_init(
                self._free, a_xyt, b_xyt, self.cfg, self.shape, self._graphs
            )

    def _lattice_args(self):
        return (self._lat_feas, self._lat_off, self._lat_di, self._lat_dj,
                self._lat_cost, self._lat_edge)

    def pathfind(self) -> bool:
        """One batched round; True when finished (success or exhaustion,
        `slam/hastar.cpp:152-214`)."""
        if self.success or self.used_up:
            return True
        self._ensure_query_state()
        if self.cfg.mode == "lattice":
            self.state = _lattice_round(
                self.state, *self._lattice_args(), self._goal, self._target_bin,
                self._hfield, self.cfg, self.shape,
            )
            open_any = (self.state.o_f < INF).any()
        else:
            self.state = _ha_round(
                self.state, self.field, self._goal, self._target_bin, self._hfield,
                self.cfg, self.rc,
            )
            open_any = (self.state.open_f < INF).any()
        goal_idx, open_any = torch.stack([self.state.goal_idx >= 0, open_any]).tolist()
        if goal_idx:
            self.success = True
            return True
        if not open_any:
            self.used_up = True
            self._warn_if_overflowed(open_known_empty=True)
            return True
        return False

    def _warn_if_overflowed(self, open_known_empty: bool = False):
        """Exhaustion with ring-overwritten entries is not a proof of
        unreachability (lattice mode only)."""
        if self.cfg.mode != "lattice" or self.success:
            return
        if not open_known_empty and bool((self.state.o_f < INF).any()):
            return
        lost = int(self.state.n_lost)
        if lost > 0:
            from slam_tpu_torch.utils.logging import get_logger

            get_logger().warning(
                "hastar lattice: open ring overwrote %d not-yet-popped entries "
                "(capacity %d); exhaustion is inconclusive — raise "
                "HybridAStarConfig.open_capacity",
                lost,
                self._ring_capacity(),
            )

    def solve(self, max_rounds: Optional[int] = None) -> bool:
        """The whole search: the query init's wavefront and the search run
        as chains of blocks (CUDA graph replays on the card, the same block
        code eagerly elsewhere)."""
        with profiling.root("HybridAStar.solve"):
            max_rounds = max_rounds or self.cfg.max_rounds
            self._walked_cost = None
            with profiling.span("hastar.init", self.device):
                self._ensure_query_state()
            with profiling.span("hastar.search"):
                if self.cfg.mode == "lattice":
                    self.state, rounds, self.launched, reads = _lattice_search(
                        self.state, *self._lattice_args(), self._goal, self._target_bin,
                        self._hfield, max_rounds, self.cfg, self.shape, self._graphs)
                    lost = self.state.n_lost
                else:
                    self.state, rounds, self.launched, reads = _ha_search(
                        self.state, self.field, self._goal, self._target_bin, self._hfield,
                        max_rounds, self.cfg, self.rc, self._graphs)
                    lost = torch.zeros_like(rounds)
                self.rounds, goal_idx, self.n_expanded, self.n_lost = torch.stack(
                    [rounds, self.state.goal_idx, self.state.n_expanded, lost]).tolist()
            self.host_reads = reads + 1
            for name in ("rounds", "n_expanded", "n_lost", "host_reads"):
                profiling.count("hastar." + name, getattr(self, name))
            if goal_idx >= 0:
                self.success = True
            else:
                self.used_up = True
                self._warn_if_overflowed()
            return self.success

    def stats(self) -> dict:
        """The last solve's counters (rounds, loop iterations launched,
        host reads, states expanded, ring entries lost) and the last path
        walk's host reads; per search block (named by its key's tag): its
        capture ms, the device memory its capture added, its replays."""
        blocks = {str(k[0]): {"capture_ms": b.capture_ms, "pool_bytes": b.pool_bytes,
                              "replays": b.replays} for k, b in self._graphs.blocks.items()}
        return {"rounds": self.rounds, "launched": self.launched,
                "host_reads": self.host_reads, "n_expanded": self.n_expanded,
                "n_lost": self.n_lost, "path_reads": self.path_reads, "blocks": blocks}

    def solve_many(self, queries, max_rounds: Optional[int] = None, query_sharding=None):
        """Solve Q independent (start, goal) queries together (lattice
        mode): the states stack on a leading axis and advance in lockstep,
        each frozen once its own search ends. Each solved query's chain is
        walked once; returns [(success, cost)], the cost that of the path
        `recover_path_for(q)` returns, as `path_cost` gives it.

        `query_sharding` (a `parallel.mesh.Sharding` whose spec names the
        mesh dims that split the queries, e.g. ``("p",)``) spreads the
        queries over those ranks: Q must divide by their count; each rank
        solves its contiguous share and walks their paths, and one object
        all-gather hands every rank all the results and paths (the
        queries solve independently, so no other collective)."""
        if self.cfg.mode != "lattice":
            raise ValueError("solve_many requires mode='lattice'")
        if query_sharding is not None:
            return self._solve_many_sharded(queries, max_rounds, query_sharding)
        max_rounds = max_rounds or self.cfg.max_rounds
        states, goals, tbins, hfields = [], [], [], []
        for a, b in queries:
            self.reset_query(a, b)
            self._ensure_query_state()
            states.append(self.state)
            goals.append(self._goal)
            tbins.append(self._target_bin)
            hfields.append(self._hfield)
        stacked = LatticeState(**{
            f.name: torch.stack([getattr(s, f.name) for s in states])
            for f in dataclasses.fields(LatticeState)
        })
        out, _, self.launched, reads = _lattice_search(
            stacked, *self._lattice_args(), torch.stack(goals), torch.stack(tbins),
            torch.stack(hfields), max_rounds, self.cfg, self.shape, self._graphs)
        self.host_reads = reads + 2
        goal_idx = out.goal_idx.tolist()
        goal_cost = out.goal_cost.cpu().numpy()
        self._fleet_state = out
        self._fleet_paths, results = {}, []
        self.path_reads = self.path_launches = 0
        for q in range(len(queries)):
            if goal_idx[q] < 0:
                self._fleet_paths[q] = []
                results.append((False, float(goal_cost[q])))
                continue
            path, reads, launches, cost = self._walk_lattice_chain(
                out.gp[q], out.goal_idx[q], out.start_idx[q])
            self._fleet_paths[q] = path
            self.path_reads += reads
            self.path_launches += launches
            results.append((True, cost))
        return results

    def _solve_many_sharded(self, queries, max_rounds, query_sharding):
        import torch.distributed as dist

        mesh = query_sharding.mesh
        axes = [mesh.axis(a) for a in query_sharding.spec]
        n_shards = int(np.prod([a.size for a in axes]))
        q_all = len(queries)
        if q_all % n_shards:
            raise ValueError(
                f"solve_many got {q_all} queries over a {n_shards}-rank query "
                "sharding — Q must divide by the sharded axis size (pad with "
                "repeated queries)"
            )
        shard = 0
        for a in axes:
            shard = shard * a.size + a.index
        per = q_all // n_shards
        mine = list(range(shard * per, (shard + 1) * per))
        res = self.solve_many([queries[q] for q in mine], max_rounds)
        paths = [self.recover_path_for(k) for k in range(per)]
        # Every rank of the world contributes; the ranks that replicate a
        # shard (other mesh dims) send the same results.
        gathered = [(mine, res, paths)]
        if dist.is_initialized() and dist.get_world_size() > 1:
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, (mine, res, paths))
        results, self._fleet_paths = [None] * q_all, {}
        for qs, rs, ps in gathered:
            for q, r, pth in zip(qs, rs, ps):
                results[q] = r
                self._fleet_paths[q] = pth
        return results
    def recover_path_for(self, q: int) -> List[Tuple[int, int]]:
        """The path (image coords) of query q of the last `solve_many`,
        which walked it; valid until the next `reset_query` / `solve_many`."""
        if self._fleet_paths is None:
            raise ValueError(
                "recover_path_for: no solve_many results are live "
                "(call solve_many first; reset_query invalidates them)"
            )
        return list(self._fleet_paths[q])

    def _walk_lattice_chain(self, gp, idx, start_idx):
        """Walk the parent chain from `idx` to `start_idx` (0-d tensors on
        the words' device, read there) in chunks (`_lattice_chain_chunk`).
        Returns (the path, the host reads, the kernel launches, the path's
        cost: its edges' quantized costs summed, over _G_SCALE)."""
        k = self.cfg.theta_res
        w = self.shape[1]
        s_total = int(np.prod(self.shape)) * k
        # Chunk size of the walk; tests shrink it to exercise continuation.
        max_len = int(min(s_total, getattr(self, "_chain_chunk", 1 << 15)))
        cur = idx
        chunks = []
        total = reads = launches = cost_q = 0
        while True:
            cells, cost, done, cur, chunk_reads, chunk_launches = _lattice_chain_chunk(
                gp, self._lat_inv_off_dev, self._lat_edge_cost, cur, start_idx, k, max_len)
            chunks.append(cells)
            cost_q += cost
            total += max_len
            reads += chunk_reads
            launches += chunk_launches
            if done or total >= s_total:
                break
        cells = np.concatenate(chunks)
        path = [(int(c) // k // w, int(c) // k % w) for c in cells]
        path.reverse()
        return path, reads, launches, cost_q / _G_SCALE

    def recover_path(self) -> List[Tuple[int, int]]:
        """Parent-chain walk returning image coords (`slam/hastar.cpp:
        216-232`). Lattice mode follows the parent edge id in each packed
        word back through the inverse steering table."""
        if not self.success:
            return []
        with profiling.root("HybridAStar.recover_path"), profiling.span("hastar.path"):
            return self._recover_path()

    def _recover_path(self) -> List[Tuple[int, int]]:
        k = self.cfg.theta_res
        w = self.shape[1]
        st = self.state
        if self.cfg.mode == "lattice":
            path, self.path_reads, self.path_launches, self._walked_cost = (
                self._walk_lattice_chain(st.gp, st.goal_idx, st.start_idx))
            profiling.count("hastar.host_reads", self.path_reads)
            profiling.count("hastar.path_launches", self.path_launches)
            return path
        idx, start_idx = torch.stack([st.goal_idx, st.start_idx]).tolist()
        parent = self.state.parent.cpu().numpy()
        self.path_reads = 2
        profiling.count("hastar.host_reads", self.path_reads)
        path = []
        seen = 0
        while idx >= 0 and idx != start_idx and seen <= len(parent):
            cell = idx // k
            path.append((cell // w, cell % w))
            idx = int(parent[idx])
            seen += 1
        path.reverse()
        return path

    def path_cost(self) -> float:
        """The cost of the path `recover_path` returns. In lattice mode that
        is its edges' costs summed, walked once a query: a state on the
        chain can improve after its successor was committed, and the walk
        follows the improved parent, so the goal's cost at its pop
        (`state.goal_cost`) can exceed it."""
        if self.cfg.mode == "lattice" and self.success:
            if self._walked_cost is None:
                self.recover_path()
            return self._walked_cost
        return float(self.state.goal_cost)
