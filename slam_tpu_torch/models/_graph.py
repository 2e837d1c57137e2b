"""CUDA graphs of the filter steps: the port's counterpart of the JAX
package's `jax.jit` of a step (`slam_tpu/models/mcl.py:408-409`,
`models/slam.py:336-340`, `models/fleet.py:61`, `models/rbpf.py:123`,
`parallel/sharded.py:98-157`, `parallel/mapshard.py:305-334`,
`bench.py:109-112`).

`StepGraphs.run(fn, state, odom, scan, key=, gates=)` runs one step
`fn(state, odom, scan) -> state` of an entry point as one `core.graph.Block`:

  * static buffers hold the state's tensors (one flat buffer per dtype,
    each tensor a 512 B aligned view of it, as the allocator aligns its
    own) and the step's inputs: the odometry as f32 [R, 3] (R = 1 for one
    filter) and the scan's angles and dists;
  * one block per key: the caller's key (the config, the map, the
    alphas), the shapes, the generators and the host-side gates, each
    `updates % m` for m in `gates` (the resample and map gates,
    `mcl.py:_finish`, `slam.py:step`); a block's graph registers every
    generator of the state, so a replay draws what the eager step draws;
  * a load copies each input into its buffer, and skips a buffer that
    already holds it: the buffer itself (`_same`), or the tensor it was
    last loaded from or returned as, unmodified since (its version);
    host odometry goes through a ring of pinned buffers, each reused only
    after its last copy has finished (a CUDA event);
  * the step's new state is copied into the buffers inside the graph, and
    the step returns a copy of them, one device-to-device copy of the flat
    buffer a step (`copies`, `copy_bytes`), since JAX's steps are
    functional: a state a step returned is never overwritten by the next.

On the card a block is captured at its first run and replayed after; a
failed capture or replay raises (there is no eager fallback). On the CPU,
and on the card for `StepGraphs(capture=False)`, the same block code runs
eagerly. `guard` wraps every block run (the
warm-up, each replay, each eager run): a check may make a host read raise
there. A step's data-dependent branches (the auto measurement tier, the
ESS gate, the `edt_box` refresh) are `core/graph.py:cond`s, CUDA graph IF
nodes inside the step's graph, so no step reads the host.

Spans (`utils/profiling.py`): `graph.run` covers a run, with the
children `graph.prepare` (the state's leaves, the odometry rows, the
layout, buffers and block), `graph.load` (its child `graph.wait`: a
pinned buffer's wait), the block's `graph.capture` and `graph.replay`
(`core/graph.py`), and `graph.output` (the copy out and the rebuilt
state).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch

from slam_tpu_torch.core.graph import Block, Cache, _same
from slam_tpu_torch.core.types import Odometry, Scan
from slam_tpu_torch.ops.motion_cuda import odometry_rows
from slam_tpu_torch.utils import profiling

# Elements of one dtype a buffer view is aligned to: 512 B, the caching
# allocator's alignment, so a kernel picks the same vector path on a view
# as on a fresh tensor.
_ALIGN_BYTES = 512
# Pinned odometry buffers a name cycles through: the host may run this
# many steps ahead of the card before a load waits.
_PINNED_RING = 4
# Blocks one entry point keeps (gate phases x tiers x maps).
_MAX_BLOCKS = 32


def _flatten(obj, prefix: str, leaves: dict, host: dict) -> None:
    """The tensors of a state (dataclasses of tensors, nested) by dotted
    name into `leaves`; every other field (generators, host ints, None)
    into `host`."""
    if isinstance(obj, torch.Tensor):
        leaves[prefix] = obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _flatten(getattr(obj, f.name), f"{prefix}.{f.name}" if prefix else f.name,
                     leaves, host)
    else:
        host[prefix] = obj


def _rebuild(obj, prefix: str, leaves: dict, ints: dict):
    """`obj` with its tensors taken from `leaves` and its host ints from
    `ints` (by dotted name); everything else kept."""
    if prefix in leaves:
        return leaves[prefix]
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _rebuild(getattr(obj, f.name), f"{prefix}.{f.name}" if prefix else f.name,
                             leaves, ints)
            for f in dataclasses.fields(obj)})
    return ints.get(prefix, obj)


def _is_count(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def generators(host: dict) -> Tuple[torch.Generator, ...]:
    """The generators among a state's host fields (a fleet holds a tuple)."""
    out = []
    for v in host.values():
        if isinstance(v, torch.Generator):
            out.append(v)
        elif isinstance(v, tuple) and v and all(isinstance(g, torch.Generator) for g in v):
            out.extend(v)
    return tuple(out)


def _updates(host: dict) -> int:
    """The state's update counter (`MCLState.updates`, `SLAMState.mcl.updates`)."""
    for name, v in host.items():
        if name == "updates" or name.endswith(".updates"):
            return v
    raise ValueError("the state has no update counter")


class _Buffers:
    """The static buffers of one state layout, which every block of an
    entry point shares: the state's leaves as aligned views of one flat
    buffer per dtype, and an input buffer per input name and shape.
    `held[name]` is (a weak reference to the tensor the buffer holds a
    copy of, its version then)."""

    def __init__(self, leaves: Dict[str, torch.Tensor], dev):
        self.dev = dev
        self.views: Dict[str, torch.Tensor] = {}
        self.inputs: Dict[Tuple, torch.Tensor] = {}
        self.flats: Dict[torch.dtype, torch.Tensor] = {}
        self.groups: Dict[torch.dtype, list] = {}
        for name, v in leaves.items():
            self.groups.setdefault(v.dtype, []).append(name)
        for dt, names in self.groups.items():
            align = max(1, _ALIGN_BYTES // torch.empty((), dtype=dt).element_size())
            offs, n = [], 0
            for name in names:
                offs.append(n)
                n += -(-max(1, leaves[name].numel()) // align) * align
            flat = torch.zeros((n,), dtype=dt, device=dev)
            self.flats[dt] = flat
            for name, o in zip(names, offs):
                shape = leaves[name].shape
                self.views[name] = flat[o:o + leaves[name].numel()].view(shape)
        self.leaf_names = tuple(leaves)
        self.held: Dict[str, tuple] = {}
        self.bytes = sum(f.numel() * f.element_size() for f in self.flats.values())

    def static(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The buffers a block of these inputs reads, by name: the state's
        views and one buffer per input (made at its first shape)."""
        out = dict(self.views)
        for name, v in inputs.items():
            k = (name, tuple(v.shape), v.dtype)
            if k not in self.inputs:
                self.inputs[k] = torch.zeros(v.shape, dtype=v.dtype, device=self.dev)
            out[name] = self.inputs[k]
        return out


class StepGraphs:
    """The step graphs of one entry point (`MCL`, `GridSLAM`, `MCLFleet`,
    `RBPF`, a sharded engine, or a tool's loop): blocks in a
    `core.graph.Cache`, the static buffers they share, the pinned staging
    buffers and the counters. With `capture` False the blocks run eagerly
    on the card as well (a sharded engine over gloo, whose collectives run
    on the host)."""

    def __init__(self, capture: bool = True):
        self.capture = capture
        self.cache = Cache(_MAX_BLOCKS)
        self._bufs: Dict[Tuple, _Buffers] = {}
        self._pinned: Dict[str, list] = {}
        self._pool = None
        # Per step: the device-to-device copies of the state out of the
        # buffers (one a step) and their bytes; loads made and skipped.
        self.copies = 0
        self.copy_bytes = 0
        self.loads = 0
        self.skipped = 0

    @property
    def guard(self):
        return self.cache.guard

    @guard.setter
    def guard(self, value) -> None:
        self.cache.guard = value
        for block in self.cache.blocks.values():
            block.guard = value

    # -- loads ---------------------------------------------------------------
    def _stage(self, name: str, s: torch.Tensor, v: torch.Tensor) -> None:
        """Copy host tensor `v` into device buffer `s` through a pinned
        buffer of a ring: the buffer is refilled only after the copy out of
        it, issued `_PINNED_RING` loads ago, has finished."""
        ring = self._pinned.setdefault(name, [])
        if len(ring) < _PINNED_RING or ring[0][0].shape != s.shape:
            if ring and ring[0][0].shape != s.shape:
                ring.clear()
            pinned, event = torch.empty(s.shape, dtype=s.dtype, pin_memory=True), None
        else:
            pinned, event = ring.pop(0)
            with profiling.span("graph.wait"):
                event.synchronize()
        pinned.copy_(v)
        s.copy_(pinned, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(s.device))
        ring.append((pinned, event))

    def _load(self, bufs: _Buffers, static: Dict[str, torch.Tensor],
              values: Dict[str, torch.Tensor]) -> None:
        for name, v in values.items():
            s = static[name]
            hk = name if name in bufs.views else (name, tuple(s.shape), s.dtype)
            held = bufs.held.get(hk)
            if _same(v, s) or (held is not None and held[0]() is v and held[1] == v._version):
                self.skipped += 1
                continue
            if s.is_cuda and not v.is_cuda:
                self._stage(name, s, v)
            else:
                s.copy_(v)
            bufs.held[hk] = (weakref.ref(v), v._version)
            self.loads += 1

    def _prepare(self, fn, state, odom, scan, key, gates):
        """(the state's host fields, its buffers, the static buffers of the
        block, the values to load into them, the block) of a run: the
        block from the cache, or made (captured at its first run)."""
        leaves, host = {}, {}
        _flatten(state, "", leaves, host)
        dev = next(iter(leaves.values())).device
        inputs = {}
        if odom is not None:  # f32 [R, 3] where the fields are
            inputs["odo"] = odometry_rows(odom, torch.as_tensor(odom.rot1).device)
        if scan is not None:
            inputs["angles"], inputs["dists"] = scan.angles, scan.dists
        layout = (str(dev), tuple((n, tuple(v.shape), v.dtype) for n, v in leaves.items()))
        bufs = self._bufs.get(layout)
        if bufs is None:
            bufs = self._bufs[layout] = _Buffers(leaves, dev)
        static = bufs.static(inputs)
        bkey = (layout, tuple((n, tuple(v.shape)) for n, v in inputs.items()))
        names = bufs.leaf_names
        # One odometry (scalar fields) or R of them ([R] fields, a fleet).
        scalar = odom is not None and torch.as_tensor(odom.rot1).dim() == 0
        gens = generators(host)

        def make_fn():
            # The state without its tensors: its generators and gate phases
            # are the block's key, its counters the deltas' origin.
            skeleton = _rebuild(state, "", dict.fromkeys(names), {})

            def body(v):
                st, sc = _inputs(skeleton, names, v)
                od = None
                if "odo" in v:
                    o = v["odo"]
                    od = (Odometry(rot1=o[0, 0], trans=o[0, 1], rot2=o[0, 2]) if scalar else
                          Odometry(rot1=o[:, 0], trans=o[:, 1], rot2=o[:, 2]))
                out = fn(st, od, sc)
                out_leaves, out_host = {}, {}
                _flatten(out, "", out_leaves, out_host)
                if tuple(out_leaves) != names:
                    raise ValueError("a graphed step must return a state of its input's layout")
                body.deltas = {k: out_host[k] - h for k, h in host_fields(skeleton).items()
                               if _is_count(h)}
                return out_leaves

            return body

        phases = tuple(_updates(host) % m for m in gates)
        block = self._get((key, bkey, scalar, phases, tuple(id(g) for g in gens)), static,
                          make_fn, gens, dev)
        return host, bufs, static, {**leaves, **inputs}, block

    def _get(self, full: Tuple, static: Dict[str, torch.Tensor], make_fn, gens, dev) -> Block:
        if dev.type == "cuda" and self.capture and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self.cache.get(full, lambda: Block(make_fn(), static, gens, pool=self._pool,
                                                  capture=self.capture))

    # -- steps ---------------------------------------------------------------
    def run(self, fn: Callable, state, odom: Optional[Odometry] = None,
            scan: Optional[Scan] = None, *, key: Tuple = (), gates: Tuple[int, ...] = ()):
        """`fn(state, odom, scan)` as one block: a graph replay on the card.
        `key` names what fixes the step besides the shapes, generators and
        gates (its config, map, alphas); `gates` the moduli of the
        host-side gates on the state's update counter."""
        with profiling.span("graph.run"):
            with profiling.span("graph.prepare"):
                host, bufs, static, values, block = self._prepare(fn, state, odom, scan, key,
                                                                  gates)
            with profiling.span("graph.load"):
                self._load(bufs, static, values)
            block.run()
            with profiling.span("graph.output"):
                return self._output(state, host, bufs, block)

    def _output(self, state, host, bufs: _Buffers, block: Block):
        """The state after a run: the host counters advanced by the step's
        deltas, the tensors views of one copy of the flat buffers (the
        buffers then hold copies of them)."""
        deltas = block.fn.deltas
        ints = {k: v + deltas[k] for k, v in host.items() if k in deltas}
        copies = {dt: f.clone() for dt, f in bufs.flats.items()}
        self.copies += len(copies)
        self.copy_bytes += bufs.bytes
        leaves = {}
        for dt, names in bufs.groups.items():
            base = bufs.flats[dt]
            for name in names:
                view = bufs.views[name]
                o = view.storage_offset() - base.storage_offset()
                leaves[name] = copies[dt][o:o + view.numel()].view(view.shape)
                bufs.held[name] = (weakref.ref(leaves[name]), leaves[name]._version)
        return _rebuild(state, "", leaves, ints)

    def stats(self) -> dict:
        """Per block (named by its key's tag and gate phases): capture ms,
        the device memory its capture added to the shared pool, replays,
        the conditional nodes it holds; and the counters."""
        blocks = {}
        for k, b in self.cache.blocks.items():
            name = str(k[0][0] if k[0] else "step") + (f"@{k[3]}" if k[3] else "")
            blocks[name] = {"capture_ms": b.capture_ms, "pool_bytes": b.pool_bytes,
                            "replays": b.replays, "if_nodes": b.if_nodes}
        return {"blocks": blocks, "copies": self.copies, "copy_bytes": self.copy_bytes,
                "loads": self.loads, "skipped": self.skipped}


def _inputs(skeleton, names, v):
    """(the state of a block's buffers `v`, its scan or None)."""
    st = _rebuild(skeleton, "", {n: v[n] for n in names}, {})
    return st, (Scan(angles=v["angles"], dists=v["dists"]) if "angles" in v else None)


def host_fields(state) -> dict:
    """A state's fields other than tensors, by dotted name."""
    leaves, host = {}, {}
    _flatten(state, "", leaves, host)
    return host
