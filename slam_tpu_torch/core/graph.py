"""CUDA graphs of gated blocks of work: the port's counterpart of a JAX
program compiled once and run many times (`jax.jit`, a device
`while_loop`).

A *block* is a function `fn(v) -> out` over static buffers: `v` holds the
buffers by name, and `out` their new values by name. A value that the
block committed in place (the same memory) is left; any other is copied
into its static buffer at the end of the block, inside the graph, so the
next run starts from it. On the card a block is captured once into a
`torch.cuda.CUDAGraph` and then replayed, one launch a block; on the CPU
it runs eagerly, with the same code.

The planners replay the rounds of a search between two host reads of its
flag (`planners/_graph.py`); the filters replay one step of an entry point
(`models/_graph.py`).

Device control flow, the port's `lax.cond` and `lax.while_loop`:

  * `cond(pred, true_fn, false_fn, *operands)`: inside a capture it
    records two CUDA graph IF nodes, one on `pred` and one on `~pred`, each
    with its branch captured as the body (`csrc/graph_cond.cu`), both
    writing one set of output buffers; a replay runs one branch with no
    host read. Outside a capture it runs both branches and selects (JAX's
    lowering of `lax.cond` under `vmap`), reading nothing; an eager call
    on the card may ask to read `pred` once and run one branch instead.
  * `Chain`: up to `copies` runs of a block a replay, each guarded by a
    predicate of the buffers that the run before it wrote (one WHILE node,
    or `copies` IF nodes for a block that draws random numbers): a replay
    runs up to `copies` blocks of a search with no host read, then one
    read says whether to replay again.

A branch or a chained block draws no random numbers (draw them before the
`cond`, as JAX splits its key before `lax.cond`), except a chain's, whose
generators the chain puts back where the blocks that ran leave them. It
allocates only from the capture's pool: the first IF node of a capture
routes every allocation of the capturing thread there, the bodies'
streams included.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import time
from collections import OrderedDict
from typing import Callable, Dict, Iterable, Tuple

import torch

from slam_tpu_torch.utils import profiling

# Eager runs of a block on a side stream before its capture.
_WARMUP = 1
# Blocks a cache keeps by default (one a search kind and query count).
_MAX_BLOCKS = 8
# Launches of each kernel wrapper that the capture under way recorded
# (None outside a capture), the host counter updates it recorded
# (`count_host`), and whether a block's warm-up is running.
_TALLY = None
_NOTES = None
_WARMING = False
# The capture under way (`_Capture`), None outside one, and the streams
# that capture conditional bodies, by (device index, nesting depth).
_CAPTURE = None
_BODY_STREAMS: Dict[Tuple[int, int], torch.cuda.Stream] = {}
# Slots of a graph's clock at the least; a graph whose warm-up passed more
# timed span boundaries (`note_warm_stamps`) gets a slot for each.
_CLOCK_SLOTS = 64
# The timed span boundaries the warm-up under way has passed.
_WARM_STAMPS = 0


def count_launch(wrapper) -> None:
    """Count one launch of a hand-written kernel's wrapper in its
    `launches`: at once when the kernel runs now (a block's warm-up too,
    also counted in `warmup_launches`), or, while a block's graph is
    captured, once at each replay of that graph (`Block.run`), which is
    when the kernel runs."""
    if _TALLY is not None:
        if in_conditional_body():
            raise RuntimeError(
                "a hand-written kernel inside a conditional body: a replay may skip it, "
                "so the capture's tally cannot count it; launch it outside the cond")
        _TALLY[wrapper] = _TALLY.get(wrapper, 0) + 1
        return
    wrapper.launches += 1
    if _WARMING:
        wrapper.warmup_launches += 1


def count_host(fn: Callable, *args) -> None:
    """Apply a host-side counter update `fn(*args)` for work the caller
    issues now: at once, or, while a block's graph is captured, at each
    replay of that graph, as `count_launch` counts a launch. Inside a
    conditional body a replay may skip the work, so the caller counts it
    on the device there (`in_conditional_body`)."""
    if _NOTES is not None:
        if in_conditional_body():
            raise RuntimeError("a host-side count inside a conditional body: a replay may "
                               "skip its work; count it on the device")
        _NOTES.append((fn, args))
        return
    fn(*args)


def note_warm_stamps(n: int) -> None:
    """Count `n` span boundaries that a block's warm-up passes with a CUDA
    device to time: its capture stamps as many at the most (it stamps
    none inside a conditional body, where the warm-up runs both
    branches), so its clock is made with a slot for each."""
    global _WARM_STAMPS
    _WARM_STAMPS += n


def in_conditional_body() -> bool:
    """Whether a conditional node's body is being captured now."""
    return _CAPTURE is not None and _CAPTURE.depth > 0


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b are the same elements of the same memory."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


class _Clock:
    """The clock of a graph's timed spans (`utils/profiling.py:span`):
    pinned host slots that its kernel nodes stamp with the device's
    nanosecond timer (`csrc/span_clock.cu`), the spans that stamped them
    ((name, start slot, end slot)), and an event recorded after a replay
    whose stamps are to be read. Made before the capture starts, with
    `size` slots."""

    def __init__(self, size: int):
        self.slots = torch.zeros(size, dtype=torch.int64, pin_memory=True)
        self.stamps = 0
        self.spans = []
        self.done = torch.cuda.Event()

    def stamp(self) -> int:
        """Capture, on the current stream, the kernel that stamps the next
        slot; returns the slot."""
        from slam_tpu_torch.ops import _build

        i = self.stamps
        if i == self.slots.numel():
            raise RuntimeError(f"more than {i} timed span boundaries in one graph")
        _build.check(_build.library()[0].span_clock_launch(
            self.slots[i:].data_ptr(), torch.cuda.current_stream().cuda_stream),
            "span_clock_launch")
        self.stamps += 1
        return i


class _Capture:
    """A block's capture under way: its device and memory pool, the
    nesting depth of the body being captured, the IF nodes recorded, and
    the graph's clock (`_Clock`, of `clock_slots` slots)."""

    def __init__(self, dev: torch.device, pool, clock_slots: int):
        self.dev = dev
        self.index = dev.index if dev.index is not None else torch.cuda.current_device()
        self.pool = pool
        self.depth = 0
        self.routed = False
        self.if_nodes = 0
        self.clock = _Clock(clock_slots)

    def route_pool(self) -> None:
        """Route every allocation of this thread to the capture's pool, on
        any stream: torch's filter for the capture matches only the
        capturing stream, and a body is captured on another."""
        if not self.routed:
            torch._C._cuda_endAllocateToPool(self.index, self.pool)
            torch._C._cuda_beginAllocateCurrentThreadToPool(self.index, self.pool)
            # The begin took a use of the pool, which the graph holds already.
            torch._C._cuda_releasePool(self.index, self.pool)
            self.routed = True

    def stream(self) -> torch.cuda.Stream:
        """The stream that captures the bodies at the current depth."""
        key = (self.index, self.depth)
        if key not in _BODY_STREAMS:
            from slam_tpu_torch.ops import _build

            raw = ctypes.c_void_p()
            _build.check(_build.library()[0].graph_cond_stream(ctypes.byref(raw)),
                         "graph_cond_stream")
            _BODY_STREAMS[key] = torch.cuda.ExternalStream(raw.value, device=self.dev)
        return _BODY_STREAMS[key]


def _flat(out):
    """(the tensors of a branch's output, a tensor or a tuple / list of
    them; whether it was a single tensor)."""
    if isinstance(out, torch.Tensor):
        return [out], True
    return list(out), False


@contextlib.contextmanager
def _if_node(pred: torch.Tensor, invert: bool = False, loop: bool = False):
    """Record, in the capture under way, a conditional node on the device
    bool `pred` (on `~pred` with `invert`) behind a kernel that sets its
    condition: an IF node, or with `loop` a WHILE node, whose body must
    set the condition again at its end (`_set_condition`). What runs
    inside the context is captured into the body, on another stream.
    Yields the node's conditional handle."""
    from slam_tpu_torch.ops import _build

    cap = _CAPTURE
    cap.route_pool()
    lib = _build.library()[0]
    pred = pred.reshape(()).to(torch.bool).contiguous()
    parent = torch.cuda.current_stream(cap.dev)
    child = cap.stream()
    body, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
    _build.check(lib.graph_cond_begin(parent.cuda_stream, pred.data_ptr(), int(invert), int(loop),
                                      child.cuda_stream, ctypes.byref(body),
                                      ctypes.byref(handle)), "graph_cond_begin")
    cap.if_nodes += 1
    cap.depth += 1
    try:
        with torch.cuda.stream(child):
            yield handle.value
    finally:
        cap.depth -= 1
        _build.check(lib.graph_cond_end(child.cuda_stream), "graph_cond_end")


def _set_condition(handle: int, pred: torch.Tensor) -> None:
    """Capture, on the current stream, the kernel that sets a WHILE node's
    condition from the device bool `pred`."""
    from slam_tpu_torch.ops import _build

    pred = pred.reshape(()).to(torch.bool).contiguous()
    stream = torch.cuda.current_stream(pred.device).cuda_stream
    _build.check(_build.library()[0].graph_cond_set(handle, pred.data_ptr(), stream),
                 "graph_cond_set")


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, *operands,
         host_read: bool = False):
    """`lax.cond(pred, true_fn, false_fn, *operands)`: the branch `pred`
    (a bool 0-d tensor) picks, applied to `operands`. Each branch returns
    a tensor or a tuple / list of tensors of the same shapes and dtypes. A
    branch draws no random numbers, and a tensor it returns unchanged is
    one of `operands` (not one it closes over), so that it is copied.

    Inside a block's capture: two IF nodes, the true branch's body first;
    its outputs are the result, and the false branch's body copies its
    own into them, so a replay runs one branch and reads nothing on the
    host. Elsewhere both branches run, then a select, which reads nothing
    (JAX's lowering under `vmap`): on the CPU, in a block's warm-up, and
    in an eager call on the card, where with `host_read` the call reads
    `pred` once instead and runs one branch (for a branch too costly to
    run in vain)."""
    if _CAPTURE is not None:
        return _if_else(pred, true_fn, false_fn, operands)
    if host_read and pred.is_cuda and not _WARMING:
        return (true_fn if bool(pred) else false_fn)(*operands)
    a, single = _flat(true_fn(*operands))
    b, _ = _flat(false_fn(*operands))
    if len(a) != len(b):
        raise ValueError("the branches of a cond return different structures")
    out = [torch.where(pred, x, y) for x, y in zip(a, b)]
    return out[0] if single else tuple(out)


def _if_else(pred, true_fn, false_fn, operands):
    held = {t.untyped_storage().data_ptr() for t in operands if isinstance(t, torch.Tensor)}
    with _if_node(pred):
        outs, single = _flat(true_fn(*operands))
        # The results live in fresh buffers of the capture's pool: an
        # operand returned as it is, or a strided view, is copied.
        for i, t in enumerate(outs):
            ptr = t.untyped_storage().data_ptr()
            if ptr in held or not t.is_contiguous():
                outs[i] = t.clone(memory_format=torch.contiguous_format)
            held.add(outs[i].untyped_storage().data_ptr())
    with _if_node(pred, invert=True):
        other, _ = _flat(false_fn(*operands))
        if len(other) != len(outs):
            raise ValueError("the branches of a cond return different structures")
        for dst, src in zip(outs, other):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"cond branches disagree: {tuple(dst.shape)} {dst.dtype} "
                                 f"against {tuple(src.shape)} {src.dtype}")
            dst.copy_(src)
    return outs[0] if single else tuple(outs)


class Block:
    """One block over static buffers: `static` (name -> tensor) is owned by
    the block, or shared by the blocks of one cache that read the same
    inputs; `load` writes new values into it, `run` runs the block once (a
    replay on the card, the capture at the first run).

    `generators` are the `torch.Generator`s the block draws from: the graph
    registers them, so every replay draws what the eager block would draw
    next and advances them as far. `pool` is a graph memory pool handle
    (`torch.cuda.graph_pool_handle()`) that blocks whose pool memory holds
    nothing between replays may share. With `capture` False the block runs
    eagerly on the card too, as on the CPU (work that a graph cannot hold:
    gloo's collectives run on the host). `span` names a span
    (`utils/profiling.py`) that times the graph's device work a replay,
    stamped outside every conditional node (a chain's runs included,
    which no span inside the body can time)."""

    def __init__(self, fn: Callable, static: Dict[str, torch.Tensor],
                 generators: Iterable[torch.Generator] = (), guard=contextlib.nullcontext,
                 pool=None, capture: bool = True, span: str | None = None):
        self.fn = fn
        self.static = static
        self.generators = tuple(generators)
        self.guard = guard
        self.pool = pool
        self.capture = capture
        self.span = span
        self.graph = None
        self.replays = 0
        self.capture_ms = 0.0
        # The kernel wrappers' launches a replay makes (`count_launch`), the
        # host counter updates (`count_host`), the conditional nodes the
        # graph holds (`cond`, `Chain`), and its clock (`_Clock`, read by
        # `profiling.replayed`).
        self.tally = {}
        self.notes = []
        self.if_nodes = 0
        self.clock = None
        # Set at the capture: the device memory the graph's private pool
        # took (the rise of reserved memory over the capture; the peak of
        # allocated memory does not see it, as the pool's blocks are free
        # between replays).
        self.pool_bytes = 0

    def load(self, **values) -> None:
        """Copy each value (a tensor, or a Python number filled on the
        device) into its static buffer."""
        for name, v in values.items():
            if isinstance(v, torch.Tensor):
                self.static[name].copy_(v)
            else:
                self.static[name].fill_(v)

    def _step(self) -> None:
        out = self.fn(self.static)
        for name, v in out.items():
            s = self.static[name]
            if not _same(v, s):
                s.copy_(v)

    def _warm(self, dev) -> None:
        """The eager runs before the capture, on a side stream."""
        global _WARMING, _WARM_STAMPS
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        _WARMING, _WARM_STAMPS = True, 0
        try:
            with torch.cuda.stream(side), self.guard():
                for _ in range(_WARMUP):
                    self._step()
        finally:
            _WARMING = False
        torch.cuda.current_stream(dev).wait_stream(side)

    def _record(self) -> None:
        """What the capture records."""
        self._step()

    def _capture(self) -> None:
        with profiling.span("graph.capture"):
            self._capture_graph()

    def _capture_graph(self) -> None:
        dev = next(iter(self.static.values())).device
        t0 = time.perf_counter()
        # The warm-up advances the block's state and the generators: both
        # are put back before the capture, which runs nothing.
        saved = {k: v.clone() for k, v in self.static.items()}
        gen_states = [g.get_state() for g in self.generators]
        global _TALLY, _NOTES, _CAPTURE
        self._warm(dev)
        # The block's own span stamps twice besides what one run stamps.
        clock_slots = max(_CLOCK_SLOTS, _WARM_STAMPS // _WARMUP + 2)
        for k, v in saved.items():
            self.static[k].copy_(v)
        del saved
        for g, s in zip(self.generators, gen_states):
            g.set_state(s)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        # An explicit pool: a conditional body's allocations are routed to
        # it by its id (`_Capture.route_pool`).
        pool = self.pool if self.pool is not None else torch.cuda.graph_pool_handle()
        _TALLY, _NOTES = {}, []
        cap = _CAPTURE = _Capture(dev, pool, clock_slots)
        # No garbage collection during the capture: a collection that frees
        # an earlier block's graph (an engine left in a reference cycle)
        # destroys it, a call that a capture under way refuses, and the
        # capture is lost. Such garbage is collected after it.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool), (
                    profiling.span(self.span, dev) if self.span else contextlib.nullcontext()):
                self._record()
        except BaseException:
            if cap.routed:  # a failed capture may leave the thread's routing behind
                with contextlib.suppress(RuntimeError):
                    torch._C._cuda_endAllocateToPool(cap.index, pool)
            raise
        finally:
            if collecting:
                gc.enable()
            self.tally, _TALLY = _TALLY, None
            self.notes, _NOTES = _NOTES, None
            self.if_nodes, _CAPTURE = cap.if_nodes, None
            self.clock = cap.clock
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph = graph

    def run(self) -> None:
        if not self.capture or not next(iter(self.static.values())).is_cuda:
            with profiling.span("graph.replay"), self.guard():
                self._step()
            return
        if self.graph is None:
            self._capture()
        self._launch()

    def _launch(self) -> None:
        """Replay the graph; count the replay, and the launches, host
        counts and span timings it made."""
        profiling.settle(self)
        with profiling.span("graph.replay"), self.guard():
            self.graph.replay()
        self.replays += 1
        for wrapper, n in self.tally.items():
            wrapper.launches += n
        for fn, args in self.notes:
            fn(*args)
        profiling.replayed(self, self.clock)


class Chain(Block):
    """Up to `copies` runs of a search's block a replay, each guarded by
    `go(static)` (a bool 0-d tensor of the buffers, taken before each run
    from what the run before it wrote): the port's counterpart of a device
    `lax.while_loop`. A replay runs the block until `go` fails or `copies`
    runs have passed, with no host read; `run` then reads the buffers'
    `flag` and run counter `it` on the host once.

    Without generators the chain is one WHILE node over one captured body
    (the block, a per-replay run count, then `go` and the count set the
    condition again). A block that draws from `generators` is captured
    `copies` times, each behind its own IF node, so each run draws what
    the next eager block would (a copy of one body would repeat its
    draws); after a replay every generator is put where the runs that
    happened leave it, as a replay advances a registered generator by
    every captured run. `per_run` is what one run adds to `it`. On the
    CPU, and on the card with `capture` False, `run` runs the block while
    `go` holds, up to `copies` times, reading `go` between runs."""

    def __init__(self, fn: Callable, static: Dict[str, torch.Tensor], copies: int,
                 go: Callable, per_run: int, generators: Iterable[torch.Generator] = (),
                 guard=contextlib.nullcontext, pool=None, capture: bool = True,
                 span: str | None = None):
        super().__init__(fn, static, generators, guard, pool, capture, span)
        self.copies = copies
        self.go = go
        self.per_run = per_run
        # Each generator's offset advance in one run of the block.
        self._advance = ()

    def _warm(self, dev) -> None:
        before = [g.get_offset() for g in self.generators]
        super()._warm(dev)
        self._advance = tuple((g.get_offset() - b) // _WARMUP
                              for g, b in zip(self.generators, before))

    def _record(self) -> None:
        if self.generators:
            for _ in range(self.copies):
                with _if_node(self.go(self.static)):
                    self._step()
            return
        count = torch.zeros((), dtype=torch.int32, device=self.static["it"].device)
        with _if_node(self.go(self.static), loop=True) as handle:
            self._step()
            count.add_(1)
            _set_condition(handle, self.go(self.static) & (count < self.copies))

    def _read(self) -> Tuple[bool, int]:
        flag, it = torch.stack([self.static["flag"].any().to(torch.int64),
                                self.static["it"].to(torch.int64)]).tolist()
        return bool(flag), int(it)

    def run(self, it: int) -> Tuple[bool, int]:
        """Run the chain from the counter value `it` (the last read's, or
        the loaded one); returns (the flag's any(), the counter) after it."""
        if not self.capture or not next(iter(self.static.values())).is_cuda:
            for _ in range(self.copies):
                if not bool(self.go(self.static)):
                    break
                with self.guard():
                    self._step()
            return self._read()
        if self.graph is None:
            self._capture()
        offsets = [g.get_offset() for g in self.generators]
        self._launch()
        flag, after = self._read()
        done = (after - it) // self.per_run
        for g, o, a in zip(self.generators, offsets, self._advance):
            g.set_offset(o + done * a)
        return flag, after


class Cache:
    """Blocks keyed by what fixes their shapes and constants. `clear`
    drops them (a new map); the planners keep them across queries. `guard`
    is the context the blocks run their warm-up, every replay and every
    eager run under (a check may make a host read raise there)."""

    def __init__(self, max_blocks: int = _MAX_BLOCKS):
        self.blocks: "OrderedDict[Tuple, Block]" = OrderedDict()
        self.guard = contextlib.nullcontext
        self.max_blocks = max_blocks

    def get(self, key: Tuple, make: Callable[[], Block]) -> Block:
        block = self.blocks.get(key)
        if block is None:
            block = make()
            block.guard = self.guard
            self.blocks[key] = block
            while len(self.blocks) > self.max_blocks:
                self.blocks.popitem(last=False)
        else:
            self.blocks.move_to_end(key)
            block.guard = self.guard
        return block

    def clear(self) -> None:
        self.blocks.clear()
