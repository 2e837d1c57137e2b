"""CUDA graphs of the planners' search blocks: the port's counterpart of
the JAX package's device `while_loop` solves.

A search loop runs gated rounds (a round whose `active` flag is False
changes nothing) and reads its flag on the host once every few rounds. The
run of rounds between two host reads is a *block*. On the card a block is
captured once into a `torch.cuda.CUDAGraph` over static buffers and then
replayed, one launch a block, until the flag says the search is done; the
host makes the same flag reads as the eager loop. On the CPU a block runs
eagerly, with the same code.

A block is a function `fn(v) -> out`: `v` holds the static buffers by
name, and `out` the buffers' new values by name. A value that the block
committed in place (the same memory) is left; any other is copied into
its static buffer at the end of the block, inside the graph, so the next
replay starts from it.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Callable, Dict, Iterable, Tuple

import torch

from slam_tpu_torch.planners._scatter import with_spare

# Eager runs of a block on a side stream before its capture.
_WARMUP = 1
# Blocks a planner keeps (one a search kind and query count).
_MAX_BLOCKS = 8


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b are the same elements of the same memory."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


class Block:
    """One block over static buffers: `static` (name -> tensor) is owned by
    the block; `load` writes new values into it, `run` runs the block once
    (a replay on the card, the capture at the first run).

    `generators` are the `torch.Generator`s the block draws from: the graph
    registers them, so every replay draws what the eager block would draw
    next and advances them as far."""

    def __init__(self, fn: Callable, static: Dict[str, torch.Tensor],
                 generators: Iterable[torch.Generator] = (), guard=contextlib.nullcontext):
        self.fn = fn
        self.static = static
        self.generators = tuple(generators)
        self.guard = guard
        self.graph = None
        self.replays = 0
        self.capture_ms = 0.0
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

    def _capture(self) -> None:
        dev = next(iter(self.static.values())).device
        t0 = time.perf_counter()
        # The warm-up advances the search and the generators: both are put
        # back before the capture, which runs nothing.
        saved = {k: v.clone() for k, v in self.static.items()}
        gen_states = [g.get_state() for g in self.generators]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), self.guard():
            for _ in range(_WARMUP):
                self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
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
        with torch.cuda.graph(graph):
            self._step()
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph = graph

    def run(self) -> None:
        if not next(iter(self.static.values())).is_cuda:
            with self.guard():
                self._step()
            return
        if self.graph is None:
            self._capture()
        with self.guard():
            self.graph.replay()
        self.replays += 1


class Cache:
    """The blocks of one planner, keyed by what fixes their shapes and
    constants. `clear` drops them (a new map); the planners keep them
    across queries. `guard` is the context the blocks run their warm-up,
    every replay and every eager run under (a check may make a host read
    raise there)."""

    def __init__(self):
        self.blocks: "OrderedDict[Tuple, Block]" = OrderedDict()
        self.guard = contextlib.nullcontext

    def get(self, key: Tuple, make: Callable[[], Block]) -> Block:
        block = self.blocks.get(key)
        if block is None:
            block = make()
            block.guard = self.guard
            self.blocks[key] = block
            while len(self.blocks) > _MAX_BLOCKS:
                self.blocks.popitem(last=False)
        else:
            self.blocks.move_to_end(key)
            block.guard = self.guard
        return block

    def clear(self) -> None:
        self.blocks.clear()


def buffers(values: Dict[str, torch.Tensor], spare: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """Static buffers holding copies of `values`; the names in `spare` get
    a spare slot past the end of their last axis (`_scatter.with_spare`),
    for the in-place drop scatters."""
    spare = set(spare)
    return {k: with_spare(v) if k in spare else v.clone() for k, v in values.items()}


def replay_until(block: Block, n_iters: int, per_block: int) -> Tuple[int, int]:
    """Run `block` (`per_block` loop iterations) while fewer than `n_iters`
    iterations have run and its `flag` buffer holds a True: the eager
    loop's flag reads, made before each block. Returns (iterations
    launched, host reads of the flag)."""
    it = reads = 0
    while it < n_iters:
        reads += 1
        if not bool(block.static["flag"].any()):
            break
        block.run()
        it += per_block
    return it, reads
