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
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Callable, Dict, Iterable, Tuple

import torch

# Eager runs of a block on a side stream before its capture.
_WARMUP = 1
# Blocks a cache keeps by default (one a search kind and query count).
_MAX_BLOCKS = 8
# Launches of each kernel wrapper that the capture under way recorded
# (None outside a capture), and whether a block's warm-up is running.
_TALLY = None
_WARMING = False


def count_launch(wrapper) -> None:
    """Count one launch of a hand-written kernel's wrapper in its
    `launches`: at once when the kernel runs now (a block's warm-up too,
    also counted in `warmup_launches`), or, while a block's graph is
    captured, once at each replay of that graph (`Block.run`), which is
    when the kernel runs."""
    if _TALLY is not None:
        _TALLY[wrapper] = _TALLY.get(wrapper, 0) + 1
        return
    wrapper.launches += 1
    if _WARMING:
        wrapper.warmup_launches += 1


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b are the same elements of the same memory."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


class Block:
    """One block over static buffers: `static` (name -> tensor) is owned by
    the block, or shared by the blocks of one cache that read the same
    inputs; `load` writes new values into it, `run` runs the block once (a
    replay on the card, the capture at the first run).

    `generators` are the `torch.Generator`s the block draws from: the graph
    registers them, so every replay draws what the eager block would draw
    next and advances them as far. `pool` is a graph memory pool handle
    (`torch.cuda.graph_pool_handle()`) that blocks whose pool memory holds
    nothing between replays may share."""

    def __init__(self, fn: Callable, static: Dict[str, torch.Tensor],
                 generators: Iterable[torch.Generator] = (), guard=contextlib.nullcontext,
                 pool=None):
        self.fn = fn
        self.static = static
        self.generators = tuple(generators)
        self.guard = guard
        self.pool = pool
        self.graph = None
        self.replays = 0
        self.capture_ms = 0.0
        # The kernel wrappers' launches a replay makes (`count_launch`).
        self.tally = {}
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
        # The warm-up advances the block's state and the generators: both
        # are put back before the capture, which runs nothing.
        saved = {k: v.clone() for k, v in self.static.items()}
        gen_states = [g.get_state() for g in self.generators]
        global _TALLY, _WARMING
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        _WARMING = True
        try:
            with torch.cuda.stream(side), self.guard():
                for _ in range(_WARMUP):
                    self._step()
        finally:
            _WARMING = False
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
        _TALLY = {}
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self._step()
        finally:
            self.tally, _TALLY = _TALLY, None
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
        for wrapper, n in self.tally.items():
            wrapper.launches += n


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
