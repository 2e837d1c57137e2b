"""CUDA graphs of the planners' search blocks: the port's counterpart of
the JAX package's device `while_loop` solves. `Block` and `Cache` live in
`core/graph.py` (the filter steps' graphs use them too); this module adds
the planners' buffers and their flag loop.

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

By default a search runs as a *chain* (`core/graph.py:Chain`, the port's
device `lax.while_loop`): one graph runs up to `copies` blocks, each
guarded on the device by the flag and round counter the block before it
wrote, and the host reads the flag once a replay (`run_chain`). A cache
made with `chain=False` replays single blocks with a host read before
each (`replay_until`), for comparison. Both give the eager loop's state,
rounds and iterations launched.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from slam_tpu_torch.core import graph as core_graph
from slam_tpu_torch.core.graph import Block, Chain  # noqa: F401  (the planners name them here)
from slam_tpu_torch.planners._scatter import with_spare


class Cache(core_graph.Cache):
    """A planner's blocks (`core/graph.py:Cache`); `chain` picks chains
    (the default) or single-block replays."""

    def __init__(self, max_blocks: int = core_graph._MAX_BLOCKS, chain: bool = True):
        super().__init__(max_blocks)
        self.chain = chain


def go(v: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The search loop's condition on the device: some flag is set and the
    counter `it` is below its `limit`."""
    return v["flag"].any() & (v["it"] < v["limit"])


def block_or_chain(graphs: Cache, key: Tuple, fn, make_static, per_block: int, copies: int,
                   generators=(), span: str | None = None) -> Block:
    """The cache's block of `fn` for `key` (buffers `make_static()` when it
    is new): a `Chain` of up to `copies` runs when the cache makes chains,
    else a `Block`; `span` times either's replays on the device
    (`core/graph.py:Block`)."""
    if graphs.chain:
        return graphs.get(key + ("chain", copies), lambda: Chain(
            fn, make_static(), copies, go, per_block, generators=generators, span=span))
    return graphs.get(key, lambda: Block(fn, make_static(), generators, span=span))


def solve(block: Block, n_iters: int, per_block: int) -> Tuple[int, int]:
    """Run a loaded search block to its end: `run_chain` for a chain,
    `replay_until` for a block. Returns (iterations launched, host reads)."""
    if isinstance(block, Chain):
        return run_chain(block, n_iters)
    return replay_until(block, n_iters, per_block)


def run_chain(chain: Chain, n_iters: int) -> Tuple[int, int]:
    """Run `chain` (its counter `it` loaded at 0) until its flag clears or
    `n_iters` iterations have run: one host read of the flag and the
    counter a replay. Returns (iterations launched, host reads)."""
    it = reads = 0
    while True:
        flag, it = chain.run(it)
        reads += 1
        if not flag or it >= n_iters:
            return it, reads


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
