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
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from slam_tpu_torch.core.graph import Block, Cache  # noqa: F401  (the planners name them here)
from slam_tpu_torch.planners._scatter import with_spare


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
