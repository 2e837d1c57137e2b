"""CUDA graphs of the planners' search blocks: the port's counterpart of
the JAX package's device `while_loop` solves. `Block`, `Chain` and `Cache`
live in `core/graph.py` (the filter steps' graphs use them too); this
module adds the planners' buffers and their search loop.

A search loop runs gated rounds (a round whose `active` flag is False
changes nothing). The run of rounds between two tests of the loop's
condition on the host is a *block*: a function `fn(v) -> out`, where `v`
holds the static buffers by name and `out` the buffers' new values by
name. A value that the block committed in place (the same memory) is
left; any other is copied into its static buffer at the end of the
block, so the next block starts from it.

Every search runs as a *chain* (`core/graph.py:Chain`, the port's device
`lax.while_loop`): up to `copies` blocks a run, each guarded by the flag
and iteration counter the block before it wrote, and one host read of the
flag a run (`run_chain`). On the card a run is one replay of a captured
CUDA graph; on the CPU the same block code runs eagerly.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from slam_tpu_torch.core.graph import Cache, Chain
from slam_tpu_torch.planners._scatter import with_spare


def go(v: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The search loop's condition on the device: some flag is set and the
    counter `it` is below its `limit`."""
    return v["flag"].any() & (v["it"] < v["limit"])


def search(graphs: Cache, key: Tuple, fn, values: Dict[str, torch.Tensor], n_iters: int,
           per_block: int, copies: int, out: Iterable[str], spare: Iterable[str] = (),
           generators=(), span: str | None = None) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Run a search loop of `n_iters` iterations at most, `per_block` a
    block `fn`, as the cache's chain of up to `copies` blocks for `key`
    (made at its first use, its buffers copies of `values` with a spare
    slot for the names in `spare`; `generators` and `span` as
    `core/graph.py:Chain`). `values` holds the state's fields, the block's
    other inputs and the loop's `flag`; the counter `it` (loaded at 0) and
    its `limit` are added here. Returns (copies of the buffers named in
    `out` after the loop, iterations launched, host reads)."""
    dev = values["flag"].device
    values = {**values, "it": torch.full((), 0, dtype=torch.int32, device=dev),
              "limit": torch.full((), n_iters, dtype=torch.int32, device=dev)}
    spare = set(spare)
    chain = graphs.get(key + ("chain", copies), lambda: Chain(
        fn, {k: with_spare(v) if k in spare else v.clone() for k, v in values.items()},
        copies, go, per_block, generators=generators, span=span))
    chain.load(**values)
    launched, reads = run_chain(chain, n_iters)
    return {k: chain.static[k].clone() for k in out}, launched, reads


def run_chain(chain: Chain, n_iters: int) -> Tuple[int, int]:
    """Run `chain` (its counter `it` loaded at 0) until its flag clears or
    `n_iters` iterations have run: one host read of the flag and the
    counter a run of the chain. Returns (iterations launched, host
    reads)."""
    it = reads = 0
    while True:
        flag, it = chain.run(it)
        reads += 1
        if not flag or it >= n_iters:
            return it, reads

