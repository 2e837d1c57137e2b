"""Scatter forms of the JAX planners' `.at[]` updates.

  * `set_drop`: `a.at[idx].set(v, mode="drop")`, with the dropped lanes
    sent to a spare slot one past the end of the last axis. A search loop
    that owns its state keeps that slot in its arrays (`with_spare`) and
    writes them in place (`set_drop_`), so a round copies no array.
  * `last_writer`: which lanes of a duplicate-target `set` scatter win.
    XLA:CPU's scatter runs its updates in order, so the last lane writing
    a target is the one that stays; CUDA's scatter keeps an arbitrary one.
    Writing only the last lane per target makes both devices agree with
    JAX, and makes several arrays scattered to one target take their
    values from the same lane. `last_lanes` gives that lane per target,
    for a scatter in which every lane writes its target's winning value.
"""

from __future__ import annotations

import torch


def with_spare(a: torch.Tensor) -> torch.Tensor:
    """A copy of `a` with a spare slot past the end of its last axis: the
    view of the first n slots of an [..., n + 1] buffer."""
    return torch.cat([a, a[..., :1]], dim=-1)[..., :-1]


def _values(a, idx, v):
    if isinstance(v, torch.Tensor):
        return v.to(device=a.device, dtype=a.dtype).expand(idx.shape)
    # A fill on the device: a host scalar made a tensor would be a copy to
    # the card, which a captured search block cannot hold.
    return torch.full(idx.shape, v, dtype=a.dtype, device=a.device)


def set_drop(a: torch.Tensor, idx: torch.Tensor, v) -> torch.Tensor:
    """`a.at[idx].set(v, mode="drop")` along the last axis, for indices in
    [0, n] where n = a.shape[-1]: index n is dropped. The kept indices must
    be distinct. Returns a new array, made by `with_spare`."""
    out = with_spare(a)
    return set_drop_(out, idx, v)


def set_drop_(a: torch.Tensor, idx: torch.Tensor, v) -> torch.Tensor:
    """`set_drop` in place, on an array made by `with_spare` or `set_drop`:
    index n writes the spare slot."""
    n = a.shape[-1]
    base = a._base
    if base is None or base.shape[-1] != n + 1:
        raise ValueError("set_drop_ needs an array with a spare slot (with_spare)")
    ext = a.as_strided(a.shape[:-1] + (n + 1,), a.stride())
    ext.scatter_(-1, idx.long(), _values(a, idx, v))
    return a


def last_lanes(won: torch.Tensor, tgt: torch.Tensor, n: int) -> torch.Tensor:
    """int64[n]: for each target in [0, n) of a 1-D scatter to `tgt`, the
    last of the `won` lanes that scatter to it, or -1 where none does.
    Every lane scatters to its own target (the lanes that did not win
    offer -1, which never wins), so no slot collects the losers: on CUDA
    such a slot serializes their atomics."""
    lane = torch.arange(tgt.numel(), device=tgt.device)
    top = torch.full((n,), -1, dtype=torch.int64, device=tgt.device)
    return top.scatter_reduce(0, tgt.long(), torch.where(won, lane, -1), "amax")


def last_writer(won: torch.Tensor, tgt: torch.Tensor, n: int) -> torch.Tensor:
    """bool mask of the lanes of a 1-D scatter to `tgt` (in [0, n)) that
    write: among the `won` lanes of each target, the last one."""
    lane = torch.arange(tgt.numel(), device=tgt.device)
    return won & (last_lanes(won, tgt, n)[tgt] == lane)
