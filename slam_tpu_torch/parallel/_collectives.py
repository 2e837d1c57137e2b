"""The port's counterparts of JAX's named-axis collectives, over one dim
of a `parallel.mesh.Mesh`: `lax.pmax` / `pmin` / `psum` (`pmax`, `pmin`,
`psum`), `lax.all_gather` (`all_gather`), `lax.psum_scatter(tiled=False)`
over a [D, ...] buffer (`psum_scatter`), `lax.ppermute` (`ppermute`),
`lax.axis_index` / `axis_size` (`Axis.index`, `Axis.size`).

JAX inserts these from shardings; here every cross-shard step calls one
by hand. Each call adds the elements it moves to a module counter
(`counts`), so a test can hold a step to "no [N]-sized all-gather". A
collective captured in a CUDA graph (an engine's step over NCCL) is
counted at each replay (`core/graph.py:count_host`); one inside a
conditional body, which a replay may skip, is counted on the device by
the body itself and read back by `counts`.

Backends. NCCL takes CUDA tensors. gloo takes CPU tensors, and CUDA
tensors for all-reduce, all-gather and reduce-scatter (probed with torch
2.11 on an H100, two ranks on one card: the right values); its P2P
(`batch_isend_irecv`) aborted both ranks on CUDA tensors ("writev: Bad
address": gloo wrote the device pointer to its socket), so `ppermute`
under gloo copies a CUDA buffer to the host and back and counts the bytes
(`counts()["staged_bytes"]`). Nothing else stages. NCCL given a CPU
tensor raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from slam_tpu_torch.core import graph

_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "ppermute")
_COUNTS: dict = {}
# The counts of collectives in conditional bodies, per CUDA device: int64
# [len(_KINDS) + 2] (the kinds, then the calls and the largest all-gather).
_DEVICE_COUNTS: dict = {}


def reset_counts() -> None:
    """Zero the element counters."""
    _COUNTS.clear()
    _COUNTS.update({k: 0 for k in _KINDS})
    _COUNTS.update(calls=0, largest_all_gather=0, staged_bytes=0)
    for c in _DEVICE_COUNTS.values():
        c.zero_()


def counts() -> dict:
    """Elements moved by each kind of collective since `reset_counts`, the
    number of calls, the largest all-gather's output elements and the bytes
    staged through the host (a host read of the device counts, if any)."""
    out = dict(_COUNTS)
    for c in _DEVICE_COUNTS.values():
        v = c.tolist()
        for k, n in zip(_KINDS + ("calls",), v):
            out[k] += n
        out["largest_all_gather"] = max(out["largest_all_gather"], v[-1])
    return out


def _count(kind: str, elems: int) -> None:
    _COUNTS[kind] += elems
    _COUNTS["calls"] += 1
    if kind == "all_gather":
        _COUNTS["largest_all_gather"] = max(_COUNTS["largest_all_gather"], elems)


reset_counts()


class Axis:
    """One named dim of a mesh as seen from this rank: its process group,
    `size` and this rank's `index` along it."""

    def __init__(self, name: str, group, size: int, index: int, backend: str):
        self.name = name
        self.group = group
        self.size = int(size)
        self.index = int(index)
        self.backend = backend

    def __repr__(self):
        return f"Axis({self.name!r}, size={self.size}, index={self.index}, {self.backend})"

    # -- plumbing ---------------------------------------------------------

    def _note(self, kind: str, elems: int, dev: torch.device) -> None:
        """Count one collective of `elems` elements on `dev`: on the host, or
        inside a conditional body by the body's own kernels on the device
        (their counter is made by an eager run outside the body first)."""
        elems = int(elems)
        if not graph.in_conditional_body():
            if (dev.type == "cuda" and dev not in _DEVICE_COUNTS
                    and not torch.cuda.is_current_stream_capturing()):
                _DEVICE_COUNTS[dev] = torch.zeros(len(_KINDS) + 2, dtype=torch.int64,
                                                  device=dev)
            graph.count_host(_count, kind, elems)
            return
        c = _DEVICE_COUNTS[dev]
        c[_KINDS.index(kind)].add_(elems)
        c[-2].add_(1)
        if kind == "all_gather":
            c[-1].clamp_(min=elems)

    def _check(self, kind: str, t: torch.Tensor) -> None:
        if self.backend == "nccl" and not t.is_cuda:
            raise ValueError(f"{kind} over NCCL needs CUDA tensors, got {t.device}")
        if self.backend not in ("nccl", "gloo"):
            raise ValueError(f"unsupported backend {self.backend!r}")

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        self._note("all_reduce", t.numel(), t.device)
        out = t.clone().contiguous()
        self._check("all_reduce", out)
        dist.all_reduce(out, op=op, group=self.group)
        return out

    # -- the collectives --------------------------------------------------

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.MIN)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[D, *t.shape]: every rank's `t`, in axis order."""
        # Flat buffers: the backends gather along dim 0.
        shape = (self.size,) + tuple(t.shape)
        t = t.contiguous().reshape(-1)
        n = self.size * t.numel()
        self._note("all_gather", n, t.device)
        self._check("all_gather", t)
        out = torch.empty((n,), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out.reshape(shape)

    def psum_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of every rank's [D, ...] `t`, row `index` of it kept
        (`lax.psum_scatter(..., scatter_dimension=0, tiled=False)`)."""
        if t.shape[0] != self.size:
            raise ValueError(f"psum_scatter over {self.size} ranks takes [D, ...], got {tuple(t.shape)}")
        out_shape = tuple(t.shape[1:])
        t = t.contiguous().reshape(-1)
        self._note("reduce_scatter", t.numel(), t.device)
        n = t.numel() // self.size
        self._check("reduce_scatter", t)
        out = torch.empty((n,), dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t, group=self.group)
        return out.reshape(out_shape)

    def ppermute(self, t: torch.Tensor, perm) -> torch.Tensor:
        """`lax.ppermute`: for each (src, dst) in `perm` (axis indices),
        rank src's `t` arrives at rank dst. A rank that no pair targets
        gets zeros. Every request is waited on."""
        t = t.contiguous()
        out = torch.zeros_like(t)
        sends = [dst for src, dst in perm if src == self.index]
        recvs = [src for src, dst in perm if dst == self.index]
        self._note("ppermute", t.numel() * len(sends), t.device)
        if not sends and not recvs:
            return out
        self._check("ppermute", t)
        staged = self.backend == "gloo" and t.is_cuda
        if staged and sends:
            _COUNTS["staged_bytes"] += t.numel() * t.element_size()
        buf_in = t.cpu() if staged and sends else t
        buf_out = torch.zeros(t.shape, dtype=t.dtype) if staged else out
        if len(recvs) > 1:
            raise ValueError("ppermute: at most one source per destination")
        ops = [dist.P2POp(dist.isend, buf_in, dist.get_global_rank(self.group, d), self.group)
               for d in sends]
        ops += [dist.P2POp(dist.irecv, buf_out, dist.get_global_rank(self.group, s), self.group)
                for s in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged and recvs:
            _COUNTS["staged_bytes"] += t.numel() * t.element_size()
            return buf_out.to(t.device)
        return out
