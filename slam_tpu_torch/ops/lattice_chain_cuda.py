"""The lattice Hybrid A*'s parent-chain walk on the card: the kernel
`csrc/lattice_chain.cu`.

It replaces no Pallas kernel (the JAX package walks the chain in a
`lax.scan`); PyTorch walks it as ~16 eager ops a step. `planners/hastar.py`
routes a walk whose packed words lie on a CUDA device here and keeps the
eager `_lattice_chain_device` / `_lattice_chain_cost` for the CPU. The
cells, the next index, `done` and the quantized cost equal the eager
walk's bit for bit. A failed build or launch raises; there is no fallback
to the eager walk.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.core.graph import count_launch
from slam_tpu_torch.ops import _build

# csrc/lattice_chain.cu: the words before the cells in a launch's output
# (cells written, their edges' cost, done, the next index), the edge ids a
# packed word holds and the heading bins the shared tables take.
HEADER = 4
EDGES = 8
MAX_BINS = 384


def kernel_inputs(gp, inv_off, edge_cost, idx, start, max_len):
    """(S, K, E) after checking what the kernel takes: `gp` i32 [S]; the
    tables i64 [K, E] (K <= MAX_BINS, E <= EDGES); `idx` and `start` one
    i32 or i64 element each; all contiguous on one CUDA device; `max_len`
    >= 1. Raises ValueError otherwise, before any build."""
    if gp.dtype != torch.int32 or gp.dim() != 1 or gp.numel() < 1 or not gp.is_contiguous():
        raise ValueError(f"gp must be contiguous non-empty i32 [S], got {gp.dtype} "
                         f"{tuple(gp.shape)}")
    if inv_off.dim() != 2:
        raise ValueError(f"inv_off must be [K, E], got {tuple(inv_off.shape)}")
    k, e = inv_off.shape
    if not (1 <= k <= MAX_BINS and 1 <= e <= EDGES):
        raise ValueError(f"the kernel takes 1 to {MAX_BINS} bins and 1 to {EDGES} edges, got "
                         f"{tuple(inv_off.shape)}")
    dev = gp.device
    for name, v in (("inv_off", inv_off), ("edge_cost", edge_cost)):
        if (v.dtype != torch.int64 or v.shape != inv_off.shape or v.device != dev
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous i64 {tuple(inv_off.shape)} on {dev}, "
                             f"got {v.dtype} {tuple(v.shape)} on {v.device}")
    for name, v in (("idx", idx), ("start", start)):
        if v.dtype not in (torch.int32, torch.int64) or v.numel() != 1 or v.device != dev:
            raise ValueError(f"{name} must be one i32 or i64 element on {dev}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if int(max_len) < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    if not gp.is_cuda:
        raise ValueError("the kernel takes tensors on a CUDA device")
    return gp.numel(), k, e


def launch(gp, inv_off, edge_cost, idx, start, max_len: int) -> torch.Tensor:
    """Walk up to `max_len` steps of the parent chain in the packed words
    `gp` from the index in `idx` towards the one in `start`. Returns i64
    [HEADER + max_len]: the cells written n, the quantized cost of their
    parent edges summed, done (1 or 0), the next index (its element, a
    one-element view, is the next chunk's `idx`), then the visited states
    goal -> start, -1 past n."""
    s, k, e = kernel_inputs(gp, inv_off, edge_cost, idx, start, max_len)
    dev = gp.device
    out = torch.empty(HEADER + int(max_len), dtype=torch.int64, device=dev)
    lib, _ = _build.library()
    with torch.cuda.device(dev):
        code = lib.lattice_chain_launch(
            gp.data_ptr(), s, inv_off.data_ptr(), edge_cost.data_ptr(), k, e, idx.data_ptr(),
            int(idx.dtype == torch.int64), start.data_ptr(), int(start.dtype == torch.int64),
            int(max_len), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "lattice_chain_launch")
    count_launch(launch)
    return out


# Launches since the last reset (one a chunk).
launch.launches = 0
launch.warmup_launches = 0
