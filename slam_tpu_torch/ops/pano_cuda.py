"""Row gather out[i] = rows[idx[i]]: the CUDA kernel `csrc/gather_rows.cu`.

Port of the TPU Pallas kernel `slam_tpu/ops/pano_pallas.py:gather_rows`.
On the MCL step it reads one bins-last LUT row per particle
(`ops/lut.py:panorama_rows`). A CUDA table goes to the kernel; a CPU
table to the plain version `rows[idx]`. A failed build or launch raises.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.core.graph import count_launch
from slam_tpu_torch.ops import _build


def vector_bytes(row_bytes: int, *ptrs: int) -> int:
    """Widest copy width (16, 8, 4 or 1 bytes) that divides the row pitch
    and every base address."""
    for v in (16, 8, 4):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    return 1


def launch(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel: rows [R, C] contiguous (any dtype), idx i32[N]
    on the same device, every value in [0, R). Returns [N, C]."""
    if rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous [R, C] tensor")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous i32[N] tensor")
    if idx.device != rows.device:
        raise ValueError(f"idx on {idx.device}, rows on {rows.device}")
    n = idx.shape[0]
    out = torch.empty((n, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    if n == 0:
        return out
    row_bytes = rows.shape[1] * rows.element_size()
    vec = vector_bytes(row_bytes, rows.data_ptr(), out.data_ptr())
    lib, _ = _build.library()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        code = lib.gather_rows_launch(
            rows.data_ptr(), idx.data_ptr(), out.data_ptr(), n, row_bytes, vec,
            stream,
        )
    _build.check(code, "gather_rows_launch")
    count_launch(gather_rows)
    return out


def gather_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = rows[idx[i]] for rows [R, C] and int32 idx [N]."""
    if rows.is_cuda:
        return launch(rows, idx)
    return rows[idx]


# Kernel launches since the last reset (the CPU path does not count).
gather_rows.launches = 0
gather_rows.warmup_launches = 0
