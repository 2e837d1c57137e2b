"""The particle filter's best and mode poses on the card: the kernel chain
`csrc/estimate.cu`.

It replaces no Pallas kernel (the JAX package's estimate is plain XLA);
PyTorch runs the plain estimate's softmax in one block a row, with about
fifteen more passes over the cloud around it. `models/mcl.py:estimate`
routes a CUDA tensor here and keeps the plain version (`plain_estimate`)
for the CPU. The best pose, the tie share and so the informative decision
equal the plain path's on the card bit for bit; the mode pose's sums run
in another order (~1e-7 relative). A failed build or launch raises; there
is no fallback to the plain version.

A launch takes one filter ([N]) or R filters ([R, N], a fleet's robots).
"""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch.core.graph import count_launch
from slam_tpu_torch.core.types import Pose
from slam_tpu_torch.ops import _build

# csrc/estimate.cu: particles a row that one block takes alone, particles a
# tile (one block's, above that), the blocks a row at most, and the
# launcher's limits.
ONE_BLOCK = 4096
TILE = 1024
MAX_BLOCKS = 512
MAX_ROWS = 65535
MAX_PARTICLES = 2**30
# 32-bit scratch words a block: its maxima (4), its sums and tie count (6).
BLOCK_WORDS = 10


def kernel_inputs(pose: Pose, log_weight, lw):
    """(R, N) of `log_weight` after checking what the kernel takes: it and
    `lw`, `pose.x`, `pose.y`, `pose.theta` f32 of one shape, [N] or [R, N],
    each contiguous, all on one CUDA device. Raises ValueError otherwise,
    before any build."""
    fields = (("log_weight", log_weight), ("lw", lw), ("pose.x", pose.x), ("pose.y", pose.y),
              ("pose.theta", pose.theta))
    if log_weight.dim() not in (1, 2):
        raise ValueError(f"log_weight must be [N] or [R, N], got {tuple(log_weight.shape)}")
    r, n = (1, log_weight.shape[0]) if log_weight.dim() == 1 else log_weight.shape
    if n < 1 or n > MAX_PARTICLES or r > MAX_ROWS:
        raise ValueError(f"the kernel takes 1 to {MAX_PARTICLES} particles a row and at most "
                         f"{MAX_ROWS} rows, got {tuple(log_weight.shape)}")
    dev = log_weight.device
    for name, v in fields:
        if (v.dtype != torch.float32 or v.shape != log_weight.shape or v.device != dev
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 {tuple(log_weight.shape)} on {dev}, "
                             f"got {v.dtype} {tuple(v.shape)} on {v.device}")
    if not log_weight.is_cuda:
        raise ValueError("the kernel takes tensors on a CUDA device")
    return r, n


def mean_factor(r: int, n: int) -> float:
    """The factor PyTorch's CUDA mean of an [R, N] tensor over its last axis
    multiplies each row's sum by: f32(R) / f32(R * N), in f32."""
    return float(np.float32(r) / np.float32(r * n))


def scratch_words(r: int, n: int) -> int:
    """The chain's 32-bit scratch words at R rows of N particles (none at
    ONE_BLOCK or fewer a row)."""
    if n <= ONE_BLOCK:
        return 0
    return r * (BLOCK_WORDS * min(-(-n // TILE), MAX_BLOCKS) + 1)


def launch(pose: Pose, log_weight: torch.Tensor, lw: torch.Tensor, mode_tau: float):
    """Run the kernel chain on particles `pose` with accumulated log weights
    `log_weight` after a measurement `lw` ([N] or [R, N]). Returns
    (best_pose, mode_pose, tie share, best index), each of the batch shape
    (0-d for [N]): the best pose is the first maximum's, or the mode pose
    where the share of particles tying the top score is 0.5 or more; the
    index is the first maximum's, int32."""
    r, n = kernel_inputs(pose, log_weight, lw)
    dev = log_weight.device
    lead = tuple(log_weight.shape[:-1])
    out = torch.empty((7,) + lead, dtype=torch.float32, device=dev)
    idx = torch.empty(lead, dtype=torch.int32, device=dev)
    words = scratch_words(r, n)
    scratch = torch.empty(words, dtype=torch.int32, device=dev) if words else None
    lib, _ = _build.library()
    with torch.cuda.device(dev):
        code = lib.estimate_launch(
            pose.x.data_ptr(), pose.y.data_ptr(), pose.theta.data_ptr(), log_weight.data_ptr(),
            lw.data_ptr(), mode_tau, mean_factor(r, n), out.data_ptr(), idx.data_ptr(),
            None if scratch is None else scratch.data_ptr(), words, n, r,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "estimate_launch")
    count_launch(launch)
    return (Pose(x=out[0], y=out[1], theta=out[2]), Pose(x=out[3], y=out[4], theta=out[5]),
            out[6], idx)


# Launches since the last reset (one a chain, whichever form ran).
launch.launches = 0
launch.warmup_launches = 0
