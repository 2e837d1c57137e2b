"""Systematic resampling on the card: the kernel chain `csrc/resample.cu`.

It replaces no Pallas kernel (the JAX package's `systematic_indices` is
plain XLA); PyTorch runs the plain chain's cummax in one block a row.
`ops/resample.py` routes a CUDA tensor here and keeps the plain version
(`systematic_ends`, `indices_from_ends`) for the CPU. The kernel takes
the caller's normalized weights (`torch.softmax`) as they are and forms
the f64 prefix sum itself, in another order than `torch.cumsum`: only a
draw within ~1e-11 of a bin edge can land one slot over. A failed build
or launch raises; there is no fallback to the plain chain.

A launch takes one filter ([N]) or R filters ([R, N], a fleet's robots)
and, with `gate` (bool, one a row, on the device), keeps the rows whose
gate is False as they are: the ESS gate without a conditional node.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.core.graph import count_launch
from slam_tpu_torch.core.types import Pose, log_f32
from slam_tpu_torch.ops import _build

# csrc/resample.cu: particles a tile (rows of up to one tile run in one
# launch), and the launcher's limits.
TILE = 4096
MAX_ROWS = 65535
MAX_PARTICLES = 2**30


def kernel_inputs(w, u0, gate=None, fields=()):
    """(R, N) of weights `w` after checking what the kernel takes: `w`
    f32 [N] or [R, N] contiguous, `u0` f32 with R elements, `gate` None or
    bool with R elements, each contiguous, and each of `fields` ((name,
    tensor) pairs) f32 of w's shape, contiguous, all on w's device, which
    must be a CUDA device. Raises ValueError otherwise, before any build."""
    if w.dtype != torch.float32 or w.dim() not in (1, 2) or not w.is_contiguous():
        raise ValueError(f"w must be contiguous f32 [N] or [R, N], got {w.dtype} "
                         f"{tuple(w.shape)}")
    r, n = (1, w.shape[0]) if w.dim() == 1 else w.shape
    if n < 1 or n > MAX_PARTICLES or r > MAX_ROWS:
        raise ValueError(f"the kernel takes 1 to {MAX_PARTICLES} particles a row and at most "
                         f"{MAX_ROWS} rows, got {tuple(w.shape)}")
    dev = w.device
    if (u0.dtype != torch.float32 or u0.numel() != r or u0.device != dev
            or not u0.is_contiguous()):
        raise ValueError(f"u0 must be {r} contiguous f32 draw(s) on {dev}")
    if gate is not None and (gate.dtype != torch.bool or gate.numel() != r
                             or gate.device != dev or not gate.is_contiguous()):
        raise ValueError(f"gate must be {r} contiguous bool(s) on {dev}")
    for name, v in fields:
        if (v.dtype != torch.float32 or v.shape != w.shape or v.device != dev
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 {tuple(w.shape)} on {dev}")
    if not w.is_cuda:
        raise ValueError("the kernel takes tensors on a CUDA device")
    return r, n


def launch(w: torch.Tensor, u0: torch.Tensor, *, gate=None, pose: Pose = None,
           log_weight: torch.Tensor = None):
    """Run the kernel chain on weights `w` (normalized, [N] or [R, N]) with
    row r's draw u0[r]. With `pose` and `log_weight` (the particles, w's
    shape) returns the resampled (Pose, log_weight), the log weights
    -log(N); without them the int32 indices, w's shape. A row whose `gate`
    is False keeps its particles (indices: slot k keeps particle k)."""
    if (pose is None) != (log_weight is None):
        raise ValueError("pass pose and log_weight together, or neither")
    fields = () if pose is None else (("pose.x", pose.x), ("pose.y", pose.y),
                                      ("pose.theta", pose.theta), ("log_weight", log_weight))
    r, n = kernel_inputs(w, u0, gate, fields)
    dev = w.device
    if pose is None:
        idx = torch.empty(w.shape, dtype=torch.int32, device=dev)
        ins, outs = (None,) * 4, (None,) * 4 + (idx.data_ptr(),)
    else:
        new = [torch.empty_like(v) for _, v in fields]
        ins = tuple(v.data_ptr() for _, v in fields)
        outs = tuple(v.data_ptr() for v in new) + (None,)
    sums = ends = None
    if n > TILE:
        sums = torch.empty((r, -(-n // TILE)), dtype=torch.float64, device=dev)
        ends = torch.empty((r, n), dtype=torch.int32, device=dev)
    lib, _ = _build.library()
    with torch.cuda.device(dev):
        code = lib.resample_launch(
            w.data_ptr(), u0.data_ptr(), None if gate is None else gate.data_ptr(),
            *ins, *outs, -log_f32(n),
            None if sums is None else sums.data_ptr(), None if ends is None else ends.data_ptr(),
            n, r, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "resample_launch")
    count_launch(launch)
    if pose is None:
        return idx
    return Pose(x=new[0], y=new[1], theta=new[2]), new[3]


# Launches since the last reset (one a chain, whichever form ran).
launch.launches = 0
launch.warmup_launches = 0
