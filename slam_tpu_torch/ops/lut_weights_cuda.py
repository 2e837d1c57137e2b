"""Motion sampling fused with the LUT beam weights: the CUDA kernel
`csrc/lut_weights.cu`.

The Hopper redesign of K1 (`slam_tpu/ops/motion_pallas.py`) on the MCL
step: K1's sampler runs in the prologue of the kernel that weighs the
sampled poses on the LUT panorama route (`slam_tpu/ops/measurement.py:
particle_log_weights_lut_fused`), so neither the poses nor the panorama
rows go through device memory between the two. Without `motion` the
kernel only weighs the poses it is given.

Callers, which pick the kernel for a table on a CUDA device:
`ops/measurement.py:particle_log_weights_lut_fused` (weigh only) and
`models/mcl.py:step` (predict and weigh in one launch). For a table on
the CPU they run the plain version, the existing composition:
`ops/motion.py:sample_motion_model_odometry`, then `sensor_pose`,
`lut.panorama_rows` (`rows[idx]`) and `pano_log_weights`. A failed build
or launch raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_tpu_torch.core.stats import _SQRT_2PI
from slam_tpu_torch.core.types import Pose, Scan
from slam_tpu_torch.ops import _build
from slam_tpu_torch.ops.lut import lut_quant_step
from slam_tpu_torch.ops.motion_cuda import host_params, kernel_inputs

# Table dtype -> the launcher's `table_u8` flag.
TABLE_DTYPES = {torch.bfloat16: 0, torch.uint8: 1}
# The scan's ranges sit in the block's shared memory (48 KB by default).
MAX_BEAMS = 48 * 1024 // 4


def weigh_params(lut_dtype, *, n_bins: int, displacement, max_dist: float,
                 stddev: float, eps: float):
    """The kernel's float32 measurement scalars, rounded as PyTorch rounds
    the Python scalars of the plain version (a CUDA tensor divided by a
    scalar is multiplied by the scalar's f32 reciprocal): (sensor_d,
    sensor_th, sensor_rot, binw, max_dist, inv_stddev, clamp, inv_norm,
    eps, quant)."""
    f = np.float32
    q = lut_quant_step(lut_dtype, max_dist)
    return (
        *(f(v) for v in displacement),
        f(2.0 * math.pi / n_bins),
        f(max_dist),
        f(1.0) / f(stddev),
        f(4.0 * stddev),
        f(1.0) / f(stddev * _SQRT_2PI),
        f(eps),
        f(0.0 if q is None else q),
    )


def launch(
    lut: torch.Tensor, n_bins: int, poses: Pose, scan: Scan, *, beam_stride: int,
    displacement, max_dist: float, stddev: float, eps: float, motion=None,
):
    """Run the kernel: `lut` [H, W, P] bf16 or u8 on a CUDA device (P >=
    n_bins storage width), poses f32[N] there, `displacement` the
    scanner's (d, theta, rot) (`measurement.scanner_displacement`). With
    `motion` = (seed int64[1] on the device, odom, alphas) the poses are
    first sampled with K1's sampler. Returns (the sampled poses, or None
    without `motion`; lw f32[N])."""
    if not lut.is_cuda:
        raise ValueError("the kernel takes a table on a CUDA device")
    if lut.dtype not in TABLE_DTYPES:
        raise ValueError(f"table dtype {lut.dtype}: the kernel reads bf16 or u8 tables")
    if lut.dim() != 3 or not lut.is_contiguous():
        raise ValueError("lut must be a contiguous [H, W, P] table")
    h, w, stride = lut.shape
    g = int(beam_stride)
    n_beams = scan.angles.shape[0]
    if not (1 <= g and n_bins <= stride and n_bins % g == 0 and n_beams <= n_bins // g):
        raise ValueError(f"{n_beams} beams at stride {g} do not fit {n_bins} bins")
    if n_beams > MAX_BEAMS:
        raise ValueError(f"{n_beams} beams exceed the kernel's {MAX_BEAMS}")
    dev = lut.device
    seed, odom, alphas = (None, None, None) if motion is None else motion
    x, y, th = kernel_inputs(poses, seed, dev)
    angles = scan.angles.to(dev, torch.float32).contiguous()
    dists = scan.dists.to(dev, torch.float32).contiguous()
    n = x.numel()
    lw = torch.empty_like(x)
    # Without motion the seed and the pose outputs are null pointers.
    out, seed_ptr, odo, o = None, 0, [0.0] * 6, [0] * 3
    if motion is not None:
        out = Pose(x=torch.empty_like(x), y=torch.empty_like(x), theta=torch.empty_like(x))
        seed_ptr, odo = seed.data_ptr(), [float(p) for p in host_params(odom, alphas)]
        o = [out.x.data_ptr(), out.y.data_ptr(), out.theta.data_ptr()]
    if n == 0:
        return out, lw
    params = weigh_params(lut.dtype, n_bins=n_bins, displacement=displacement,
                          max_dist=max_dist, stddev=stddev, eps=eps)
    lib, _ = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lut_weights_launch(
            int(motion is not None), TABLE_DTYPES[lut.dtype], seed_ptr, *odo,
            x.data_ptr(), y.data_ptr(), th.data_ptr(), *o, lut.data_ptr(),
            stride, h, w, n_bins, g, angles.data_ptr(), dists.data_ptr(), n_beams,
            *(float(p) for p in params), lw.data_ptr(), n, stream,
        )
    _build.check(code, "lut_weights_launch")
    launch.launches += 1
    return out, lw


# Kernel launches since the last reset.
launch.launches = 0
