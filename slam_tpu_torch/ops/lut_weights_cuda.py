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
`models/mcl.py:predict_weigh` (predict and weigh in one launch), which
`mcl.step` calls for one filter and `models/fleet.py:fleet_step` for R
filters with a robot axis. For a table on the CPU they run the plain version,
the existing composition: `ops/motion.py:sample_motion_model_odometry`,
then `sensor_pose`, `lut.panorama_rows` (`rows[idx]`) and
`pano_log_weights` (looped over robots for a fleet). A failed build or
launch raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_tpu_torch.core.stats import _SQRT_2PI
from slam_tpu_torch.core.types import Pose, Scan
from slam_tpu_torch.ops import _build
from slam_tpu_torch.ops.lut import lut_quant_step

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


def _robot_inputs(poses: Pose, scan: Scan, seed, odo, dev):
    """(x, y, theta, angles, dists, R, N) after checking what the kernel
    takes: pose fields f32 [N] (one filter) or [R, N] (a fleet), contiguous
    on `dev`; the scan's angles and dists [B] or [R, B] to match; a seed
    int64 [R] there (unless None) and the odometry f32 [R, 3] there
    (unless None)."""
    fields = (poses.x, poses.y, poses.theta)
    shape = poses.x.shape
    for name, v in zip(("x", "y", "theta"), fields):
        if (v.device != dev or v.dtype != torch.float32 or v.shape != shape
                or v.dim() not in (1, 2) or not v.is_contiguous()):
            raise ValueError(f"pose.{name} must be contiguous f32 [N] or [R, N] on {dev}")
    r, n = (1, shape[0]) if len(shape) == 1 else shape
    angles = scan.angles.to(dev, torch.float32).contiguous()
    dists = scan.dists.to(dev, torch.float32).contiguous()
    if angles.shape != dists.shape or angles.dim() != len(shape) or (
            angles.dim() == 2 and angles.shape[0] != r):
        raise ValueError(f"scan angles / dists must be [B] or [R, B] for poses {tuple(shape)}")
    if seed is not None and (seed.device != dev or seed.dtype != torch.int64
                             or seed.shape != (r,)):
        raise ValueError(f"seed must be int64[{r}] on {dev}")
    if odo is not None and (odo.device != dev or odo.dtype != torch.float32
                            or odo.shape != (r, 3) or not odo.is_contiguous()):
        raise ValueError(f"odometry must be f32 [{r}, 3] on {dev}")
    return (*fields, angles, dists, r, n)


def launch(
    lut: torch.Tensor, n_bins: int, poses: Pose, scan: Scan, *, beam_stride: int,
    displacement, max_dist: float, stddev: float, eps: float, motion=None,
):
    """Run the kernel: `lut` [H, W, P] bf16 or u8 on a CUDA device (P >=
    n_bins storage width), poses f32 [N] there (one filter) or [R, N] (R
    filters, one launch with a robot axis; the scan then [R, B]),
    `displacement` the scanner's (d, theta, rot)
    (`measurement.scanner_displacement`). With `motion` = (seed int64 [R]
    and odometry f32 [R, 3] (rot1, trans, rot2; `motion_cuda.
    odometry_rows`), both on the device, and the four alphas) the poses
    are first sampled with K1's sampler, robot r with seed[r] and odo[r].
    Returns (the sampled poses, or None without `motion`; lw f32 [N] or
    [R, N])."""
    if not lut.is_cuda:
        raise ValueError("the kernel takes a table on a CUDA device")
    if lut.dtype not in TABLE_DTYPES:
        raise ValueError(f"table dtype {lut.dtype}: the kernel reads bf16 or u8 tables")
    if lut.dim() != 3 or not lut.is_contiguous():
        raise ValueError("lut must be a contiguous [H, W, P] table")
    h, w, stride = lut.shape
    g = int(beam_stride)
    n_beams = scan.angles.shape[-1]
    if not (1 <= g and n_bins <= stride and n_bins % g == 0 and n_beams <= n_bins // g):
        raise ValueError(f"{n_beams} beams at stride {g} do not fit {n_bins} bins")
    if n_beams > MAX_BEAMS:
        raise ValueError(f"{n_beams} beams exceed the kernel's {MAX_BEAMS}")
    dev = lut.device
    seed, odo, alphas = (None, None, (0.0,) * 4) if motion is None else motion
    x, y, th, angles, dists, r, n = _robot_inputs(poses, scan, seed, odo, dev)
    lw = torch.empty_like(x)
    # Without motion the seed, the odometry and the pose outputs are null
    # pointers.
    out, seed_ptr, odo_ptr, o = None, 0, 0, [0] * 3
    if motion is not None:
        out = Pose(x=torch.empty_like(x), y=torch.empty_like(x), theta=torch.empty_like(x))
        seed_ptr, odo_ptr = seed.data_ptr(), odo.data_ptr()
        o = [out.x.data_ptr(), out.y.data_ptr(), out.theta.data_ptr()]
    if n == 0:
        return out, lw
    params = weigh_params(lut.dtype, n_bins=n_bins, displacement=displacement,
                          max_dist=max_dist, stddev=stddev, eps=eps)
    lib, _ = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lut_weights_launch(
            int(motion is not None), TABLE_DTYPES[lut.dtype], seed_ptr, odo_ptr,
            *(float(a) for a in alphas),
            x.data_ptr(), y.data_ptr(), th.data_ptr(), *o, lut.data_ptr(),
            stride, h, w, n_bins, g, angles.data_ptr(), dists.data_ptr(), n_beams,
            *(float(p) for p in params), lw.data_ptr(), n, r, stream,
        )
    _build.check(code, "lut_weights_launch")
    launch.launches += 1
    return out, lw


# Kernel launches since the last reset.
launch.launches = 0
