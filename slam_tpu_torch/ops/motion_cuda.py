"""Fused odometry motion sampling: the CUDA kernel `csrc/motion_odometry.cu`.

Port of the TPU Pallas kernel `slam_tpu/ops/motion_pallas.py:
sample_motion_model_odometry_pallas`. The wrapper decides by the tensor's
device: poses on a CUDA device go to the kernel (which draws its own
Philox noise from a seed); poses on the CPU go to the plain PyTorch
version `ops/motion.py:sample_motion_model_odometry` with noise from the
generator (or injected). A failed build or launch raises.

The kernel is held to the plain version by moments and seed
reproducibility, not bitwise: its noise stream is its own.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch.core.types import Odometry, Pose
from slam_tpu_torch.ops import _build
from slam_tpu_torch.ops.motion import sample_motion_model_odometry


def host_params(odom: Odometry, alphas):
    """(r1, t, r2, std_r1, std_t, std_r2) in float32, computed on the host
    exactly as `motion_pallas.py:82-97` does."""
    a = np.asarray([float(v) for v in alphas], np.float32)
    r1, t, r2 = (np.float32(float(v)) for v in (odom.rot1, odom.trans, odom.rot2))
    return (
        r1,
        t,
        r2,
        np.sqrt(a[0] * r1 * r1 + a[1] * t * t),
        np.sqrt(a[2] * t * t + a[3] * (r1 * r1 + r2 * r2)),
        np.sqrt(a[0] * r2 * r2 + a[1] * t * t),
    )


def odometry_rows(odom: Odometry, device) -> torch.Tensor:
    """f32 [R, 3] (rot1, trans, rot2) on `device` of an Odometry with
    scalar (R = 1) or [R] fields on the host or the device: the fused
    kernel's odometry, from which it computes the stddevs as `host_params`
    does. Host odometry is copied over without a host sync (a pageable
    source: the copy returns once its bytes are staged)."""
    rows = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                        for v in (odom.rot1, odom.trans, odom.rot2)], dim=-1)
    return rows.reshape(-1, 3).to(device, non_blocking=True).contiguous()


def draw_seed(generator, device) -> torch.Tensor:
    """The kernel's seed, int64[1], drawn from `generator` on the device:
    no host sync in the step. `mcl.step` draws the fused kernel's seed the
    same way, so one generator state gives the same poses on both paths."""
    return torch.randint(0, 2**62, (1,), generator=generator, device=device,
                         dtype=torch.int64)


def kernel_inputs(pose: Pose, seed, dev):
    """(x, y, theta) of `pose` after checking what the kernels take: f32[N]
    contiguous fields of one shape on `dev`, and a `seed` (unless None)
    int64[1] there."""
    fields = (pose.x, pose.y, pose.theta)
    for name, v in zip(("x", "y", "theta"), fields):
        if v.device != dev or v.dtype != torch.float32 or v.dim() != 1:
            raise ValueError(f"pose.{name} must be f32[N] on {dev}")
        if not v.is_contiguous():
            raise ValueError(f"pose.{name} must be contiguous")
    if not pose.x.shape == pose.y.shape == pose.theta.shape:
        raise ValueError("pose fields must share one shape")
    if seed is not None and (seed.device != dev or seed.dtype != torch.int64
                             or seed.numel() != 1):
        raise ValueError(f"seed must be int64[1] on {dev}")
    return fields


def launch(seed: torch.Tensor, odom: Odometry, pose: Pose, alphas) -> Pose:
    """Run the CUDA kernel: poses f32[N] on one CUDA device, `seed` an
    int64[1] on that device. Returns the sampled poses, theta wrapped."""
    dev = pose.x.device
    x, y, th = kernel_inputs(pose, seed, dev)
    params = [float(p) for p in host_params(odom, alphas)]
    ox, oy, oth = (torch.empty_like(x) for _ in range(3))
    if x.numel() == 0:
        return Pose(x=ox, y=oy, theta=oth)
    lib, _ = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.motion_odometry_launch(
            seed.data_ptr(), *params,
            x.data_ptr(), y.data_ptr(), th.data_ptr(),
            ox.data_ptr(), oy.data_ptr(), oth.data_ptr(),
            x.numel(), stream,
        )
    _build.check(code, "motion_odometry_launch")
    sample_motion_model_odometry_fused.launches += 1
    return Pose(x=ox, y=oy, theta=oth)


def sample_motion_model_odometry_fused(
    odom: Odometry, pose: Pose, alphas, *, generator=None, noise=None
) -> Pose:
    """Sample next poses under the odometry motion model.

    CUDA poses: the kernel, seeded from `generator` on the device; `noise`
    must be None there (the kernel draws its own). CPU poses: the plain
    version, with `noise` injected or drawn from `generator`."""
    if pose.x.is_cuda:
        if noise is not None:
            raise ValueError(
                "injected noise is a CPU-path argument; the CUDA kernel draws "
                "its own from the generator"
            )
        return launch(draw_seed(generator, pose.x.device), odom, pose, alphas)
    return sample_motion_model_odometry(
        odom, pose, alphas, noise=noise, generator=generator
    )


# Kernel launches since the last reset (the CPU path does not count).
sample_motion_model_odometry_fused.launches = 0
