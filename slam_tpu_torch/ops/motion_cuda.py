"""Fused odometry motion sampling: the CUDA kernel `csrc/motion_odometry.cu`.

Port of the TPU Pallas kernel `slam_tpu/ops/motion_pallas.py:
sample_motion_model_odometry_pallas`. The wrapper decides by the tensor's
device: poses on a CUDA device go to the kernel (which draws its own
Philox noise from a seed and reads the odometry from device memory, as the
TPU kernel reads its parameters from a ref); poses on the CPU go to the
plain PyTorch version `ops/motion.py:sample_motion_model_odometry` with
noise from the generator (or injected). A failed build or launch raises.
`launch` also takes R robots at once: poses [R, N], seeds [R] and R
odometry rows, one launch for a fleet's predict (`models/fleet.py`).

The kernel is held to the plain version by moments and seed
reproducibility, not bitwise: its noise stream is its own.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch.core.graph import count_launch
from slam_tpu_torch.core.types import Odometry, Pose
from slam_tpu_torch.ops import _build
from slam_tpu_torch.ops.motion import sample_motion_model_odometry


def host_params(odom: Odometry, alphas):
    """(r1, t, r2, std_r1, std_t, std_r2) in float32, computed on the host
    exactly as `motion_pallas.py:82-97` does: the reference that the
    kernels' device-side `odom_params` (`csrc/motion_odometry.cuh`) equals
    bit for bit. No step path calls it."""
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
    scalar (R = 1) or [R] fields on the host or the device: both kernels'
    odometry, from which they compute the stddevs as `host_params` does.
    Host odometry is copied over without a host sync (a pageable source:
    the copy returns once its bytes are staged); a CUDA graph of a step
    passes device fields (`models/_graph.py`), which stay on the card."""
    rows = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                        for v in (odom.rot1, odom.trans, odom.rot2)], dim=-1)
    return rows.reshape(-1, 3).to(device, non_blocking=True).contiguous()


def draw_seed(generator, device) -> torch.Tensor:
    """The kernel's seed, int64[1], drawn from `generator` on the device:
    no host sync in the step. `mcl.step` draws the fused kernel's seed the
    same way, so one generator state gives the same poses on both paths."""
    return torch.randint(0, 2**62, (1,), generator=generator, device=device,
                         dtype=torch.int64)


def draw_seeds(generators, device) -> torch.Tensor:
    """int64 [R]: robot q's `draw_seed` from `generators[q]`, drawn in place
    into one tensor (each generator advances exactly as `draw_seed`
    advances it): a fleet's seeds for one launch with a robot axis."""
    seeds = torch.empty((len(generators),), dtype=torch.int64, device=device)
    for q, g in enumerate(generators):
        torch.randint(0, 2**62, (1,), generator=g, out=seeds[q:q + 1])
    return seeds


def kernel_inputs(pose: Pose, seed, odo):
    """(x, y, theta, R, N) of `pose` after checking what the kernel takes:
    f32 fields of one shape, [N] (one filter, R = 1) or [R, N] (R robots),
    contiguous, on one device; `seed` int64 [R] there and `odo` (the
    odometry's `odometry_rows`) f32 [R, 3] there, contiguous. Raises
    ValueError otherwise, whatever the device."""
    fields = (pose.x, pose.y, pose.theta)
    dev, shape = pose.x.device, pose.x.shape
    for name, v in zip(("x", "y", "theta"), fields):
        if (v.device != dev or v.dtype != torch.float32 or v.shape != shape
                or v.dim() not in (1, 2)):
            raise ValueError(f"pose.{name} must be f32 [N] or [R, N] on {dev}, like pose.x")
        if not v.is_contiguous():
            raise ValueError(f"pose.{name} must be contiguous")
    r, n = (1, shape[0]) if len(shape) == 1 else shape
    if seed.device != dev or seed.dtype != torch.int64 or seed.shape != (r,):
        raise ValueError(f"seed must be int64 [{r}] on {dev} for poses {tuple(shape)}")
    if (odo.device != dev or odo.dtype != torch.float32 or odo.shape != (r, 3)
            or not odo.is_contiguous()):
        raise ValueError(f"odometry must be {r} row(s) for poses {tuple(shape)}, "
                         f"got {tuple(odo.shape)}")
    return (*fields, r, n)


def launch(seed: torch.Tensor, odom: Odometry, pose: Pose, alphas, i0: int = 0) -> Pose:
    """Run the CUDA kernel: poses f32 [N] (one filter) or [R, N] (R robots,
    one launch with a robot axis) on one CUDA device, `seed` int64 [R]
    there, `odom` one odometry (scalar fields) or R (fields [R]) on the
    host or the device (`odometry_rows` puts its rows on the device, where
    the kernel reads them). Robot r samples with seed[r] and its odometry
    row; particle i draws Philox counter `i0` + i (`i0`: the global index
    of a particle shard's first particle), so robot r's poses equal a
    one-robot launch with its seed. Returns the sampled poses, theta
    wrapped, in the poses' shape."""
    odo = odometry_rows(odom, pose.x.device)
    x, y, th, r, n = kernel_inputs(pose, seed, odo)
    if not x.is_cuda:
        raise ValueError("the kernel takes poses on a CUDA device")
    ox, oy, oth = (torch.empty_like(x) for _ in range(3))
    if n == 0:
        return Pose(x=ox, y=oy, theta=oth)
    lib, _ = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.motion_odometry_launch(
            seed.data_ptr(), odo.data_ptr(), *(float(a) for a in alphas),
            x.data_ptr(), y.data_ptr(), th.data_ptr(),
            ox.data_ptr(), oy.data_ptr(), oth.data_ptr(),
            n, int(i0), r, stream,
        )
    _build.check(code, "motion_odometry_launch")
    count_launch(sample_motion_model_odometry_fused)
    return Pose(x=ox, y=oy, theta=oth)


MATH_CHECKS = ("log", "sqrt", "sincos", "cos")


def math_mismatches(device) -> dict:
    """Of the 2^24 uniforms the sampler can draw, those on which a
    branch-free form of `csrc/motion_odometry.cuh` (log_normal,
    sqrt_nonneg, sincos_small, cos_small) differs from libdevice's logf,
    sqrtf, sincosf or cosf in any bit, counted on the CUDA `device`: {name:
    count}, all 0 when the kernels' noise equals libdevice's."""
    bad = torch.zeros((len(MATH_CHECKS),), dtype=torch.int64, device=device)
    lib, _ = _build.library()
    with torch.cuda.device(bad.device):
        code = lib.motion_odometry_math_check(
            bad.data_ptr(), torch.cuda.current_stream(bad.device).cuda_stream)
    _build.check(code, "motion_odometry_math_check")
    return dict(zip(MATH_CHECKS, bad.tolist()))


def sample_motion_model_odometry_fused(
    odom: Odometry, pose: Pose, alphas, *, generator=None, noise=None,
    shard=None,
) -> Pose:
    """Sample next poses under the odometry motion model.

    CUDA poses: the kernel, seeded from `generator` on the device; `noise`
    must be None there (the kernel draws its own). CPU poses: the plain
    version, with `noise` injected or drawn from `generator`.

    `shard` = (i0, n_global): the poses are particles [i0, i0 + N) of a
    filter of n_global particles whose generator every shard holds in the
    same state. The kernel then counts Philox from i0 and the CPU draws the
    filter's n_global normals and keeps its slice, so either way a shard
    draws what the unsharded filter draws for its particles."""
    i0, n_global = (0, None) if shard is None else shard
    if pose.x.is_cuda:
        if noise is not None:
            raise ValueError(
                "injected noise is a CPU-path argument; the CUDA kernel draws "
                "its own from the generator"
            )
        return launch(draw_seed(generator, pose.x.device), odom, pose, alphas, i0)
    if noise is None and n_global is not None:
        n = pose.x.shape[0]
        noise = tuple(torch.randn((n_global,), generator=generator)[i0:i0 + n]
                      for _ in range(3))
    return sample_motion_model_odometry(
        odom, pose, alphas, noise=noise, generator=generator
    )


# Kernel launches since the last reset (the CPU path does not count).
sample_motion_model_odometry_fused.launches = 0
sample_motion_model_odometry_fused.warmup_launches = 0
