"""The RBPF's per-particle-map march and map write on the card: the two
kernels of `csrc/rbpf_fidelity.cu`, one launch of each a chunk of
particles.

They replace no Pallas kernel (the JAX package's fidelity update is plain
XLA); PyTorch runs it as [C, B, K] tensors of every ray step and settles
the cells two beams of one particle write through `last_lanes`' int64
table. `ops/mapping.py:fidelity_measurement_and_mapping` routes maps on a
CUDA device here and keeps that plain path (`_fidelity_chunk`,
`last_lanes`) for the CPU. The hits, their distances and the new maps
equal the plain path's bit for bit. A failed build or launch raises;
there is no fallback to the plain path.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.core.graph import count_launch
from slam_tpu_torch.ops import _build

# csrc/rbpf_fidelity.cu: the beams a scan may have (the write kernel's
# shared hash table) and the ray steps a beam may take ((k + 1) exact in f32).
MAX_BEAMS = 2048
MAX_STEPS = 1 << 24


def _check(name, v, dtype, shape, dev):
    if (v.dtype != dtype or tuple(v.shape) != tuple(shape) or v.device != dev
            or not v.is_contiguous()):
        raise ValueError(f"{name} must be contiguous {dtype} {tuple(shape)} on {dev}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}"
                         f"{'' if v.is_contiguous() else ' (not contiguous)'}")


def kernel_inputs(maps, x, y, c, s, k_total: int, *, out=None, dists=None, steps=None):
    """(C, B, H, W) after checking what the kernels take: `maps` and `out`
    u8 [C, H, W] (C >= 1, H * W < 2^31), `x`, `y` f32 [C] (the sensors),
    `c`, `s` f32 [C, B] (1 <= B <= MAX_BEAMS: each beam's cos and sin),
    `dists` f32 [B], `steps` i32 [C, B], all contiguous on one CUDA device
    (`out`, `dists`, `steps` where given); 1 <= `k_total` <= MAX_STEPS.
    Raises ValueError otherwise, before any build."""
    if maps.dim() != 3 or min(maps.shape) < 1:
        raise ValueError(f"maps must be non-empty [C, H, W], got {tuple(maps.shape)}")
    cn, h, w = maps.shape
    if h * w >= 2**31:
        raise ValueError(f"a map takes fewer than 2^31 cells, got {h} x {w}")
    if c.dim() != 2 or not 1 <= c.shape[1] <= MAX_BEAMS:
        raise ValueError(f"c must be [C, B] with 1 to {MAX_BEAMS} beams, got {tuple(c.shape)}")
    b = c.shape[1]
    dev = maps.device
    _check("maps", maps, torch.uint8, (cn, h, w), dev)
    for name, v in (("x", x), ("y", y)):
        _check(name, v, torch.float32, (cn,), dev)
    for name, v in (("c", c), ("s", s)):
        _check(name, v, torch.float32, (cn, b), dev)
    for name, v, dtype, shape in (("out", out, torch.uint8, (cn, h, w)),
                                  ("dists", dists, torch.float32, (b,)),
                                  ("steps", steps, torch.int32, (cn, b))):
        if v is not None:
            _check(name, v, dtype, shape, dev)
    if not 1 <= int(k_total) <= MAX_STEPS:
        raise ValueError(f"k_total must be 1 to {MAX_STEPS}, got {k_total}")
    if not maps.is_cuda:
        raise ValueError("the kernels take tensors on a CUDA device")
    return cn, b, h, w


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def march(maps, x, y, c, s, *, step: float, k_total: int, steps=None):
    """The predicted hits of every beam of the chunk's particles: each
    beam's first step (of `k_total`, `step` apart) from sensor (`x`, `y`)
    along (`c`, `s`) that enters a new cell, other than the sensor's, which
    reads < 128 in `maps`. Returns (hit_dist f32 [C, B]: (k + 1) * step,
    step where nothing is hit; hit_any bool [C, B]). `steps` (i32 [C, B],
    optional) receives the steps each beam marched."""
    cn, b, h, w = kernel_inputs(maps, x, y, c, s, k_total, steps=steps)
    dev = maps.device
    hit_dist = torch.empty((cn, b), dtype=torch.float32, device=dev)
    hit_any = torch.empty((cn, b), dtype=torch.bool, device=dev)
    lib, _ = _build.library()
    with torch.cuda.device(dev):
        code = lib.rbpf_march_launch(
            maps.data_ptr(), x.data_ptr(), y.data_ptr(), c.data_ptr(), s.data_ptr(), cn, b,
            int(k_total), h, w, float(step), hit_dist.data_ptr(), hit_any.data_ptr(),
            None if steps is None else steps.data_ptr(), _stream(dev))
    _build.check(code, "rbpf_march_launch")
    count_launch(march)
    return hit_dist, hit_any


def write(maps, x, y, c, s, dists, out, *, step: float, k_total: int, max_dist: float,
          occ_scale: float, free_scale: float) -> None:
    """Write the scan's updates of the chunk's particles (the march's
    inputs) into `out` (u8 [C, H, W], the copy of `maps` the step
    returns): the occupied update
    (the code times `occ_scale`, quantized) at each beam's first new cell
    at or past its range `dists` (f32 [B]; none at `max_dist` or beyond),
    the free update (`free_scale`) at its new cells before the range, each
    from the code in `maps`; where beams of one particle write one cell,
    the last beam's update."""
    cn, b, h, w = kernel_inputs(maps, x, y, c, s, k_total, out=out, dists=dists)
    dev = maps.device
    lib, _ = _build.library()
    with torch.cuda.device(dev):
        code = lib.rbpf_write_launch(
            maps.data_ptr(), out.data_ptr(), x.data_ptr(), y.data_ptr(), c.data_ptr(),
            s.data_ptr(), dists.data_ptr(), cn, b, int(k_total), h, w, float(step),
            float(max_dist), float(occ_scale), float(free_scale), _stream(dev))
    _build.check(code, "rbpf_write_launch")
    count_launch(write)


# Launches since the last reset (one of each a chunk).
march.launches = write.launches = 0
march.warmup_launches = write.warmup_launches = 0
