"""Occupancy mapping: additive log-odds updates along scan beams (port of
`slam_tpu/ops/mapping.py`, the shared-map update).

Per scan, every beam marches in fixed steps from the sensor:

  * cells strictly before the measured range: += l_free (negative);
  * the first new cell at/after the measured range: += l_occ, skipped for
    max-range misses;
  * each visited cell updates once per beam (cell dedup along the beam);
  * the march stops at the first out-of-bounds step.

The fidelity mode (per-particle uint8 maps with the reference's
multiplicative quantized updates, `fidelity_measurement_and_mapping`)
serves the RBPF of `models/rbpf.py` (on a CUDA device through the two
kernels of `csrc/rbpf_fidelity.cu`), and names its layers for it: each
chunk's march is the span `rbpf.march`, its write into the new maps
`rbpf.map_write`; the counters `rbpf.chunks` and `rbpf.lanes` (particle x
beam x ray step) count a call's chunks and lanes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_tpu_torch.core import graph
from slam_tpu_torch.core import grid as gridlib
from slam_tpu_torch.core.types import Pose, Scan
from slam_tpu_torch.ops import rbpf_fidelity_cuda
from slam_tpu_torch.ops.measurement import beam_log_weights, scanner_displacement, sensor_pose
from slam_tpu_torch.planners._scatter import last_lanes
from slam_tpu_torch.utils import profiling


def _beam_cells(shape, sp: Pose, angles, *, step, max_dist):
    """Cells visited by every beam of one sensor pose `sp` (0-d fields)
    along headings `angles` [B]. Returns (i, j, d, processed, cell), each
    [B, K] but d [K]: processed = a new cell AND every step so far in
    bounds (march semantics)."""
    h, w = shape
    dev = angles.device
    k_total = int(math.ceil(max_dist / step))
    ks = torch.arange(1, k_total + 1, dtype=torch.float32, device=dev)  # [K]
    d = ks * step

    px = sp.x + ks[None, :] * (torch.cos(angles) * step)[:, None]
    py = sp.y + ks[None, :] * (torch.sin(angles) * step)[:, None]
    i, j = gridlib.world_to_cell((h, w), px, py)
    cell = i * w + j

    i0, j0 = gridlib.world_to_cell((h, w), sp.x, sp.y)
    cell0 = (i0 * w + j0).reshape(1, 1).expand(cell.shape[0], 1)
    prev = torch.cat([cell0, cell[:, :-1]], dim=1)
    new_cell = cell != prev

    inb = gridlib.in_bounds((h, w), i, j)
    all_inb = torch.cumprod(inb.to(torch.int32), dim=1).bool()
    processed = new_cell & all_inb
    return i, j, d, processed, cell


def scan_logodds_update(
    grid_l: torch.Tensor,
    pose: Pose,
    scan: Scan,
    *,
    scanner_offset=(0.0, 0.0, 0.0),
    step: float = 0.5,
    max_dist: float = 500.0,
    l_occ: float = 0.85,
    l_free: float = -0.4,
    l_min: float = -6.0,
    l_max: float = 6.0,
    row_offset=None,
    full_h: int | None = None,
) -> torch.Tensor:
    """The shared log-odds grid after one scan taken at `pose` (a new
    tensor; `grid_l` is not modified).

    `grid_l` may be a row block of a larger map (`row_offset`, `full_h`):
    beam geometry runs in global coordinates and updates outside the block
    are dropped, so block updates compose exactly to the full-map update.

    Accumulation is deterministic: one int32 scatter-add counts each
    cell's free and occupied hits (integer adds give the same counts in any
    order, on the card as on the CPU), then one multiply-add applies them,
    grid + (n_free * l_free + n_occ * l_occ), clamped. The JAX package adds
    the beams' deltas to the grid one by one in f32, so a cell hit more than
    once per scan can differ in its last bits (the tests state how often
    that flips `blocked_from_logodds`)."""
    lh, w = grid_l.shape
    h = lh if full_h is None else full_h
    ro = 0 if row_offset is None else row_offset
    dev = grid_l.device
    sp = sensor_pose(pose, scanner_offset)
    angles = sp.theta + scan.angles  # [B]
    i, j, d, processed, _ = _beam_cells((h, w), sp, angles, step=step, max_dist=max_dist)

    z = scan.dists[:, None]  # [B, 1]
    free = processed & (d[None, :] < z)
    # First processed cell at/after the measured endpoint; skipped for
    # max-range misses (encoded as exactly max_dist). argmax takes no bool,
    # and returns the FIRST maximum, as jnp.argmax.
    at_or_past = processed & (d[None, :] >= z)
    first_idx = torch.argmax(at_or_past.to(torch.uint8), dim=1)  # [B]
    has_occ = torch.any(at_or_past, dim=1) & (scan.dists < max_dist)
    k_iota = torch.arange(d.shape[0], device=dev)[None, :]
    occ = (k_iota == first_idx[:, None]) & has_occ[:, None] & at_or_past

    il = i - ro  # block-local row; out-of-block updates go to a dropped slot
    inblk = (il >= 0) & (il < lh) & (j >= 0) & (j < w)
    flat = torch.where(
        inblk, il.clamp(0, lh - 1) * w + j.clamp(0, w - 1), lh * w
    ).reshape(-1).long()
    hits = torch.stack([free, occ], dim=-1).reshape(-1, 2).to(torch.int32)
    counts = torch.zeros((lh * w + 1, 2), dtype=torch.int32, device=dev)
    counts.index_add_(0, flat, hits)
    counts = counts[:-1].to(torch.float32)
    delta = counts[:, 0] * l_free + counts[:, 1] * l_occ
    return torch.clamp(grid_l + delta.reshape(lh, w), l_min, l_max)


# --------------------------------------------------------------------------
# Fidelity mode: per-particle uint8 maps with the reference's multiplicative
# quantized updates.
# --------------------------------------------------------------------------

_L0 = 0.5
_LOCC = 0.40
_LFREE = 0.60
# Lanes (particle x beam x ray step) of one chunk of the fidelity update:
# the [C, B, K] intermediates of a chunk of C particles take ~60 bytes a
# lane, so 2^25 lanes keep a chunk near 2 GB.
_FIDELITY_CHUNK_LANES = 1 << 25


def _u8_scale(factor) -> float:
    """The f32 constant `_u8_update` multiplies a code by: f32(f32(1 / 255)
    * f32(factor))."""
    return float(np.float32(np.float32(1.0) / np.float32(255.0)) * np.float32(factor))


def _u8_update(values_u8, factor):
    """One multiplicative quantized update: p = clamp(p * factor) with
    ceiling 1.0 and floor 1/255 (`slam/raycast.cpp:193-213`).

    The JAX package writes v / 255.0 * factor; under `jit` XLA turns the
    divide by a constant into a multiply by its f32 reciprocal and folds
    the two constants into one, v * f32(f32(1 / 255) * f32(factor)). The
    port multiplies by that constant, so the codes equal the compiled
    reference's."""
    p = torch.clamp(values_u8.to(torch.float32) * _u8_scale(factor), max=1.0)
    return torch.clamp(torch.floor(p * 255.0), min=1.0).to(torch.uint8)


def _cos_sin(a):
    """f32 cos and sin of f32 `a`, taken in f64 and rounded: the same bits
    on every device (f32 cos / sin differ by an ulp between CUDA and the
    CPU, and a ray step on a cell boundary then lands in another cell)."""
    a = a.to(torch.float64)
    return torch.cos(a).to(torch.float32), torch.sin(a).to(torch.float32)


def _fidelity_sensors(poses: Pose, scanner_offset) -> Pose:
    """The sensor poses of `fidelity_measurement_and_mapping`'s particles."""
    dist, th, rot = scanner_displacement(scanner_offset)
    c, s = _cos_sin(poses.theta + th)
    return Pose(x=poses.x + c * dist, y=poses.y + s * dist, theta=poses.theta + rot)


def _fidelity_spans(n: int, beams: int, k_total: int) -> list[tuple[int, int]]:
    """The particles (n0, n1) of each chunk of the fidelity update: about
    `_FIDELITY_CHUNK_LANES` lanes (particle x beam x ray step) a chunk."""
    chunk = max(1, _FIDELITY_CHUNK_LANES // max(beams * k_total, 1))
    return [(n0, min(n, n0 + chunk)) for n0 in range(0, n, chunk)]


def _fidelity_rays(maps_u8, sp: Pose, scan: Scan, n0: int, n1: int):
    """The inputs of particles n0..n1 the kernels take (maps, sensor x, y,
    each beam's cos, sin) for sensor poses `sp` of all particles."""
    return (maps_u8[n0:n1], sp.x[n0:n1], sp.y[n0:n1],
            *_cos_sin(sp.theta[n0:n1, None] + scan.angles[None, :]))


def _kernels(dev: torch.device) -> bool:
    """Whether the fidelity update's chunks go to the kernels of
    `ops/rbpf_fidelity_cuda.py`: on a CUDA device."""
    return dev.type == "cuda"


def _fidelity_chunk(maps_flat, n0: int, n1: int, hw, sp: Pose, scan: Scan, *,
                    step: float, max_dist: float):
    """Particles n0..n1 of `fidelity_measurement_and_mapping`: (hit_dist,
    hit_any [C, B], flat map index, updated u8 value and write mask [C, B,
    K]) for sensor poses `sp` of all particles."""
    h, w = hw
    dev = maps_flat.device
    x, y, th = sp.x[n0:n1], sp.y[n0:n1], sp.theta[n0:n1]
    angles = th[:, None] + scan.angles[None, :]  # [C, B]
    k_total = int(math.ceil(max_dist / step))
    ks = torch.arange(1, k_total + 1, dtype=torch.float32, device=dev)
    d = ks * step  # [K]
    c, s = _cos_sin(angles)
    px = x[:, None, None] + ks[None, None, :] * (c * step)[..., None]
    py = y[:, None, None] + ks[None, None, :] * (s * step)[..., None]
    i, j = gridlib.world_to_cell((h, w), px, py)  # [C, B, K]
    cell = i * w + j
    i0, j0 = gridlib.world_to_cell((h, w), x, y)
    cell0 = (i0 * w + j0)[:, None, None]
    prev = torch.cat([cell0.expand(cell[..., :1].shape), cell[..., :-1]], dim=-1)
    inb = gridlib.in_bounds((h, w), i, j)
    processed = (cell != prev) & (torch.cummin(inb.to(torch.uint8), dim=-1).values > 0)
    ic, jc = gridlib.clamp_cell((h, w), i, j)
    base = torch.arange(n0, n1, device=dev, dtype=torch.int64) * (h * w)
    flat = (ic.long() * w + jc) + base[:, None, None]
    vals = maps_flat[flat]

    # Predicted hit: the first processed cell with value < 128 (pre-scan map).
    occupied = processed & (vals < 128) & (cell != cell0)
    hit_any = torch.any(occupied, dim=-1)
    hit_idx = torch.argmax(occupied.to(torch.uint8), dim=-1)  # the FIRST maximum
    hit_dist = (hit_idx.to(torch.float32) + 1.0) * step

    z = scan.dists[None, :, None]
    free = processed & (d * d < z * z)
    at_or_past = processed & (d >= z)
    first_idx = torch.argmax(at_or_past.to(torch.uint8), dim=-1)
    has_occ = torch.any(at_or_past, dim=-1) & (scan.dists[None, :] < max_dist)
    occ = ((torch.arange(k_total, device=dev) == first_idx[..., None])
           & has_occ[..., None] & at_or_past)
    updated = torch.where(occ, _u8_update(vals, _LOCC / _L0),
                          torch.where(free, _u8_update(vals, _LFREE / _L0), vals))
    return hit_dist, hit_any, flat, updated, free | occ


def _plain_write(new_maps, n0: int, n1: int, flat, updated, write) -> None:
    """Write `_fidelity_chunk`'s lanes of particles n0..n1 (`flat`,
    `updated`, `write`) into `new_maps`, the last writing lane of a cell
    winning. Targets of the chunk lie in its particles' maps: they are
    indexed from the chunk's first cell so `last_lanes`' table is the
    chunk's size. Every lane writes its target the value of the target's
    last writing lane, or its own (the pre-scan value) where no lane writes
    the target: duplicate writes carry one value, and no slot is shared."""
    hw = new_maps.shape[1] * new_maps.shape[2]
    flat = flat.reshape(-1)
    updated = updated.reshape(-1)
    tgt = flat - n0 * hw
    top = last_lanes(write.reshape(-1), tgt, (n1 - n0) * hw)[tgt]
    lane = torch.arange(updated.numel(), device=updated.device)
    new_maps.view(-1).scatter_(0, flat, updated[torch.where(top >= 0, top, lane)])


def fidelity_measurement_and_mapping(
    maps_u8: torch.Tensor,
    poses: Pose,
    scan: Scan,
    *,
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    eps: float = 0.1,
    max_dist: float = 500.0,
    step: float = 0.5,
):
    """Reference-style fused weighting + mapping on per-particle maps.

    For each particle n and beam b, marches through `maps_u8[n]`: the first
    already-occupied (< 128) new cell is the predicted hit
    (`slam/raycast.cpp:183-189`), cells before the measured endpoint get
    the free update and the endpoint cell the occupied update. As in the
    JAX package, hits are computed against the pre-scan map and all
    updates applied afterwards, so beams are order-independent.

    Where several lanes of one particle write one cell (beams crossing near
    the sensor), the last lane in (beam, step) order wins, as XLA's
    in-order scatter keeps it. On the CPU the chunk's [C, B, K] lanes are
    tensors (`_fidelity_chunk`) and `planners/_scatter.py:last_lanes` picks
    that lane, every lane writing its value. On a CUDA device two kernels
    a chunk (`ops/rbpf_fidelity_cuda.py`) march each beam to its hit and
    write each cell once by the same rule, bit for bit as the CPU route.
    Particles go in chunks of about `_FIDELITY_CHUNK_LANES` lanes
    (`_fidelity_spans`). The ray geometry's cos / sin are taken in f64 and
    rounded (`_cos_sin`), so the maps are the same on the card and the CPU.

    Returns (log_weights f32[N], new_maps u8[N, H, W])."""
    n, h, w = maps_u8.shape
    sp = _fidelity_sensors(poses, scanner_offset)
    k_total = int(math.ceil(max_dist / step))
    lanes = scan.angles.shape[0] * k_total
    new_maps = maps_u8.clone(memory_format=torch.contiguous_format)
    hit_dist, hit_any = [], []
    dev = maps_u8.device
    for n0, n1 in _fidelity_spans(n, scan.angles.shape[0], k_total):
        graph.count_host(profiling.count, "rbpf.chunks", 1)
        graph.count_host(profiling.count, "rbpf.lanes", (n1 - n0) * lanes)
        with profiling.span("rbpf.march", dev):
            if _kernels(dev):
                ray = _fidelity_rays(maps_u8, sp, scan, n0, n1)
                hd, ha = rbpf_fidelity_cuda.march(*ray, step=step, k_total=k_total)
            else:
                hd, ha, flat, updated, write = _fidelity_chunk(
                    maps_u8.reshape(-1), n0, n1, (h, w), sp, scan, step=step,
                    max_dist=max_dist)
        hit_dist.append(hd)
        hit_any.append(ha)
        with profiling.span("rbpf.map_write", dev):
            if _kernels(dev):
                rbpf_fidelity_cuda.write(
                    *ray, scan.dists.contiguous(), new_maps[n0:n1], step=step,
                    k_total=k_total, max_dist=max_dist, occ_scale=_u8_scale(_LOCC / _L0),
                    free_scale=_u8_scale(_LFREE / _L0))
            else:
                _plain_write(new_maps, n0, n1, flat, updated, write)
    lw = beam_log_weights(
        torch.cat(hit_dist), torch.cat(hit_any), scan.dists[None, :],
        stddev=stddev, max_dist=max_dist, eps=eps,
    )
    return torch.sum(lw, dim=-1), new_maps
