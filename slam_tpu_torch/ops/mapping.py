"""Occupancy mapping: additive log-odds updates along scan beams (port of
`slam_tpu/ops/mapping.py`, the shared-map update).

Per scan, every beam marches in fixed steps from the sensor:

  * cells strictly before the measured range: += l_free (negative);
  * the first new cell at/after the measured range: += l_occ, skipped for
    max-range misses;
  * each visited cell updates once per beam (cell dedup along the beam);
  * the march stops at the first out-of-bounds step.

The fidelity mode (per-particle uint8 maps) waits for ROADMAP.md Queue 1
item 11.
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.core import grid as gridlib
from slam_tpu_torch.core.types import Pose, Scan
from slam_tpu_torch.ops.measurement import sensor_pose


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
