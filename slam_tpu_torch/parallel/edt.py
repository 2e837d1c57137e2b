"""Row-block-sharded distance transforms and likelihood-field pieces
(port of `slam_tpu/parallel/edt.py`).

The map-sharded SLAM engine (`parallel/mapshard.py`) keeps the map in row
blocks over the mesh's 'b' axis; its likelihood-field tiers need a
distance transform of the whole map without any rank holding it:

  * `edt_capped_sharded`: the capped separable transform needs, per
    block, only C + 1 rows of the blocked mask from each neighbour: one
    halo exchange (`ppermute` both ways), then the transform is local;
  * `edt_jfa_sharded`: the capped JFA with an `s`-row halo from both
    neighbours before each pass of step s; the blocks exchange the packed
    seed indices only and recompute the distances;
  * `lf_window_sharded`: the padded score window of the boxed table,
    each block adding the rows it owns (one psum over 'b');
  * `lf_log_weights_sharded`: the direct likelihood field, each block
    reading the endpoint cells it owns (one psum over 'b').

Each equals the replicated function bit for bit: halo cells past the
map's edge carry the no-seed value the replicated pass reads there, and
each psum adds one owner's value to zeros.
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.core import grid as gridlib
from slam_tpu_torch.core.stats import pdf_normal
from slam_tpu_torch.ops import edt as edtlib
from slam_tpu_torch.ops.measurement import lf_log_score_field, sensor_pose


def _block(mesh, shape, map_axis: str):
    """(the map axis, block height, first row of this block)."""
    ax = mesh.axis(map_axis)
    h = shape[0]
    if h % ax.size != 0:
        raise ValueError(f"map rows {h} not divisible by '{map_axis}'={ax.size}")
    lh = h // ax.size
    return ax, lh, ax.index * lh


def _halos(ax, blk, k: int, edge):
    """(top, bottom) k-row halos of row block `blk` from the blocks above
    and below (`ppermute` both ways); past the map's edge they read
    `edge`."""
    d = ax.size
    top = ax.ppermute(blk[-k:], [(i, i + 1) for i in range(d - 1)])  # from the block above
    bot = ax.ppermute(blk[:k], [(i + 1, i) for i in range(d - 1)])  # from the block below
    if ax.index == 0:
        top = torch.full_like(top, edge)
    if ax.index == d - 1:
        bot = torch.full_like(bot, edge)
    return top, bot


def edt_jfa_sharded(mesh, blocked: torch.Tensor, *, max_dist: float, full_shape,
                    map_axis: str = "b", sentinel: float | None = None) -> torch.Tensor:
    """Capped JFA of this rank's row block bool[H / D, W] of a `full_shape`
    map. Returns this block's rows of `ops.edt.edt_jfa(blocked, max_dist,
    sentinel)`, bit for bit."""
    h, w = full_shape
    if h >= (1 << 15) or w >= (1 << 16):
        raise ValueError(f"map {h}x{w} exceeds the 32768x65536 JFA limit")
    ax, lh, off = _block(mesh, full_shape, map_axis)
    steps = edtlib._jfa_steps(max(h, w), max_dist)
    if steps[0] > lh:
        raise ValueError(
            f"JFA step {steps[0]} exceeds block height {lh} ({h} rows / "
            f"{ax.size} blocks): halos would span beyond the immediate neighbor. "
            "Use fewer blocks or a smaller max_dist cap."
        )
    dev = blocked.device
    big = float(h + w if sentinel is None else sentinel)
    ii = off + torch.arange(lh, dtype=torch.int32, device=dev)[:, None].expand(lh, w)
    jj = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(lh, w)
    # The replicated transform's (global_row << 16) | col seed pack.
    idx = torch.where(blocked, (ii << 16) | jj, -1)
    jjf = jj.to(torch.float32)

    def d2_of(idx_, rows):
        si = (idx_ >> 16).to(torch.float32)
        sj = (idx_ & 0xFFFF).to(torch.float32)
        d2 = (rows.to(torch.float32)[:, None] - si) ** 2 + (jjf[:1] - sj) ** 2
        return torch.where(idx_ < 0, 1e9, d2)

    rows_own = off + torch.arange(lh, dtype=torch.int32, device=dev)
    for s in steps:
        top, bot = _halos(ax, idx, s, -1)
        ext = torch.cat([top, idx, bot])  # [lh + 2s, w]
        pad = torch.nn.functional.pad(ext, (s, s), value=-1)  # columns
        # The candidates of own row r (ext row s + r) at (di, dj): ext row
        # s + r - di * s, column j - dj * s, as the replicated pass's roll.
        cand = torch.stack(
            [idx] + [pad[s - di * s: s - di * s + lh, s - dj * s: s - dj * s + w]
                     for di, dj in edtlib._JFA_DIRS]
        )
        best = torch.argmin(d2_of(cand, rows_own), dim=0, keepdim=True)
        idx = torch.gather(cand, 0, best)[0]
    return edtlib._sqrt(torch.clamp(d2_of(idx, rows_own), max=big * big))


def edt_capped_sharded(mesh, blocked: torch.Tensor, *, max_dist: float, full_shape,
                       map_axis: str = "b", sentinel: float | None = None) -> torch.Tensor:
    """Range-capped exact EDT of this rank's row block of a `full_shape`
    map: this block's rows of `ops.edt.edt_capped(blocked, max_dist,
    sentinel)`, bit for bit. One exchange of (C + 1)-row mask halos makes
    the transform block-local: the vertical distance is clamped to C + 1,
    so no farther row can matter, and the row pass stays in the row."""
    h, w = full_shape
    ax, lh, _ = _block(mesh, full_shape, map_axis)
    c = int(math.ceil(max_dist))
    halo = c + 1
    if halo > lh:
        raise ValueError(
            f"edt_capped_sharded: halo {halo} exceeds block height {lh} "
            f"({h} rows / {ax.size} blocks) — use fewer blocks or a smaller cap"
        )
    big = float(h + w if sentinel is None else sentinel)
    blocked = blocked.to(torch.bool)
    top, bot = _halos(ax, blocked, halo, False)
    ext = torch.cat([top, blocked, bot])
    g = edtlib._vertical_dist(ext, c + 1)[halo:halo + lh].to(torch.float32)
    lpad = torch.nn.functional.pad(g * g, (c, c), value=1e9)
    k = torch.arange(-c, c + 1, dtype=torch.float32, device=blocked.device)
    d2 = torch.amin(lpad.unfold(1, 2 * c + 1, 1) + k * k, dim=-1)
    return edtlib._sqrt(torch.clamp(d2, max=big * big))


def lf_window_sharded(mesh, edt: torch.Tensor, i0, j0, *, out_shape, full_shape,
                      stddev: float, z_hit: float, z_rand: float, max_dist: float,
                      map_axis: str = "b") -> torch.Tensor:
    """The replicated (la_i, la_j) = `out_shape` window, starting at global
    cell (i0, j0) (may be negative), of the padded per-cell score field,
    from this rank's row block of the EDT: each block adds the window rows
    it owns (one psum over the map axis); cells off the map read the
    z_rand floor, as `ops.measurement.lf_score_table`'s boxed build."""
    h, w = full_shape
    ax, lh, off = _block(mesh, full_shape, map_axis)
    la_i, la_j = out_shape
    dev = edt.device
    floor_val = float(math.log(max(z_rand / max_dist, 1e-30)))
    field = lf_log_score_field(edt, stddev=stddev, z_hit=z_hit, z_rand=z_rand,
                               max_dist=max_dist)
    rows = torch.as_tensor(i0, device=dev) + torch.arange(la_i, device=dev)
    cols = torch.as_tensor(j0, device=dev) + torch.arange(la_j, device=dev)
    rl = rows - off
    in_blk = (rl >= 0) & (rl < lh)
    core = field.index_select(0, rl.clamp(0, lh - 1)).index_select(1, cols.clamp(0, w - 1))
    win = ax.psum(torch.where(in_blk[:, None], core, 0.0))
    in_map = ((rows >= 0) & (rows < h))[:, None] & ((cols >= 0) & (cols < w))[None, :]
    return torch.where(in_map, win, floor_val)


def lf_log_weights_sharded(mesh, edt: torch.Tensor, poses, scan, *, rc, full_shape,
                           scanner_offset=(0.0, 0.0, 0.0), stddev: float = 5.0,
                           z_hit: float = 0.95, z_rand: float = 0.05,
                           map_axis: str = "b") -> torch.Tensor:
    """Direct likelihood-field log weights of this rank's particles against
    the row-block-sharded EDT: each block reads the endpoint cells it owns
    and one psum over the map axis assembles every beam's distance (each
    clamped endpoint cell lies in one block), then the pdf mixture and the
    beam sum of `ops.measurement.particle_log_weights_likelihood_field`."""
    h, w = full_shape
    ax, lh, off = _block(mesh, full_shape, map_axis)
    sp = sensor_pose(poses, scanner_offset)
    angles = sp.theta[:, None] + scan.angles[None, :]
    z = scan.dists[None, :]
    ex = sp.x[:, None] + z * torch.cos(angles)
    ey = sp.y[:, None] + z * torch.sin(angles)
    i, j = gridlib.world_to_cell((h, w), ex, ey)
    inb = gridlib.in_bounds((h, w), i, j)
    ic, jc = gridlib.clamp_cell((h, w), i, j)
    il = ic - off
    mine = (il >= 0) & (il < lh)
    dloc = edt.reshape(-1)[il.clamp(0, lh - 1).long() * w + jc]
    d = ax.psum(torch.where(mine, dloc, 0.0))
    p_hit = torch.where(inb, pdf_normal(stddev, d), 0.0)
    p = z_hit * p_hit + z_rand / rc.max_dist
    lw = torch.log(torch.clamp(p, min=1e-30))
    lw = torch.where(z >= rc.max_dist, 0.0, lw)
    return torch.sum(lw, dim=-1)
