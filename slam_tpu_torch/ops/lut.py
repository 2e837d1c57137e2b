"""Directional ray-distance lookup tables for static maps (port of
`slam_tpu/ops/lut.py`).

``lut[i, j, b]`` is the distance from the center of cell (i, j) to the
first blocked cell along angular bin b (bins-LAST: all bins of one cell
are one contiguous row). A ray query is one gather; the MCL measurement
reads one whole row per particle (`panorama_rows`, through the CUDA row
gather `ops/pano_cuda.py` on the card).

Build: per bin, the 2x2-dilated map is resampled into a rotated canvas
whose +column is the bin direction; the run to the next blocked cell is a
reverse cummin of column indices; the result is sampled back at the cell
centers. With n_bins % 4 == 0 one canvas serves bins theta, +90, +180 and
+270 (the four forward/reverse cummin/cummax scans of the same canvas),
as in the JAX build; the module docstring there has the derivation.
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.core import grid as gridlib
from slam_tpu_torch.ops.pano_cuda import gather_rows


def dilate2x2(blocked: torch.Tensor) -> torch.Tensor:
    """Conservative sampling support: "any of the 4 cells around a float
    point is blocked" is a nearest-floor sample of this 2x2 dilation."""
    dil = blocked.clone()
    dil[:-1, :] |= blocked[1:, :]
    out = dil.clone()
    out[:, :-1] |= dil[:, 1:]
    return out


def _iota(d0: int, d1: int, axis: int, device) -> torch.Tensor:
    n = (d0, d1)[axis]
    v = torch.arange(n, dtype=torch.float32, device=device)
    return (v[:, None] if axis == 0 else v[None, :]).expand(d0, d1)


def rotated_blocked_canvas(
    blocked: torch.Tensor, theta, d: int, dil: torch.Tensor | None = None
) -> torch.Tensor:
    """Conservative rotated canvas: canvas cell (u, v) samples the
    2x2-dilated map at the rotated point, with +v the ray direction of
    `theta` (an f32 0-d tensor)."""
    h, w = blocked.shape
    dev = blocked.device
    ci, cj, cd = (h - 1) / 2.0, (w - 1) / 2.0, (d - 1) / 2.0
    uu = _iota(d, d, 0, dev) - cd
    vv = _iota(d, d, 1, dev) - cd
    if dil is None:
        dil = dilate2x2(blocked)
    di = -torch.sin(theta)
    dj = torch.cos(theta)
    fi = ci + uu * dj + vv * di
    fj = cj + uu * (-di) + vv * dj
    i = torch.floor(fi).to(torch.int32)
    j = torch.floor(fj).to(torch.int32)
    inb = gridlib.in_bounds((h, w), i, j)
    ic = torch.clamp(i, 0, h - 1).long()
    jc = torch.clamp(j, 0, w - 1).long()
    return dil.reshape(-1)[ic * w + jc] & inb


def _rev_cummin(a: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(a, (dim,)), dim).values, (dim,))


def build_beam_lut(
    blocked: torch.Tensor,
    n_bins: int = 360,
    max_dist: float = 500.0,
    dtype=torch.bfloat16,
    *,
    _force_per_bin: bool = False,
) -> torch.Tensor:
    """[H, W, n_bins] distance-to-obstacle table on `blocked`'s device
    (values capped just above max_dist so queries >= max_dist read as
    misses). `dtype` is torch.bfloat16 or torch.uint8 (fixed point)."""
    blocked = blocked.to(torch.bool)
    dev = blocked.device
    h, w = blocked.shape
    d = int(math.ceil(math.hypot(h, w))) + 2
    cap = torch.tensor(max_dist * 1.25, dtype=torch.float32, device=dev)
    q_u8 = cap / 255.0

    ci, cj, cd = (h - 1) / 2.0, (w - 1) / 2.0, (d - 1) / 2.0
    ucol = _iota(d, d, 0, dev)
    vcol = _iota(d, d, 1, dev)
    ii_img = _iota(h, w, 0, dev) - ci
    jj_img = _iota(h, w, 1, dev) - cj
    dil = dilate2x2(blocked)
    big = float(1 << 20)

    def canvas_and_back_idx(theta):
        di = -torch.sin(theta)
        dj = torch.cos(theta)
        rot_blocked = rotated_blocked_canvas(blocked, theta, d, dil)
        u_q = ii_img * dj + jj_img * (-di) + cd
        v_q = ii_img * di + jj_img * dj + cd
        ui = torch.clamp(torch.round(u_q).to(torch.int32), 0, d - 1).long()
        vi = torch.clamp(torch.round(v_q).to(torch.int32), 0, d - 1).long()
        return rot_blocked, ui, vi

    def encode(run):
        out = torch.minimum(run, cap)
        if dtype == torch.uint8:
            return torch.clamp(torch.floor(out / q_u8), 0.0, 255.0).to(torch.uint8)
        return out.to(dtype)

    def bin_angle(b: int):
        return torch.tensor(b, dtype=torch.float32, device=dev) * (
            2.0 * math.pi / n_bins
        )

    lut = torch.empty((h, w, n_bins), dtype=dtype, device=dev)
    if n_bins % 4 == 0 and not _force_per_bin:
        n4 = n_bins // 4
        for b in range(n4):
            rot_blocked, ui, vi = canvas_and_back_idx(bin_angle(b))
            vb = torch.where(rot_blocked, vcol, big)
            vbn = torch.where(rot_blocked, vcol, -big)
            ub = torch.where(rot_blocked, ucol, big)
            ubn = torch.where(rot_blocked, ucol, -big)
            runs = [
                _rev_cummin(vb, 1) - vcol,  # theta: +v
                ucol - torch.cummax(ubn, 0).values,  # theta + 90: -u
                vcol - torch.cummax(vbn, 1).values,  # theta + 180: -v
                _rev_cummin(ub, 0) - ucol,  # theta + 270: +u
            ]
            packed = torch.stack([encode(r) for r in runs], dim=-1)
            # bin q * n4 + b of every cell
            lut[:, :, b::n4] = packed.reshape(d * d, 4)[ui * d + vi]
        return lut

    for b in range(n_bins):
        rot_blocked, ui, vi = canvas_and_back_idx(bin_angle(b))
        nb = _rev_cummin(torch.where(rot_blocked, vcol, big), 1)
        lut[:, :, b] = encode((nb - vcol)[ui, vi])
    return lut


def lut_quant_step(lut_dtype, max_dist: float):
    """Dequantization step q for a quantized table (None for float tables);
    a stored value v decodes as (v + 0.5) * q."""
    if lut_dtype == torch.uint8:
        return float(max_dist) * 1.25 / 255.0
    return None


def dequantize(vals, lut_dtype, max_dist: float):
    """Decode raw table values to f32 distances."""
    q = lut_quant_step(lut_dtype, max_dist)
    vals = vals.to(torch.float32)
    return vals if q is None else (vals + 0.5) * q


def angle_bin(theta, n_bins: int):
    """Angular bin of a ray direction (round-to-nearest, wrapped)."""
    two_pi = 2.0 * math.pi
    b = torch.round(theta / (two_pi / n_bins)).to(torch.int32)
    return torch.remainder(b, n_bins)


def raycast_lut(lut: torch.Tensor, x, y, theta, *, max_dist: float = 500.0,
                n_bins: int | None = None):
    """Query the table: one gather per ray. Returns (dist, hit) with the
    march conventions (miss -> dist == max_dist, hit == False). `n_bins` is
    the semantic bin count when storage rows are padded."""
    h, w, stride = lut.shape
    n_bins = n_bins or stride
    dev = lut.device
    x, y, theta = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (x, y, theta))
    )
    b = angle_bin(theta, n_bins)
    i, j = gridlib.world_to_cell((h, w), x, y)
    inb = gridlib.in_bounds((h, w), i, j)
    ic, jc = gridlib.clamp_cell((h, w), i, j)
    flat = (ic.long() * w + jc) * stride + b
    d = dequantize(lut.reshape(-1)[flat], lut.dtype, max_dist)
    hit = (d < max_dist) & inb
    dist = torch.where(hit, d, torch.full_like(d, max_dist))
    return dist, hit


def panorama_index(shape, x, y):
    """(row index i32 into the [H*W, bins] view, in-bounds mask) of each
    query position's cell."""
    h, w = shape
    i, j = gridlib.world_to_cell((h, w), x, y)
    inb = gridlib.in_bounds((h, w), i, j)
    ic, jc = gridlib.clamp_cell((h, w), i, j)
    return ic * w + jc, inb


def panorama_rows(lut: torch.Tensor, x, y, n_bins: int | None = None):
    """All-bins distance row of each query position's cell: ONE row gather
    per query (the CUDA row-gather kernel for a table on the card).

    Returns (pano [..., n_bins] in the table's dtype, inb bool[...])."""
    h, w, stride = lut.shape
    n_bins = n_bins or stride
    x = torch.as_tensor(x, dtype=torch.float32, device=lut.device)
    y = torch.as_tensor(y, dtype=torch.float32, device=lut.device)
    idx, inb = panorama_index((h, w), x, y)
    rows = gather_rows(lut.reshape(h * w, stride), idx.reshape(-1).contiguous())
    pano = rows.reshape(*idx.shape, stride)
    return pano[..., :n_bins], inb
