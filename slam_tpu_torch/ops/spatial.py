"""Batched spatial queries: nearest neighbour and box range queries (port
of `slam_tpu/ops/spatial.py`).

The replacement for the reference's kd-tree (`slam/kdtree.cpp:111-180`)
and point quadtree (`slam/quadtree.cpp:89-139`): points live in a
fixed-capacity SoA buffer (`x: f32[N], y: f32[N], valid: bool[N]`) and a
query evaluates all N candidates as one dense masked distance tile.
Ties take the first index (`argmin`), as in JAX; distances are taken
through the correctly rounded square root of `ops/edt.py`.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.ops.edt import _sqrt

INF = 1e30


def sq_dist_tile(px, py, qx, qy):
    """f32[Q, N] squared distances between query and point sets."""
    return (qx[:, None] - px[None, :]) ** 2 + (qy[:, None] - py[None, :]) ** 2


def nearest_neighbor(px, py, valid, qx, qy):
    """Nearest valid point per query: (idx i32[Q], dist f32[Q]), idx -1 /
    dist INF when no point is valid."""
    d2 = torch.where(valid[None, :], sq_dist_tile(px, py, qx, qy), INF)
    idx = torch.argmin(d2, dim=1)
    best = torch.gather(d2, 1, idx[:, None])[:, 0]
    none = best >= INF
    return (
        torch.where(none, -1, idx).to(torch.int32),
        torch.where(none, INF, _sqrt(best)),
    )


def within_radius(px, py, valid, qx, qy, radius):
    """bool[Q, N]: valid points within Euclidean `radius` of each query."""
    return valid[None, :] & (sq_dist_tile(px, py, qx, qy) <= radius * radius)


def in_box(px, py, valid, box):
    """bool[N]: valid points inside the inclusive box (x0, y0, x1, y1)."""
    x0, y0, x1, y1 = box
    return valid & (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)


def range_query_boxes(px, py, valid, boxes):
    """bool[Q, N] membership masks for a batch of boxes f32[Q, 4]."""
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    inx = (px[None, :] >= x0[:, None]) & (px[None, :] <= x1[:, None])
    iny = (py[None, :] >= y0[:, None]) & (py[None, :] <= y1[:, None])
    return valid[None, :] & inx & iny


def nearest_neighbor_blocked(px, py, valid, qx, qy, block: int = 4096):
    """NN over large point buffers: a loop over `block`-point blocks bounds
    the tile to [Q, block]. The buffer is padded to whole blocks with
    invalid points, and a block's best replaces the running best only
    where strictly nearer, so ties keep the earlier block (the JAX scan)."""
    n = px.shape[0]
    q = qx.shape[0]
    pad = (-n) % block
    if pad:
        px = torch.nn.functional.pad(px, (0, pad))
        py = torch.nn.functional.pad(py, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    best_d2 = torch.full((q,), INF, dtype=torch.float32, device=qx.device)
    best_i = torch.full((q,), -1, dtype=torch.int32, device=qx.device)
    for base in range(0, n + pad, block):
        sl = slice(base, base + block)
        d2 = torch.where(valid[None, sl], sq_dist_tile(px[sl], py[sl], qx, qy), INF)
        bi = torch.argmin(d2, dim=1)
        bd = torch.gather(d2, 1, bi[:, None])[:, 0]
        better = bd < best_d2
        best_d2 = torch.where(better, bd, best_d2)
        best_i = torch.where(better, base + bi.to(torch.int32), best_i)
    return best_i, torch.where(best_d2 >= INF, INF, _sqrt(best_d2))
