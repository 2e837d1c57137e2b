"""Correlative scan matching: local pose refinement on the likelihood field
(port of `slam_tpu/ops/scanmatch.py`).

The seed pose (typically the best particle) seeds a local correlative
search (the single-level form of Olson, "Real-time correlative scan
matching", ICRA 2009, with an optional coarse level): a [theta_bins, D, D]
grid of integer-cell translations x heading candidates around the sensor
pose is scored by summing each beam endpoint's likelihood-field log score
(`measurement.lf_log_score_field`), BILINEARLY interpolated at the
endpoint's continuous position; a quadratic fit to the peak recovers
sub-cell / sub-bin resolution. Integer shifts keep the interpolation
weights shared across the candidate grid, so the search is four gathers
of T * D^2 * B elements plus reductions, independent of the particle
count. Out-of-map corners score the z_rand floor, max-range beams are
excluded, and a tiny center-preferring bias breaks ties on flat score
surfaces so degenerate inputs refine to the seed pose.

Everything stays on the field's device: the argmax and its neighbours
are read by flat 1-element gathers, and the result is a pose of 0-d
tensors there, with no host read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from slam_tpu_torch.core import grid as gridlib
from slam_tpu_torch.core.config import RaycastConfig, ScanMatchConfig
from slam_tpu_torch.core.types import Pose, Scan
from slam_tpu_torch.ops import measurement


def _at(flat_values, idx):
    """flat_values[idx] for a 0-d index tensor, as a 0-d tensor (a
    1-element gather: indexing with a 0-d device tensor would read it on
    the host)."""
    return flat_values[idx.reshape(1)].reshape(())


def _unravel(flat, shape):
    t, dy, dx = shape
    return flat // (dy * dx), (flat // dx) % dy, flat % dx


def _centered(n: int, dev):
    return torch.arange(n, dtype=torch.float32, device=dev) - (n - 1) / 2.0


def _window_scores(field_flat, hw, ib, jb, off, valid, floor_val, weights=None):
    """Summed beam scores [T, Dy, Dx] of endpoint cells (ib, jb) [T, B]
    shifted by `off` rows (-) and columns (+): each (corner, weight) of
    `weights` reads `field_flat` at the shifted cell plus the corner's
    (di, dj), the z_rand floor off the map."""
    h, w = hw
    if weights is None:
        weights = (((0, 0), None),)
    vals = None
    for (di, dj), wt in weights:
        i_c = (ib + di)[:, None, None, :] - off[None, :, None, None]  # [T, dy, dx, B]
        j_c = (jb + dj)[:, None, None, :] + off[None, None, :, None]
        inb = (i_c >= 0) & (i_c < h) & (j_c >= 0) & (j_c < w)
        v = torch.where(
            inb, field_flat[i_c.clamp(0, h - 1).long() * w + j_c.clamp(0, w - 1)], floor_val)
        v = v if wt is None else wt * v
        vals = v if vals is None else vals + v
    return torch.sum(torch.where(valid, vals, 0.0), dim=-1)


def _biased_argmax(score, ctr_t, ctr_w):
    """Flat argmax of `score` [T, D, D] less a 1e-6 center-preferring bias
    (the first maximum, as jnp.argmax)."""
    biased = score - 1e-6 * (ctr_t[:, None, None] + ctr_w[None, :, None] + ctr_w[None, None, :])
    return torch.argmax(biased.reshape(-1))


def _robot_pose(sp: Pose, dtheta, dx_w, dy_w, scanner_offset) -> Pose:
    """Back from a shifted SENSOR pose to the robot pose (the inverse of
    `measurement.sensor_pose`)."""
    dist, th, rot = measurement.scanner_displacement(scanner_offset)
    theta_s = sp.theta + dtheta
    theta_r = theta_s - rot
    return Pose(
        x=sp.x + dx_w - torch.cos(theta_r + th) * dist,
        y=sp.y + dy_w - torch.sin(theta_r + th) * dist,
        theta=theta_r,
    )


def _coarse_shift(lfield2d, pose: Pose, scan: Scan, *, rc, cfg, scanner_offset, floor_val):
    """Coarse level of the multi-resolution search (Olson ICRA-2009
    section IV.B): translations at stride `coarse_stride` over a wide
    window, scored against a stride-MAX-POOLED score field, so each strided
    candidate bounds its whole (stride x stride) block from above; returns
    the coarsely shifted ROBOT pose, the winning block's center."""
    h, w = lfield2d.shape
    dev = lfield2d.device
    s = int(cfg.coarse_stride)
    cw = int(cfg.coarse_window)
    tc = int(cfg.coarse_theta_bins)
    chalf = float(cfg.coarse_theta_halfwidth)
    # pooled[i, j] = max lfield[i-s+1 .. i, j .. j+s-1]: JAX's reduce_window
    # with padding ((s-1, 0), (0, s-1)), i.e. -inf rows on top and columns
    # on the right (F.pad orders (left, right, top, bottom)).
    padded = F.pad(lfield2d[None, None], (0, s - 1, s - 1, 0), value=-math.inf)
    pooled = F.max_pool2d(padded, s, stride=1)[0, 0].reshape(-1)

    tstep = 2.0 * chalf / max(tc - 1, 1)
    sp = measurement.sensor_pose(pose, scanner_offset)
    ts = sp.theta + _centered(tc, dev) * tstep
    ang = ts[:, None] + scan.angles[None, :]  # [Tc, B]
    ex = sp.x + scan.dists[None, :] * torch.cos(ang)
    ey = sp.y + scan.dists[None, :] * torch.sin(ang)
    ib, jb = gridlib.world_to_cell((h, w), ex, ey)
    valid = (scan.dists < rc.max_dist)[None, None, None, :]
    off = torch.arange(-cw, cw + 1, s, dtype=torch.int32, device=dev)
    score = _window_scores(pooled, (h, w), ib, jb, off, valid, floor_val)

    ctr_t = _centered(tc, dev) ** 2
    ctr_w = (off.to(torch.float32) / s) ** 2
    t0, y0, x0 = _unravel(_biased_argmax(score, ctr_t, ctr_w), score.shape)
    dtheta = (t0.to(torch.float32) - (tc - 1) / 2.0) * tstep
    # The winning block covers offsets [o, o + s): hand the fine level its
    # middle, so the residual is within s / 2 of the fine window's center.
    dy_w = (y0 * s - cw).to(torch.float32) + (s - 1) / 2.0
    dx_w = (x0 * s - cw).to(torch.float32) + (s - 1) / 2.0
    return _robot_pose(sp, dtheta, dx_w, dy_w, scanner_offset)


def _peak_delta(s_minus, s_0, s_plus):
    """Sub-sample offset of a quadratic through three samples, in [-.5,
    .5]; zero when the triple is not concave."""
    den = s_minus - 2.0 * s_0 + s_plus
    delta = torch.where(den < -1e-12, 0.5 * (s_minus - s_plus) / den, 0.0)
    return torch.clamp(delta, -0.5, 0.5)


def refine_pose(
    field,
    pose: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig,
    cfg: ScanMatchConfig = ScanMatchConfig(),
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    z_hit: float = 0.95,
    z_rand: float = 0.05,
):
    """Refine a scalar pose estimate against one scan.

    `field` is a `RayField` with `edt` set (the capped transform of the
    likelihood-field measurement will do: the search reads the field only
    within ~stddev of obstacles); `pose` the seed robot pose, 0-d tensors.
    Returns (refined robot `Pose`, peak log score at the integer argmax),
    0-d tensors on the field's device."""
    edt = field.edt
    if edt is None:
        raise ValueError("scan matching needs field.edt")
    h, w = edt.shape
    dev = edt.device
    # Score |edt - edt_offset|: endpoints belong on wall faces, not wall
    # cell centers (ScanMatchConfig.edt_offset).
    lfield2d = measurement.lf_log_score_field(
        torch.abs(edt - cfg.edt_offset), stddev=stddev, z_hit=z_hit, z_rand=z_rand,
        max_dist=rc.max_dist,
    )
    lfield = lfield2d.reshape(-1)
    floor_val = float(math.log(max(z_rand / rc.max_dist, 1e-30)))
    if cfg.coarse_window > 0:
        pose = _coarse_shift(lfield2d, pose, scan, rc=rc, cfg=cfg,
                             scanner_offset=scanner_offset, floor_val=floor_val)

    t = int(cfg.theta_bins)
    half = float(cfg.theta_halfwidth)
    win = int(cfg.window)
    d = 2 * win + 1
    tstep = 2.0 * half / max(t - 1, 1)

    sp = measurement.sensor_pose(pose, scanner_offset)
    ts = sp.theta + _centered(t, dev) * tstep
    ang = ts[:, None] + scan.angles[None, :]  # [T, B]
    ex = sp.x + scan.dists[None, :] * torch.cos(ang)
    ey = sp.y + scan.dists[None, :] * torch.sin(ang)
    # Continuous cell-center coordinates: ci / cj are exactly (i, j) at the
    # center of cell (i, j) of `world_to_cell`, so the bilinear sample
    # reproduces L[i, j] there (the JAX package's comment has the why).
    ci = h - ey - 1.5
    cj = ex - 0.5
    i0 = torch.floor(ci).to(torch.int32)  # [T, B]
    j0 = torch.floor(cj).to(torch.int32)
    wi = (ci - i0)[:, None, None, :]  # fractional weights, shared by every shift
    wj = (cj - j0)[:, None, None, :]
    valid = (scan.dists < rc.max_dist)[None, None, None, :]
    off = torch.arange(-win, win + 1, dtype=torch.int32, device=dev)
    corners = (
        ((0, 0), (1.0 - wi) * (1.0 - wj)),
        ((0, 1), (1.0 - wi) * wj),
        ((1, 0), wi * (1.0 - wj)),
        ((1, 1), wi * wj),
    )
    score = _window_scores(lfield, (h, w), i0, j0, off, valid, floor_val, corners)

    ctr_t = _centered(t, dev) ** 2
    ctr_w = off.to(torch.float32) ** 2
    flat = _biased_argmax(score, ctr_t, ctr_w)
    t0, y0, x0 = _unravel(flat, score.shape)
    sflat = score.reshape(-1)
    peak = _at(sflat, flat)

    if cfg.subcell:
        # Quadratic peak fit per axis; disabled at window borders (the
        # shifted triple would not bracket the max).
        def s_at(tt, yy, xx):
            return _at(sflat, (tt * d + yy) * d + xx)

        tc = torch.clamp(t0, 1, max(t - 2, 1))
        yc = torch.clamp(y0, 1, d - 2)
        xc = torch.clamp(x0, 1, d - 2)
        dt = torch.where((t0 == tc) & (t > 2), _peak_delta(
            s_at(tc - 1, y0, x0), s_at(tc, y0, x0), s_at(tc + 1, y0, x0)), 0.0)
        dy = torch.where(y0 == yc, _peak_delta(
            s_at(t0, yc - 1, x0), s_at(t0, yc, x0), s_at(t0, yc + 1, x0)), 0.0)
        dx = torch.where(x0 == xc, _peak_delta(
            s_at(t0, y0, xc - 1), s_at(t0, y0, xc), s_at(t0, y0, xc + 1)), 0.0)
    else:
        dt = dy = dx = torch.zeros((), dtype=torch.float32, device=dev)

    dtheta = (t0.to(torch.float32) - (t - 1) / 2.0 + dt) * tstep
    dx_w = x0.to(torch.float32) - win + dx
    # Score axis 1 indexes +dy (i_c = ib - dy), so the fit offset is +dy.
    dy_w = y0.to(torch.float32) - win + dy
    return _robot_pose(sp, dtheta, dx_w, dy_w, scanner_offset), peak
