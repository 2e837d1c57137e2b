"""The judge of `requests/slam.py`'s requests: `GridSLAM.step` (motion,
the capped EDT of the grid before the step, the likelihood-field table
weights, estimate, the log-odds map update and the resampler on every
`resample_every`-th update), worked out again from the program's state
before each (the numbers: `judge.py`)."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import filter as flt, motion, slam
from portbench.reference.judge import (
    POSE_TOL, TIE_BAND, Reference, fields, mismatch, pose_gaps, widest, wrap,
)

def _keys(x, y):
    """int64 keys of the positions' exact bits."""
    return ((x.view(torch.int32).to(torch.int64) << 32)
            | (y.view(torch.int32).to(torch.int64) & 0xFFFFFFFF))


def resampled(x, y, th, logw, u0, got):
    """The program's resampled particles `got` held to systematic
    resampling of the reference's cloud (x, y, th, logw) with the draw
    offset u0: (the share of slots whose particle is no particle of that
    cloud, found by the exact bits of its position, or whose log weight
    is not -log n; the widest distance, in draws, from a slot's draw to
    the interval of draws of the particle the program kept there).

    Draw k takes particle i iff n c_{i-1} - u0 <= k < n c_i - u0, c the
    normalised prefix sum of the weights. Rounding in the weights moves
    those bounds by a fraction of a draw times the weights' relative
    error, which turns a draw near a bound to another particle, however
    many particles of no weight lie between: a change of slot that the
    distance, and not the share, reads."""
    n = x.shape[0]
    gx, gy, gt, gw = got
    c = torch.cumsum(torch.softmax(logw, dim=-1), dim=-1, dtype=torch.float64)
    c = c / c[-1:]
    u = float(u0)
    hi = n * c - u
    lo = torch.cat([hi.new_full((1,), -u), hi[:-1]])
    keys, order = torch.sort(_keys(x, y))
    want = _keys(gx, gy)
    pos = torch.searchsorted(keys, want).clamp(max=n - 1)
    a = order[pos]
    dth = torch.remainder(gt - th[a] + math.pi, 2.0 * math.pi) - math.pi
    found = (keys[pos] == want) & (dth.abs() <= POSE_TOL)
    k = torch.arange(n, dtype=torch.float64, device=x.device)
    g = torch.clamp(torch.maximum(lo[a] - k, k - hi[a]), min=0.0)
    gap = float(g[found].max()) if bool(found.any()) else 0.0
    bad = ~found | ((gw + flt.log_f32(n)).abs() > 1e-3)
    return float(bad.float().mean()), gap


def judge_one(ref: Reference, rec: dict) -> dict:
    cfg = ref.cfg
    req = rec["req"]
    before, after = rec["before"], rec["after"]
    x, y, th, logw_in = fields(before.mcl.particles)
    gen = motion.clone(rec["gen"], x.device)
    x, y, th = motion.sample(gen, req.odom, cfg["alphas"], x, y, th)
    dists = rec["scan"].to(x.device)
    blocked = before.grid > 0.0
    edt = slam.edt_capped(blocked, 5.0 * cfg["meas_stddev"] + 2.0)
    lw = slam.lf_weights(edt, x, y, th, dists, ref.angles, cfg)
    resample = before.mcl.updates % cfg["resample_every"] == 0
    logw = logw_in + lw
    _, mode, tied = flt.estimate(x, y, th, logw, lw, cfg["mode_tau"])
    got = fields(after.mcl.particles)
    if resample:
        u0 = torch.rand((), generator=gen, device=x.device)
        share, draws = resampled(x, y, th, logw, u0, got)
        out = {"particle_mismatch_share": share, "resample_gap_draws": draws}
    else:
        out = {"particle_mismatch_share": mismatch(got, (x, y, th, logw))}
    # The mode pose the program holds after the step, held to the
    # reference's on every request; the map update follows it, so the
    # map is judged from a pose that is itself judged.
    m = after.mcl.mode_pose
    gap_px, gap_rad = pose_gaps((m.x, m.y, m.theta), mode)
    grid = slam.logodds_update(before.grid, m.x, m.y, m.theta, dists, ref.angles, cfg)
    out["map_mismatch_cells"] = float(((after.grid - grid).abs() > 1e-4).sum())
    # The answer: the best particle where the measurement is informative,
    # else the mode pose. Where the share of particles tied at the top
    # lies within TIE_BAND of a half, rounding may tip the program either
    # way, and the answer is judged as what it is.
    read = rec["pose"]
    d = torch.hypot(x - read[0], y - read[1])
    k = int(torch.argmin(d))
    particle = float(d[k]) <= POSE_TOL and abs(wrap(float(th[k]) - read[2])) <= POSE_TOL
    if tied < 0.5 - TIE_BAND or (particle and tied < 0.5 + TIE_BAND):
        out["est_weight_gap"] = float(logw.max() - logw[k]) if particle else math.inf
    else:
        px, rad = pose_gaps(read, mode)
        gap_px, gap_rad = max(gap_px, px), max(gap_rad, rad)
    out["pose_gap_px"], out["heading_gap_rad"] = gap_px, gap_rad
    return out


def judge(records, cfg: dict, blocked: np.ndarray, angles: torch.Tensor, dev) -> dict:
    return widest(records, judge_one, Reference(cfg, blocked, angles, dev))
