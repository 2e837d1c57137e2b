"""What the judges of the request kinds share (`judge_<request>.py`, found
by the cell's request module's name): the reference of one cell's
configuration, and the comparisons of particles and poses.

A judge works out again each sampled request of the window from the
program's state before it (its particles, its grid and its random
stream), and holds the program's answer and state after it to the
reference's. The reference follows the program step by step: the random
draws of a step are the filter's own stream, which only the state before
the step fixes, so each request starts from the program's state, and the
wake-up requests and the first request of a run check the start by
themselves.

Numbers, each the widest over the sampled requests:
  pose_gap_px              distance between the mode pose the program
                           holds after the request and the reference's
                           (the start pose after a wake-up; in SLAM also
                           the pose read where the measurement is
                           uninformative, which is the mode pose then)
  heading_gap_rad          the same for the heading
  particle_mismatch_share  share of the particles after the request that
                           differ from the reference's (pose by more than
                           1e-3 px or rad, log weight by more than 1e-3 +
                           1e-5 of its size): motion, weights, estimate
                           and resampler together; in SLAM, after a
                           resample, the share of slots whose particle is
                           none of the reference's cloud near the
                           reference's choice (`judge_slam.resampled`)
  resample_gap_draws       SLAM, after a resample: the widest distance, in
                           draws, from a slot's draw to the interval of
                           the particle the program kept there
  est_weight_gap           SLAM: the reference's best accumulated log
                           weight less its log weight of the particle the
                           program returned as its best
  map_mismatch_cells       SLAM: cells whose log-odds differ by more than
                           1e-4 from the reference's update of the grid
                           before the step from the mode pose the program
                           holds after it (which pose_gap_px holds to the
                           reference's)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import beam, filter as flt

POSE_TOL = 1e-3
TIE_BAND = 0.05


def wrap(a: float) -> float:
    return (a + math.pi) % (2.0 * math.pi) - math.pi


class Reference:
    """The reference for one cell's configuration on one device."""

    def __init__(self, cfg: dict, blocked: np.ndarray, angles: torch.Tensor, dev):
        self.cfg, self.dev = cfg, dev
        self.blocked = torch.from_numpy(blocked).to(dev)
        self.angles = angles.to(dev)
        self.angle0 = float(angles[0])
        self._lut = None

    def lut(self):
        if self._lut is None:
            rc = self.cfg["raycast"]
            dtype = {"bf16": torch.bfloat16, "u8": torch.uint8}[rc["lut_dtype"]]
            self._lut = beam.table(self.blocked, rc["lut_bins"], rc["max_dist"], dtype)
        return self._lut

    def beam_weights(self, x, y, th, dists):
        c = self.cfg
        return beam.log_weights(self.lut(), x, y, th, dists.to(self.dev), self.angle0,
                                offset=c["scanner_offset"], beam_stride=c["lut_beam_stride"],
                                max_dist=c["raycast"]["max_dist"], stddev=c["meas_stddev"],
                                eps=c["meas_epsilon"])


def fields(particles):
    p = particles.pose
    return p.x, p.y, p.theta, particles.log_weight


def mismatch(got, want) -> float:
    gx, gy, gt, gw = got
    wx, wy, wt, ww = want
    dth = torch.remainder(gt - wt + math.pi, 2.0 * math.pi) - math.pi
    bad = ((gx - wx).abs() > POSE_TOL) | ((gy - wy).abs() > POSE_TOL) | (dth.abs() > POSE_TOL)
    bad |= (gw - ww).abs() > 1e-3 + 1e-5 * ww.abs()
    return float(bad.float().mean())


def pose_gaps(read, want):
    """(px, rad) between a pose (three floats or tensors) and the
    reference's."""
    read = [float(v) for v in read]
    return (math.hypot(read[0] - float(want[0]), read[1] - float(want[1])),
            abs(wrap(read[2] - float(want[2]))))


def weigh_and_resample(x, y, th, logw_in, lw, gen, resample: bool, tau: float):
    """(best, mode, tie share, the particles after: x, y, th, log w)."""
    logw = logw_in + lw
    best, mode, tied = flt.estimate(x, y, th, logw, lw, tau)
    if resample:
        u0 = torch.rand((), generator=gen, device=x.device)
        idx = flt.systematic(logw, u0)
        n = x.shape[0]
        after = (x[idx], y[idx], th[idx], torch.full_like(logw, -flt.log_f32(n)))
    else:
        after = (x, y, th, logw)
    return best, mode, tied, after


def widest(records, one, ref: Reference) -> dict:
    """{number: widest reading} of `one(ref, record)` over the records."""
    out = {}
    for rec in records:
        for k, v in one(ref, rec).items():
            out[k] = max(out.get(k, 0.0), v)
    return out
