"""The judge of `requests/rbpf.py`'s requests: `RBPF.step` (motion, each
particle weighed against and written into its own map, systematic
resampling of the particles with their maps), worked out again from the
program's state before each (`reference/rbpf.py`), replaying the
filter's own generator: K1's Philox seed, then the resampler's u0. Every
particle's weight and new map is worked out again for each sampled
request. The numbers, each the widest over the sampled requests:

  weight_rel_gap           the reference's largest log weight less its
                           log weight of the particle the program kept
                           as its best (`best_pose`, found by its exact
                           bits among the moved particles; inf where it
                           is none of them), over the largest's size
  particle_mismatch_share  the share of slots after the request whose
                           particle is none of the reference's moved
                           particles or whose log weight is not -log n
                           (`judge_slam.resampled`)
  resample_gap_draws       the widest distance, in draws, from a slot's
                           draw to the interval of the particle the
                           program kept there (`judge_slam.resampled`)
  map_mismatch_cells       cells of the maps after the request that
                           differ from the reference's new map of the
                           particle their slot holds (found by its
                           bits; the reference's own choice for a slot
                           whose particle is not found), over all slots
  pose_gap_px              distance between the mean pose the program
                           read and the reference's resampled cloud's
  heading_gap_rad          the same for the circular mean heading
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import filter as flt, motion, rbpf
from portbench.reference.judge import Reference, fields, pose_gaps, widest
from portbench.reference.judge_slam import _keys, resampled

# Maps compared at once.
_SLOTS = 64


def owners(x, y, gx, gy):
    """(the index of the particle of (x, y) whose position has the exact
    bits of each (gx, gy), whether there is one)."""
    keys, order = torch.sort(_keys(x, y))
    want = _keys(gx, gy)
    pos = torch.searchsorted(keys, want).clamp(max=keys.shape[0] - 1)
    return order[pos], keys[pos] == want


def judge_one(ref: Reference, rec: dict) -> dict:
    cfg = ref.cfg
    req, before, after = rec["req"], rec["before"], rec["after"]
    x, y, th, logw_in = fields(before.particles)
    gen = motion.clone(rec["gen"], x.device)
    x, y, th = motion.sample(gen, req.odom, cfg["alphas"], x, y, th)
    dists = rec["scan"].to(x.device)
    maps_before = before.maps.to(x.device)
    lw, maps = rbpf.weigh_and_map(maps_before, x, y, th, dists, ref.angles, cfg)
    del maps_before
    logw = logw_in + lw
    u0 = torch.rand((), generator=gen, device=x.device)
    got = fields(after.particles)
    share, draws = resampled(x, y, th, logw, u0, got)
    out = {"particle_mismatch_share": share, "resample_gap_draws": draws}

    # The best particle the program kept.
    bp = after.best_pose
    k, found = owners(x, y, bp.x.reshape(1), bp.y.reshape(1))
    top = float(logw.max())
    out["weight_rel_gap"] = ((top - float(logw[k[0]])) / max(abs(top), 1e-30)
                             if bool(found[0]) else math.inf)

    # Each slot's map against the reference's new map of its particle.
    idx = flt.systematic(logw, u0)
    a, ok = owners(x, y, got[0], got[1])
    a = torch.where(ok, a, idx)
    bad = 0
    for s0 in range(0, a.shape[0], _SLOTS):
        s1 = min(a.shape[0], s0 + _SLOTS)
        bad += int((after.maps[s0:s1].to(x.device) != maps[a[s0:s1]]).sum())
    out["map_mismatch_cells"] = float(bad)

    # The answer: the mean pose of the cloud after resampling.
    px, rad = pose_gaps(rec["pose"], rbpf.mean_pose(x[idx], y[idx], th[idx]))
    out["pose_gap_px"], out["heading_gap_rad"] = px, rad
    return out


def judge(records, cfg: dict, blocked: np.ndarray, angles: torch.Tensor, dev) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return widest(records, judge_one, Reference(cfg, blocked, angles, dev))
