"""The judge of `requests/mcl.py`'s requests: `MCL.step` (motion, the LUT
beam weights, estimate and systematic resampler) and the wake-up of
`mcl.init_uniform`, worked out again from the program's state before
each (the numbers: `judge.py`)."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import filter as flt, motion
from portbench.reference.judge import (
    Reference, fields, mismatch, pose_gaps, weigh_and_resample, widest,
)


def judge_one(ref: Reference, rec: dict) -> dict:
    cfg = ref.cfg
    kind, req = rec["kind"], rec["req"]
    x, y, th, logw_in = fields(rec["before"].particles)
    got = fields(rec["after"].particles)
    gen = motion.clone(rec["gen"], x.device)
    if kind == "init":
        wx, wy, wt = flt.wake_up(gen, x.shape[0], ref.blocked)
        h, w = ref.blocked.shape
        want = (wx, wy, wt, torch.full_like(logw_in, -flt.log_f32(x.shape[0])))
        estimate = (w / 2.0, h / 2.0, math.pi / 2.0)
    else:
        x, y, th = motion.sample(gen, req.odom, cfg["alphas"], x, y, th)
        lw = ref.beam_weights(x, y, th, rec["scan"])
        _, estimate, _, want = weigh_and_resample(x, y, th, logw_in, lw, gen, True,
                                                  cfg["mode_tau"])
    out = {"particle_mismatch_share": mismatch(got, want)}
    out["pose_gap_px"], out["heading_gap_rad"] = pose_gaps(rec["pose"], estimate)
    return out


def judge(records, cfg: dict, blocked: np.ndarray, angles: torch.Tensor, dev) -> dict:
    return widest(records, judge_one, Reference(cfg, blocked, angles, dev))
