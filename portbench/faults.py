"""Faults planted in the program's step, for the readings that show the
comparison catches them (`tests/test_portbench_harness.py` on the CPU,
`control.py --fault` on the card). Each wraps the `step` of the entry
point a request module names as its `ENTRY`:

  unchanged  the step returns its state unchanged
  half       half of the batch left out: the second half of the particles
             keeps the state before the step
  answer     the answer altered where it is produced: the pose estimate
             moved by half a pixel
  mode       the mode pose the step holds moved by half a pixel and
             turned by 0.01 rad (in SLAM the pose the map is made from;
             the answer left alone)
"""

from __future__ import annotations

import contextlib
import importlib

import torch


def _with_particles(new, before, fn):
    """`new` with its particles' fields replaced by fn(new's, before's)."""
    slam = hasattr(new, "mcl")
    pn = new.mcl.particles if slam else new.particles
    pb = before.mcl.particles if slam else before.particles
    parts = pn.replace(pose=pn.pose.replace(**{f: fn(getattr(pn.pose, f), getattr(pb.pose, f))
                                               for f in ("x", "y", "theta")}),
                       log_weight=fn(pn.log_weight, pb.log_weight))
    return new.replace(mcl=new.mcl.replace(particles=parts)) if slam else new.replace(particles=parts)


def _half(a, b):
    n = a.shape[0] // 2
    return torch.cat([a[:n], b[n:]])


def _shift(pose):
    return pose.replace(x=pose.x + 0.5)


def _turn(pose):
    return _shift(pose).replace(theta=pose.theta + 0.01)


def _mode(new):
    if hasattr(new, "mcl"):
        return new.replace(mcl=new.mcl.replace(mode_pose=_turn(new.mcl.mode_pose)))
    return new.replace(mode_pose=_turn(new.mode_pose))


FAULTS = {
    "unchanged": lambda new, before: before,
    "half": lambda new, before: _with_particles(new, before, _half),
    "answer": lambda new, before: (new.replace(est_pose=_shift(new.est_pose))
                                   if hasattr(new, "est_pose")
                                   else new.replace(mode_pose=_shift(new.mode_pose))),
    "mode": lambda new, before: _mode(new),
}


@contextlib.contextmanager
def planted(fault: str, request: str):
    """The `step` of the entry point of request module `request` broken
    by `fault` inside the block."""
    cls = importlib.import_module(f"portbench.requests.{request}").ENTRY
    step = cls.step

    def broken(self, state, *a, **kw):
        return FAULTS[fault](step(self, state, *a, **kw), state)

    cls.step = broken
    try:
        yield
    finally:
        cls.step = step
