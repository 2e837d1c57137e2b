"""Faults planted in the RBPF's step (`slam_tpu_torch.models.rbpf`), for
the readings that show the RBPF judge catches them
(`tests/test_torch_rbpf_reference.py` on the CPU; on the card a run of
the cell inside `planted`):

  unchanged       the step returns its state unchanged
  half            the second half of the slots keeps its particles (pose
                  and log weight) from before the step
  no_map_copy     the maps are not resampled with their particles: slot
                  k keeps particle k's new map, whichever particle it
                  took
  first_lane      where lanes of one particle write one cell, the first
                  writer's value stays and not the last's
  post_scan_hits  the predicted hits read from the maps after the scan's
                  writes, not before
  answer          the mean pose the request reads moved by half a pixel

Each patches one name of the program's modules inside `planted`, and is
in the graph a step captures inside it.
"""

from __future__ import annotations

import contextlib

import torch


class _NoGather:
    """`torch` for `models/rbpf.py`, whose map gather takes every slot's
    own map."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def index_select(a, dim, idx, *, out=None):
        return a.clone() if out is None else out.copy_(a)


def _first_lanes(won, tgt, n):
    lane = torch.arange(tgt.numel(), device=tgt.device)
    big = tgt.numel()
    top = torch.full((n,), big, dtype=torch.int64, device=tgt.device)
    top.scatter_reduce_(0, tgt.long(), torch.where(won, lane, big), "amin")
    return torch.where(top == big, -1, top)


def _post_scan(fn):
    def broken(maps, poses, scan, **kw):
        _, new = fn(maps, poses, scan, **kw)
        lw, _ = fn(new, poses, scan, **kw)
        return lw, new
    return broken


def _unchanged(fn):
    def broken(state, *args, **kw):
        return state
    return broken


def _half(fn):
    def broken(state, *args, **kw):
        new = fn(state, *args, **kw)
        n = new.particles.log_weight.shape[0] // 2
        pn, pb = new.particles, state.particles

        def keep(a, b):
            return torch.cat([a[:n], b[n:]])

        pose = pn.pose.replace(**{f: keep(getattr(pn.pose, f), getattr(pb.pose, f))
                                  for f in ("x", "y", "theta")})
        return new.replace(particles=pn.replace(pose=pose,
                                                log_weight=keep(pn.log_weight, pb.log_weight)))
    return broken


def _shifted(fn):
    def broken(state):
        p = fn(state)
        return p.replace(x=p.x + 0.5)
    return broken


def _patches(fault: str):
    """[(module, name, value)] of `fault`."""
    from slam_tpu_torch.models import rbpf
    from slam_tpu_torch.ops import mapping

    return {
        "unchanged": [(rbpf, "step", _unchanged(rbpf.step))],
        "half": [(rbpf, "step", _half(rbpf.step))],
        "no_map_copy": [(rbpf, "torch", _NoGather())],
        "first_lane": [(mapping, "last_lanes", _first_lanes)],
        "post_scan_hits": [(mapping, "fidelity_measurement_and_mapping",
                            _post_scan(mapping.fidelity_measurement_and_mapping))],
        "answer": [(rbpf, "mean_pose", _shifted(rbpf.mean_pose))],
    }[fault]


FAULTS = ("unchanged", "half", "no_map_copy", "first_lane", "post_scan_hits", "answer")


@contextlib.contextmanager
def planted(fault: str):
    """The RBPF's step broken by `fault` inside the block."""
    patches = _patches(fault)
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, v in patches:
        setattr(m, name, v)
    try:
        yield
    finally:
        for m, name, v in saved:
            setattr(m, name, v)
