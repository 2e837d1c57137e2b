"""Carry state across from the JAX package: numpy arrays taken from
`slam_tpu` objects become port objects on a device.

The arguments are plain numpy arrays (or anything `np.asarray` takes), so
this module needs no JAX: the caller pulls the arrays out of the JAX
pytrees. A bf16 table arrives as its uint16 bits (numpy has no bfloat16;
`np.asarray(jax_bf16_array).view(np.uint16)`) and is viewed back as
`torch.bfloat16` without changing a bit.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch.core.types import Particles, Pose, Scan
from slam_tpu_torch.models.mcl import MCLState, init, make_generator
from slam_tpu_torch.models.rbpf import RBPFState
from slam_tpu_torch.models.slam import SLAMState
from slam_tpu_torch.ops.rayfield import RayField
from slam_tpu_torch.planners.hastar import HAState, LatticeState
from slam_tpu_torch.planners.rrtstar import RRTState


def tensor(a, device=None, dtype=None) -> torch.Tensor:
    """A numpy array as a tensor on `device` (a copy, never a view)."""
    a = np.array(a, copy=True)
    t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device) if device is not None else t


def pose(x, y, theta, device=None) -> Pose:
    return Pose(*(tensor(v, device, torch.float32) for v in (x, y, theta)))


def particles(x, y, theta, log_weight, device=None) -> Particles:
    return Particles(
        pose=pose(x, y, theta, device),
        log_weight=tensor(log_weight, device, torch.float32),
    )


def scan(angles, dists, device=None) -> Scan:
    return Scan(
        angles=tensor(angles, device, torch.float32),
        dists=tensor(dists, device, torch.float32),
    )


def mcl_state(p: Particles, best: Pose, mode: Pose, step: int, updates: int,
              seed: int, log_w_slow=None, log_w_fast=None) -> MCLState:
    """An MCLState from carried-over parts; `seed` stands in for the JAX
    key (the two RNG streams never agree, so tests inject draws). The
    adaptive-injection EMAs `log_w_slow` / `log_w_fast` (f32 scalars) stay
    NaN, "no update yet", when None."""
    st = init(seed, p.n, best)
    emas = {}
    for name, v in (("log_w_slow", log_w_slow), ("log_w_fast", log_w_fast)):
        if v is not None:
            emas[name] = tensor(np.float32(v), p.pose.x.device)
    return st.replace(
        particles=p, best_pose=best, mode_pose=mode, step=int(step),
        updates=int(updates), **emas,
    )


def rbpf_state(p: Particles, maps, best: Pose, best_map_idx: int, step: int,
               seed: int) -> RBPFState:
    """An RBPFState from the JAX state's parts: the u8[N, H, W] `maps` as
    a numpy array, the particles and best pose as port objects on one
    device, `best_map_idx` and the step counter; `seed` stands in for the
    JAX key, as in `mcl_state`. The maps go to the particles' device."""
    dev = p.pose.x.device
    return RBPFState(
        particles=p, maps=tensor(maps, dev, torch.uint8), generator=make_generator(seed, dev),
        best_pose=best, best_map_idx=torch.tensor(int(best_map_idx), device=dev),
        step=int(step),
    )


def lut_tensor(lut, device=None) -> torch.Tensor:
    """A LUT from numpy: uint16 is read as the bits of a bf16 table, uint8
    stays a fixed-point table."""
    lut = np.asarray(lut)
    if lut.dtype == np.uint16:
        return tensor(lut.view(np.int16), device).view(torch.bfloat16)
    if lut.dtype != np.uint8:
        raise ValueError(f"a LUT is bf16 (as uint16 bits) or uint8, got {lut.dtype}")
    return tensor(lut, device)


def ray_field(blocked, lut=None, lut_bins=None, device=None, edt=None) -> RayField:
    """A RayField from a blocked mask, an optional LUT (see lut_tensor) and
    an optional f32 EDT."""
    return RayField(
        blocked=tensor(blocked, device, torch.bool),
        edt=None if edt is None else tensor(edt, device, torch.float32),
        lut=None if lut is None else lut_tensor(lut, device),
        lut_bins=lut_bins,
    )


def slam_state(grid, edt, p: Particles, best: Pose, mode: Pose, est: Pose,
               step: int, updates: int, seed: int) -> SLAMState:
    """A SLAMState from the JAX state's parts: the f32 log-odds `grid` and
    the `edt` cache (or None) as numpy arrays, the particles and poses as
    port objects (see `particles`, `pose`) on one device, and the counters;
    `seed` stands in for the JAX key, as in `mcl_state`. The grid and EDT
    go to the particles' device."""
    dev = p.pose.x.device
    return SLAMState(
        mcl=mcl_state(p, best, mode, step, updates, seed),
        grid=tensor(grid, dev, torch.float32),
        est_pose=est,
        edt=None if edt is None else tensor(edt, dev, torch.float32),
    )


def _planner_state(cls, dtypes: dict, arrays: dict, device):
    return cls(**{k: tensor(v, device, dtypes[k]) for k, v in arrays.items()})


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def lattice_state(device=None, **arrays) -> LatticeState:
    """A lattice HA* state from the JAX `LatticeState`'s fields as numpy
    arrays (gp, o_idx, o_f, wp, goal_idx, goal_cost, n_expanded, n_lost,
    start_idx), with or without a leading query axis."""
    return _planner_state(LatticeState, dict(
        gp=_I32, o_idx=_I32, o_f=_F32, wp=_I32, goal_idx=_I32, goal_cost=_F32,
        n_expanded=_I32, n_lost=_I32, start_idx=_I32), arrays, device)


def ha_state(device=None, **arrays) -> HAState:
    """A continuous HA* state from the JAX `HAState`'s fields (g, parent,
    px, py, pth, open_f, goal_idx, goal_cost, n_expanded, start_idx)."""
    return _planner_state(HAState, dict(
        g=_F32, parent=_I32, px=_F32, py=_F32, pth=_F32, open_f=_F32, goal_idx=_I32,
        goal_cost=_F32, n_expanded=_I32, start_idx=_I32), arrays, device)


def rrt_state(device=None, **arrays) -> RRTState:
    """An RRT* state from the JAX `RRTState`'s fields (x, y, cost, parent,
    valid, size, best_goal_node, best_goal_cost); the JAX key has no
    counterpart (the port takes its samples injected or from a
    generator)."""
    arrays.pop("key", None)
    return _planner_state(RRTState, dict(
        x=_F32, y=_F32, cost=_F32, parent=_I32, valid=_BOOL, size=_I32,
        best_goal_node=_I32, best_goal_cost=_F32), arrays, device)
