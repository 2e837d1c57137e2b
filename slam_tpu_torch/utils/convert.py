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
from slam_tpu_torch.models.mcl import MCLState, init
from slam_tpu_torch.ops.rayfield import RayField


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
              seed: int) -> MCLState:
    """An MCLState from carried-over parts; `seed` stands in for the JAX
    key (the two RNG streams never agree, so tests inject draws)."""
    st = init(seed, p.n, best)
    return st.replace(
        particles=p, best_pose=best, mode_pose=mode, step=int(step),
        updates=int(updates),
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


def ray_field(blocked, lut=None, lut_bins=None, device=None) -> RayField:
    """A RayField from a blocked mask and an optional LUT (see lut_tensor)."""
    return RayField(
        blocked=tensor(blocked, device, torch.bool),
        lut=None if lut is None else lut_tensor(lut, device),
        lut_bins=lut_bins,
    )
