"""Helpers for the slam_tpu_torch parity tests.

Inputs are made with numpy from a seed, go through the JAX function (on
the CPU) and its port, and the results come back as numpy arrays for the
comparison. State crosses from JAX to torch as numpy arrays through
`slam_tpu_torch.utils.convert`.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from slam_tpu.models.simulate import synthetic_room
from slam_tpu_torch.utils import convert

# The tier-1 run shares 8 cores among 6 workers.
torch.set_num_threads(2)


def np_(a) -> np.ndarray:
    """A JAX or torch array as numpy (bf16 as float32)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def table_bits(lut) -> np.ndarray:
    """A JAX LUT as numpy: bf16 as its uint16 bits, u8 as is."""
    a = np.asarray(lut)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def torch_table_bits(lut: torch.Tensor) -> np.ndarray:
    """A port LUT as numpy, in the encoding of `table_bits`."""
    if lut.dtype == torch.bfloat16:
        return lut.view(torch.int16).numpy().view(np.uint16)
    return lut.numpy()


def t_pose(p):
    """A JAX Pose as a port Pose."""
    return convert.pose(np.asarray(p.x), np.asarray(p.y), np.asarray(p.theta))


def t_scan(s):
    return convert.scan(np.asarray(s.angles), np.asarray(s.dists))


def t_field(f):
    """A JAX RayField (march or lut) as a port RayField."""
    lut = None if f.lut is None else table_bits(f.lut)
    return convert.ray_field(np.asarray(f.blocked), lut, f.lut_bins)


def room(h: int = 96, w: int = 128) -> np.ndarray:
    return synthetic_room(h, w)


def random_poses(rng, n: int, blocked: np.ndarray, margin: float = 3.0):
    """f32 (x, y, theta) of n poses in the map's interior."""
    h, w = blocked.shape
    x = rng.uniform(margin, w - margin, n).astype(np.float32)
    y = rng.uniform(margin, h - margin, n).astype(np.float32)
    th = rng.uniform(-math.pi, math.pi, n).astype(np.float32)
    return x, y, th


def jax_noise(key, shape):
    """The three normal draws `slam_tpu.ops.motion` takes from `key`, as
    torch tensors."""
    k1, k2, k3 = jax.random.split(key, 3)
    return tuple(convert.tensor(jax.random.normal(k, shape)) for k in (k1, k2, k3))


def assert_angles_close(a, b, atol):
    d = np.abs((np.asarray(a, np.float64) - np.asarray(b, np.float64) + np.pi)
               % (2 * np.pi) - np.pi)
    assert d.max() <= atol, f"angle diff {d.max()} > {atol}"
