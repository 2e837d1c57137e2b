"""Core SoA pose/particle types (port of `slam_tpu/core/types.py`).

Dataclasses of tensors with a shared leading batch shape: the same type
describes one pose (shape ()) or N particles (shape (N,)). `replace`
returns a copy with fields swapped; `to(device)` moves every tensor.
"""

from __future__ import annotations

import dataclasses

import torch


def _as_f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


class _TensorDataclass:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device):
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            },
        )


@dataclasses.dataclass
class Pose(_TensorDataclass):
    """SE(2) pose(s): world coordinates, y-up, theta in radians."""

    x: torch.Tensor
    y: torch.Tensor
    theta: torch.Tensor

    @classmethod
    def create(cls, x, y, theta, device=None) -> "Pose":
        return cls(
            x=_as_f32(x, device), y=_as_f32(y, device), theta=_as_f32(theta, device)
        )


@dataclasses.dataclass
class Odometry(_TensorDataclass):
    """Relative motion rotate(rot1) -> translate -> rotate(rot2)
    (`slam/pose.h:19-24`). A host-side command: keep it on the CPU, where
    the CUDA motion kernel reads its values without a device sync."""

    rot1: torch.Tensor
    trans: torch.Tensor
    rot2: torch.Tensor

    @classmethod
    def create(cls, rot1, trans, rot2, device=None) -> "Odometry":
        return cls(
            rot1=_as_f32(rot1, device),
            trans=_as_f32(trans, device),
            rot2=_as_f32(rot2, device),
        )


@dataclasses.dataclass
class Velocity(_TensorDataclass):
    """Differential-drive command: linear v, angular w (`slam/pose.h:26-30`)."""

    v: torch.Tensor
    w: torch.Tensor

    @classmethod
    def create(cls, v, w, device=None) -> "Velocity":
        return cls(v=_as_f32(v, device), w=_as_f32(w, device))


@dataclasses.dataclass
class Particles(_TensorDataclass):
    """SoA particle set: poses plus unnormalized log-weights."""

    pose: Pose
    log_weight: torch.Tensor

    @property
    def n(self) -> int:
        """Particles per filter (the last axis; a fleet stacks [R, N])."""
        return self.pose.x.shape[-1]

    @classmethod
    def uniform_at(cls, pose: Pose, n: int) -> "Particles":
        """All particles at one pose with uniform weights (`slam/mcl.cpp:27-39`)."""
        dev = pose.x.device
        ones = torch.ones((n,), dtype=torch.float32, device=dev)
        return cls(
            pose=Pose(x=ones * pose.x, y=ones * pose.y, theta=ones * pose.theta),
            log_weight=torch.full((n,), -log_f32(n), device=dev),
        )


@dataclasses.dataclass
class Scan(_TensorDataclass):
    """A lidar scan: beam angles (relative to the sensor heading) and
    measured ranges; max-range misses read dist == max_dist exactly."""

    angles: torch.Tensor  # f32[B]
    dists: torch.Tensor  # f32[B]


class Box:
    """Inclusive image-coordinate box (`slam/pose.h:39-45`), host-side."""

    __slots__ = ("start_i", "start_j", "stop_i", "stop_j")

    def __init__(self, start_i: int, start_j: int, stop_i: int, stop_j: int):
        self.start_i = start_i
        self.start_j = start_j
        self.stop_i = stop_i
        self.stop_j = stop_j


def log_f32(n: float) -> float:
    """log(n) rounded as float32 arithmetic rounds it (the JAX package
    takes `jnp.log(n)` in f32; a float64 log can differ in the last bit)."""
    return float(torch.log(torch.tensor(float(n), dtype=torch.float32)))

