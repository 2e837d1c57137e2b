"""A multi-robot MCL fleet with its robots spread over the ranks (port of
`slam_tpu/parallel/fleet.py`).

Robots share only the read-only map, so the fleet axis needs no
collective: rank p of the mesh's 'p' axis holds robots [p R/P, (p+1) R/P)
with their generators and advances them with `models/fleet.py:fleet_step`,
on CUDA one `lut_weights` launch with gridDim.y = R/P. Contrast
`ShardedMCL`, which shards ONE filter's particles and needs the
reduce-scatter resampler.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_tpu_torch.core.config import MCLConfig, RaycastConfig
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import fleet as fleet_mod
from slam_tpu_torch.parallel.mesh import Mesh
from slam_tpu_torch.parallel.sharded import engine_graphs


def robot_range(mesh: Mesh, n_robots: int) -> slice:
    """The robots this rank holds."""
    ax = mesh.axis("p")
    if n_robots % ax.size:
        raise ValueError(f"n_robots {n_robots} not divisible by mesh 'p' axis {ax.size}")
    per = n_robots // ax.size
    return slice(ax.index * per, (ax.index + 1) * per)


def shard_fleet(mesh: Mesh, states, n_robots: int):
    """This rank's robots of a whole [R, ...]-stacked fleet state, on the
    mesh's device (robot leaves and the generator tuple sliced)."""
    sl = robot_range(mesh, n_robots)

    def put(v):
        if isinstance(v, torch.Tensor):
            return v[sl].to(mesh.device).contiguous() if v.dim() >= 1 and v.shape[0] == n_robots \
                else v.to(mesh.device)
        if isinstance(v, tuple) and len(v) == n_robots:
            return v[sl]
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return dataclasses.replace(v, **{f.name: put(getattr(v, f.name))
                                             for f in dataclasses.fields(v)})
        return v

    return put(states)


class ShardedMCLFleet(fleet_mod.MCLFleet):
    """`MCLFleet` whose robots are spread over the 'p' axis. `n_robots` must
    be divisible by it. `step` takes the whole fleet's odometry [R] and
    scans [R, B], slices this rank's robots and steps them through
    `MCLFleet.step`'s block (`sharded.engine_graphs`: one CUDA graph replay
    over NCCL, eager over gloo); it returns this rank's robots."""

    def __init__(self, mesh: Mesh, n_robots: int, cfg: MCLConfig,
                 rc: RaycastConfig = RaycastConfig(), seed: int = 0):
        robot_range(mesh, n_robots)
        super().__init__(n_robots, cfg, rc, seed, device=mesh.device)
        self.mesh = mesh
        self.robots = robot_range(mesh, n_robots)
        self.graphs = engine_graphs(mesh)

    def init(self, poses: Pose):
        return shard_fleet(self.mesh, super().init(poses), self.n_robots)

    def step(self, states, odoms: Odometry, scans: Scan, field, alphas):
        sl = self.robots

        def mine(v):
            v = torch.as_tensor(v)
            return v[sl] if v.dim() >= 1 and v.shape[0] == self.n_robots else v

        odoms = Odometry(rot1=mine(odoms.rot1), trans=mine(odoms.trans), rot2=mine(odoms.rot2))
        scans = Scan(angles=mine(scans.angles).to(self.mesh.device),
                     dists=mine(scans.dists).to(self.mesh.device))
        return super().step(states, odoms, scans, field, alphas)
