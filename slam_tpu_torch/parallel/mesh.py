"""The ('p', 'b') device mesh of the sharded engines (port of
`slam_tpu/parallel/mesh.py`).

  * ``'p'``: the particle axis (each rank row holds one particle shard);
  * ``'b'``: the beam axis (splits each particle's beams, whose per-beam
    log weights then sum over 'b'), or the map-row axis of
    `parallel.mapshard`.

A `Mesh` wraps a `torch.distributed.device_mesh.DeviceMesh` of the whole
world, shaped (D / beam_axis, beam_axis), with this rank's `Axis` of each
dim (`parallel._collectives`) and the device its shards live on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from slam_tpu_torch.parallel import distributed
from slam_tpu_torch.parallel._collectives import Axis


class Mesh:
    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.device = device
        self.backend = backend
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        dims = tuple(device_mesh.mesh.shape)
        self.shape = dict(zip(self.axis_names, dims))
        self._axes = {
            name: Axis(name, device_mesh.get_group(name), size,
                       device_mesh.get_local_rank(name), backend)
            for name, size in self.shape.items()
        }

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def __repr__(self):
        return f"Mesh({self.shape}, {self.backend}, {self.device})"


def make_mesh(
    n_devices: Optional[int] = None,
    beam_axis: int = 1,
    axis_names: Tuple[str, str] = ("p", "b"),
) -> Mesh:
    """The (n_devices / beam_axis, beam_axis) mesh of the world that
    `distributed.initialize` joined: `beam_axis` ranks split beams (1 =
    pure particle parallelism), the rest shard particles. `n_devices`
    defaults to the world size and must equal it."""
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices % beam_axis != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by beam_axis={beam_axis}"
        )
    if n_devices != world:
        raise ValueError(f"the mesh spans the world: n_devices={n_devices}, world {world}")
    backend = dist.get_backend()
    dev = distributed.device()
    dm = init_device_mesh(
        "cuda" if backend == "nccl" else "cpu",
        (n_devices // beam_axis, beam_axis),
        mesh_dim_names=tuple(axis_names),
    )
    return Mesh(dm, dev, backend)


class Sharding:
    """The port's `NamedSharding(mesh, P(*spec))`: which mesh dims split an
    array's leading dims (``("p",)`` for particle arrays, ``("p", "b")``
    for [N, B] ray batches, ``()`` for replicated ones). The engines hand
    one to the model functions (`ray_sharding=`), which read the mesh's
    axes from it for their collectives."""

    def __init__(self, mesh: Mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self):
        return f"Sharding({self.mesh!r}, {self.spec})"


def particle_axis(sharding):
    """The 'p' `Axis` of a `Sharding` whose particle axis is split over more
    than one rank, else None (unsharded, or one particle shard: the
    single-device code then runs as it is)."""
    if sharding is None or "p" not in sharding.spec:
        return None
    ax = sharding.mesh.axis("p")
    return ax if ax.size > 1 else None


def beam_axis(sharding):
    """The 'b' `Axis` of a `Sharding` that splits beams over more than one
    rank, else None."""
    if sharding is None or "b" not in sharding.spec:
        return None
    ax = sharding.mesh.axis("b")
    return ax if ax.size > 1 else None


def particle_shard(sharding, n_local: int):
    """(i0, n_global) of this rank's particles under `sharding`: shard
    `index` of the 'p' axis, n_local each; (0, None) when unsharded."""
    if sharding is None or "p" not in sharding.spec:
        return 0, None
    ax = sharding.mesh.axis("p")
    return ax.index * n_local, ax.size * n_local


def split_range(n: int, ax):
    """[lo, hi) of the part of n items that rank `ax.index` of `ax.size`
    takes: contiguous and as even as can be (the first n % size take one
    more)."""
    q, r = divmod(n, ax.size)
    lo = ax.index * q + min(ax.index, r)
    return lo, lo + q + (1 if ax.index < r else 0)
