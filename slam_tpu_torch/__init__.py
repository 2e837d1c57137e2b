"""slam_tpu_torch: the PyTorch/CUDA port of slam_tpu for NVIDIA Hopper.

Mirrors `slam_tpu`'s layers and names:
  core/      SoA pose/particle types, grid transforms, configs, statistics,
             the entry points' device and the CUDA graph helpers
  ops/       motion sampling, raycasts and ray tables (LUT, CDDT, EDT),
             beam and likelihood-field measurements, mapping, resampling,
             scan matching, spatial queries; the kernels' wrappers
  models/    MCL, grid SLAM, the RBPF, the fleet, the fake lidar, the
             simulator; each step one CUDA graph replay on the card
  planners/  A*, Hybrid A*, RRT*, their searches as CUDA graph replays
  parallel/  the sharded engines on torch.distributed
  utils/     map IO, rendering, checkpoints, logging, metrics, profiling
  apps/      the command-line apps (`tools/`: the measurement scripts;
             `entry.py`: the counterpart of `__graft_entry__.py`)

Plain tensor code is PyTorch; the two TPU Pallas kernels of the MCL step
are hand-written CUDA C++ under `csrc/` (built at first launch by
`ops/_build.py`). A CUDA tensor goes to the kernel, a CPU tensor to the
kernel's plain PyTorch version beside it.

`import slam_tpu_torch` binds `Pose`, `Odometry` and `Velocity`, as the
JAX package does; each subpackage loads on first use. This package never
imports `jax` or `slam_tpu`: the machines it targets need not have JAX
installed.
"""

import importlib

from slam_tpu_torch.core.types import Odometry, Pose, Velocity  # noqa: F401

__version__ = "0.1.0"

_SUBMODULES = ("apps", "core", "entry", "models", "native", "ops", "parallel", "planners",
               "tools", "utils")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
