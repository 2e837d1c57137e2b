"""Multi-rank engines on `torch.distributed` (port of `slam_tpu/parallel/`):
particle-sharded MCL and SLAM with the reduce-scatter resampler, the
robot-sharded fleet, and (`parallel.mapshard`) the map-block-sharded SLAM
with the halo-exchanged EDT.

The names below load on first use: the model and op modules import
`parallel.mesh` for their sharding hooks, and the engines import them.
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh",
    "ShardedGridSLAM": "sharded",
    "ShardedMCL": "sharded",
    "ShardedMCLFleet": "fleet",
    "shard_fleet": "fleet",
    "shard_state": "sharded",
    "state_shardings": "sharded",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
