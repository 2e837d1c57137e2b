from slam_tpu_torch.core import grid, stats, types  # noqa: F401
