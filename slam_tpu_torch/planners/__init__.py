from slam_tpu_torch.planners.astar import AStar
from slam_tpu_torch.planners.hastar import HybridAStar
from slam_tpu_torch.planners.rrtstar import RRTStar

__all__ = ["AStar", "HybridAStar", "RRTStar"]
