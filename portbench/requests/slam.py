"""Requests to one robot's SLAM engine, through the port's
`slam_tpu_torch.models.slam.GridSLAM` (one CUDA graph replay a step on the
card). The kind a traffic mix sends:

  slam  `GridSLAM.step` (predict with K1 -> the capped EDT of the frozen
        grid -> the boxed correlative likelihood-field table -> estimate
        -> the log-odds map update from the mode pose -> the resampler on
        every 4th update), then the read of `est_pose`

A request ends when the pose is on the host as three floats. The
reference that judges these requests is `reference/judge_slam.py`.
"""

from __future__ import annotations

import numpy as np

from slam_tpu_torch.core.config import (
    LidarConfig, MapConfig, MCLConfig, MotionConfig, RaycastConfig, SLAMConfig,
)
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.models import slam as slam_mod

from portbench.requests.mcl import read

# The entry point whose `step` the window drives (faults.py breaks it).
ENTRY = slam_mod.GridSLAM


def slam_config(cfg: dict, particles: int) -> SLAMConfig:
    lid = cfg["lidar"]
    gh, gw = cfg["grid"]
    return SLAMConfig(
        mcl=MCLConfig(n_particles=particles, meas_stddev=cfg["meas_stddev"],
                      measurement=cfg["measurement"], lf_table_box=cfg["lf_table_box"],
                      lf_table_bins=cfg["lf_table_bins"], lf_table_dtype=cfg["lf_table_dtype"],
                      lf_z_hit=cfg["lf_z_hit"], lf_z_rand=cfg["lf_z_rand"],
                      lf_table_spread=cfg["lf_table_spread"],
                      lf_table_min_halfwidth=cfg["lf_table_min_halfwidth"],
                      resample_every=cfg["resample_every"], mode_tau=cfg["mode_tau"],
                      scanner_offset=tuple(cfg["scanner_offset"])),
        map=MapConfig(height=gh, width=gw, **cfg["map"]),
        lidar=LidarConfig(start=lid["start"], stop=lid["stop"], max_dist=lid["max_dist"],
                          n_rays=lid["n_rays"]),
        motion=MotionConfig(alphas=tuple(cfg["alphas"])),
        raycast=RaycastConfig(**cfg["raycast"]),
        map_pose=cfg["map_pose"],
        edt_box=cfg["edt_box"],
    )


class Engine:
    """The SLAM engine of one run, its state started at the traffic's
    first pose with an empty grid."""

    def __init__(self, cfg: dict, cell: dict, blocked: np.ndarray, traffic, seed: int, dev):
        self.cfg, self.dev, self.traffic, self.seed = cfg, dev, traffic, seed
        self.scfg = slam_config(cfg, cell["particles"])
        self.engine = slam_mod.GridSLAM(self.scfg, seed=seed, device=dev)
        self.generator = mcl_mod.make_generator(seed, dev)
        self.angles = traffic.angles
        self.state = None

    def reset(self) -> None:
        """The state at the start of the run, on the same generator object
        throughout, so no step graph is captured again."""
        self.generator.manual_seed(self.seed)
        pose = Pose.create(*self.traffic.start_pose(), device=self.dev)
        self.state = slam_mod.init(self.generator, self.scfg, pose, device=self.dev)

    def serve(self, req, keep=None):
        st = self.state
        odom = Odometry.create(*req.odom)
        scan = Scan(angles=self.angles, dists=self.traffic.dists[req.scan])
        gen = st.mcl.generator.get_state() if keep is not None else None
        new = self.engine.step(st, odom, scan)
        if keep is not None:
            keep.append(("slam", st, gen, new, req))
        self.state = new
        return read(new.est_pose)

    def release(self) -> None:
        self.engine = None
        self.state = None

    def particles(self, state):
        return state.mcl.particles
