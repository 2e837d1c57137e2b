"""Requests to one robot's per-particle-map SLAM engine, through the port's
`slam_tpu_torch.models.rbpf.RBPF` (one CUDA graph replay a step on the
card). The kind a traffic mix sends:

  rbpf  `RBPF.step` (predict with K1 -> each particle's beams marched
        through its own map before the scan, weighed and written into a
        copy of it -> systematic resampling of the particles together
        with their maps), then the read of `rbpf.mean_pose`, the pose the
        upstream app draws

A request ends when the pose is on the host as three floats. The
reference that judges these requests is `reference/judge_rbpf.py`.

A step returns a copy of its graph's state buffers (`models/_graph.py`),
so the state a sampled request started from stays as it was: the record
keeps it, and its maps (N x H x W bytes) stay alive with it.
"""

from __future__ import annotations

import numpy as np

from slam_tpu_torch.core.config import MCLConfig, RaycastConfig
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.models import rbpf as rbpf_mod

from portbench.requests.mcl import read

# The entry point whose `step` the window drives.
ENTRY = rbpf_mod.RBPF


def rbpf_configs(cfg: dict):
    """(MCLConfig, RaycastConfig) of the configuration."""
    if tuple(cfg["alphas"]) != rbpf_mod.ALPHAS:
        raise ValueError(f"the RBPF fixes its alphas at {rbpf_mod.ALPHAS}, not {cfg['alphas']}")
    mcfg = MCLConfig(n_particles=cfg["particles"], meas_stddev=cfg["meas_stddev"],
                     meas_epsilon=cfg["meas_epsilon"], scanner_offset=tuple(cfg["scanner_offset"]),
                     resample=cfg["resample"])
    return mcfg, RaycastConfig(**cfg["raycast"])


class Engine:
    """The RBPF of one run, its state started at the traffic's first pose
    with every map at its initial value."""

    def __init__(self, cfg: dict, cell: dict, blocked: np.ndarray, traffic, seed: int, dev):
        self.dev, self.traffic, self.seed = dev, traffic, seed
        self.mcfg, self.rc = rbpf_configs(cfg)
        self.shape = blocked.shape
        self.engine = rbpf_mod.RBPF(self.mcfg, self.rc, seed=seed, device=dev)
        # `RBPF.init`'s generator, kept: a new generator is a new graph.
        self.generator = mcl_mod.make_generator(seed, dev)
        self.angles = traffic.angles
        self.state = None

    def reset(self) -> None:
        """The state at the start of the run, on the same generator object
        throughout, so no step graph is captured again."""
        self.generator.manual_seed(self.seed)
        self.state = None  # the last run's maps go before the new ones come
        pose = Pose.create(*self.traffic.start_pose(), device=self.dev)
        self.state = rbpf_mod.init(self.generator, self.mcfg.n_particles, pose, self.shape)

    def serve(self, req, keep=None):
        st = self.state
        odom = Odometry.create(*req.odom)
        scan = Scan(angles=self.angles, dists=self.traffic.dists[req.scan])
        gen = st.generator.get_state() if keep is not None else None
        new = self.engine.step(st, odom, scan)
        if keep is not None:
            keep.append(("rbpf", st, gen, new, req))
        self.state = new
        return read(rbpf_mod.mean_pose(new))

    def particles(self, state):
        return state.particles

    def release(self) -> None:
        self.engine = None
        self.state = None
