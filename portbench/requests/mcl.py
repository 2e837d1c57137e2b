"""Requests to one robot's localizer on a known map, through the port's
`slam_tpu_torch.models.mcl.MCL` (one CUDA graph replay a call on the
card). The kinds a traffic mix sends:

  step  `MCL.step` (predict -> weigh -> estimate -> resample: on the card
        one launch of the fused predict -> LUT-weigh kernel), then the
        read of `mode_pose`
  init  `mcl.init_uniform` over the free cells with the state's own
        generator: the robot wakes up lost; then the read of `mode_pose`

A request ends when the pose is on the host as three floats. The
reference that judges these requests is `reference/judge_mcl.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch.core.config import MCLConfig, RaycastConfig
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.ops import rayfield

# The entry point whose `step` the window drives (faults.py breaks it).
ENTRY = mcl_mod.MCL


def mcl_config(cfg: dict, particles: int) -> MCLConfig:
    return MCLConfig(
        n_particles=particles, meas_stddev=cfg["meas_stddev"], meas_epsilon=cfg["meas_epsilon"],
        scanner_offset=tuple(cfg["scanner_offset"]), lut_beam_stride=cfg["lut_beam_stride"],
        resample=cfg["resample"], resample_every=cfg["resample_every"],
        mode_tau=cfg["mode_tau"])


def raycast_config(cfg: dict) -> RaycastConfig:
    return RaycastConfig(**cfg["raycast"])


def read(pose: Pose):
    """The pose on the host: one copy and one wait."""
    return torch.stack([pose.x, pose.y, pose.theta]).tolist()


class Engine:
    """The localizer of one run: the map's ray field, the engine and its
    state, started at the traffic's first pose."""

    def __init__(self, cfg: dict, cell: dict, blocked: np.ndarray, traffic, seed: int, dev):
        self.cfg, self.dev, self.traffic, self.seed = cfg, dev, traffic, seed
        self.mcfg = mcl_config(cfg, cell["particles"])
        self.rc = raycast_config(cfg)
        self.alphas = tuple(cfg["alphas"])
        self.blocked = torch.from_numpy(blocked).to(dev)
        self.field = rayfield.make_ray_field(self.blocked, self.rc)
        self.engine = mcl_mod.MCL(self.mcfg, self.rc, seed=seed, device=dev)
        self.generator = mcl_mod.make_generator(seed, dev)
        self.angles = traffic.angles
        self.state = None

    def reset(self) -> None:
        """The state at the start of the run: every particle at the
        truth's first pose, the generator at the run's seed. The same
        generator object throughout, so no step graph is captured again."""
        self.generator.manual_seed(self.seed)
        pose = Pose.create(*self.traffic.start_pose(), device=self.dev)
        self.state = mcl_mod.init(self.generator, self.mcfg.n_particles, pose)

    def serve(self, req, keep=None):
        """Serve one request; with `keep` (a list) append to it (kind, the
        state before, the generator's state before, the state after, the
        request). Returns the pose read."""
        st = self.state
        if req.kind == "init":
            gen = st.generator.get_state() if keep is not None else None
            new = mcl_mod.init_uniform(st.generator, self.mcfg.n_particles, self.blocked)
            if keep is not None:
                keep.append(("init", st, gen, new, req))
            pose = read(new.mode_pose)
        else:
            odom = Odometry.create(*req.odom)
            gen = st.generator.get_state() if keep is not None else None
            scan = Scan(angles=self.angles, dists=self.traffic.dists[req.scan])
            new = self.engine.step(st, odom, self.alphas, scan, self.field)
            if keep is not None:
                keep.append(("step", st, gen, new, req))
            pose = read(new.mode_pose)
        self.state = new
        return pose

    def release(self) -> None:
        """Drop the program's map structures and graphs (the states that
        were kept stay)."""
        self.engine = self.field = None
        self.state = None

    # What the per-layer readers call the port's public functions with.
    def predict_weigh(self, state, req):
        scan = Scan(angles=self.angles.to(self.dev), dists=self.traffic.dists[req.scan].to(self.dev))
        odom = Odometry.create(*req.odom)
        seed = torch.tensor([12345], dtype=torch.int64, device=self.dev)
        return lambda: mcl_mod.predict_weigh(state.particles.pose, scan, self.field, self.mcfg,
                                             self.rc, seed, odom, self.alphas)

    def particles(self, state):
        return state.particles

