"""The RBPF in which every particle carries its own map (port of
`slam_tpu/models/rbpf.py`): the benchmark's per-particle-map deployment,
`rbpf_floorplan_1k`, at 1000 maps of the floor plan.

This is the reference's own algorithm: `Particle{pose, weight, cv::Mat
map}` (`slam/pose.h:32-37`), weighting fused with per-particle mapping
(`slam/mcl.cpp:49-77` -> `slam/raycast.cpp:143-223`), and map copies on
resample (`slam/mcl.cpp:205-227`). It costs N x H x W bytes, which is why
the production engine (`models/slam.py`) shares one grid.

The maps are uint8 quantized P(free) with the reference's multiplicative
clamped updates (floor 1/255, init 128 = 0.5); resampling copies the maps
by one batched gather. `step` = predict (on CUDA the odometry motion
kernel, `ops/motion_cuda.py`; on the CPU its plain version) -> `update`
(fused weight + map, then resample). Randomness comes from the state's
`torch.Generator`, or is injected (`noise=`, `u0=`, `u=`); no step reads
the device from the host. `RBPF.step` runs the step as one block of its
`StepGraphs` (`models/_graph.py`): one CUDA graph replay a step on the
card, as the JAX class jits it (`slam_tpu/models/rbpf.py:123`); the free
`step` stays eager.

Spans (`utils/profiling.py`): `RBPF.step` opens a request; inside it
`motion` (predict), `rbpf.march` and `rbpf.map_write` (each chunk of the
fused weight + map, `ops/mapping.py`), `resample` (the draw and the
indices) and `rbpf.map_copy` (the gather of the resampled maps). Counters
(`profiling.count`, replayed by the step's graph): `rbpf.chunks` and
`rbpf.lanes` (`ops/mapping.py`), `rbpf.map_copy_bytes` (the bytes the
gather writes).
"""

from __future__ import annotations

import dataclasses

import torch

from slam_tpu_torch.core import graph, stats
from slam_tpu_torch.core.config import MCLConfig, RaycastConfig
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Odometry, Particles, Pose, Scan, log_f32
from slam_tpu_torch.models._graph import StepGraphs
from slam_tpu_torch.models.mcl import make_generator
from slam_tpu_torch.ops import mapping, resample
from slam_tpu_torch.ops.motion_cuda import sample_motion_model_odometry_fused
from slam_tpu_torch.utils import profiling

# The motion noise `slam_tpu/models/rbpf.py:63` fixes for this mode.
ALPHAS = (5e-4, 5e-4, 1e-2, 1e-2)


@dataclasses.dataclass
class RBPFState:
    particles: Particles
    maps: torch.Tensor  # u8[N, H, W] per-particle P(free) maps
    generator: torch.Generator
    best_pose: Pose
    best_map_idx: torch.Tensor  # int64 0-d: the best particle's map
    step: int

    def replace(self, **changes) -> "RBPFState":
        return dataclasses.replace(self, **changes)


def init(generator, n_particles: int, pose: Pose, shape) -> RBPFState:
    """All particles at `pose`, uniform-gray maps (`slam/mcl.cpp:27-39`),
    on the pose's device. `generator` is a torch.Generator there, or an
    int seed."""
    h, w = shape
    dev = pose.x.device
    if not isinstance(generator, torch.Generator):
        generator = make_generator(generator, dev)
    return RBPFState(
        particles=Particles.uniform_at(pose, n_particles),
        maps=torch.full((n_particles, h, w), 128, dtype=torch.uint8, device=dev),
        generator=generator,
        best_pose=pose,
        best_map_idx=torch.zeros((), dtype=torch.int64, device=dev),
        step=0,
    )


def update(state: RBPFState, pose: Pose, scan: Scan, cfg: MCLConfig, rc: RaycastConfig,
           u0=None, u=None, maps_out=None) -> RBPFState:
    """The step after predict, for particles moved to `pose`: fused weight
    + map update, then resample the particles AND their maps (the
    reference's map copies, as one gather). `u0` (systematic) or `u`
    (multinomial) injects the resampler's uniforms. `maps_out` (u8 [N, H,
    W], `state.maps` itself allowed: the gather reads the updated copy)
    receives the resampled maps, which are then the new state's."""
    lw, new_maps = mapping.fidelity_measurement_and_mapping(
        state.maps, pose, scan, scanner_offset=cfg.scanner_offset,
        stddev=cfg.meas_stddev, eps=cfg.meas_epsilon, max_dist=rc.max_dist, step=rc.step,
    )
    log_weight = state.particles.log_weight + lw
    best_idx = torch.argmax(log_weight).view(1)
    best_pose = Pose(*(v[0] for v in (pose.x[best_idx], pose.y[best_idx],
                                      pose.theta[best_idx])))
    with profiling.span("resample", log_weight.device):
        if cfg.resample == "multinomial":
            idx = resample.multinomial_indices(log_weight, u=u, generator=state.generator)
        else:
            idx = resample.systematic_indices(log_weight, u0=u0, generator=state.generator)
        idx = idx.long()
    n = log_weight.shape[0]
    # A surviving copy of the best particle; under multinomial resampling
    # the best particle can draw no copy, and then the highest-weight
    # particle that did survive.
    is_best = idx == best_idx
    best_map_idx = torch.where(is_best.any(), torch.argmax(is_best.to(torch.uint8)),
                               torch.argmax(log_weight[idx]))
    with profiling.span("rbpf.map_copy", new_maps.device):
        maps = new_maps[idx] if maps_out is None else torch.index_select(new_maps, 0, idx,
                                                                         out=maps_out)
    graph.count_host(profiling.count, "rbpf.map_copy_bytes", maps.numel())
    return RBPFState(
        particles=Particles(
            pose=Pose(x=pose.x[idx], y=pose.y[idx], theta=pose.theta[idx]),
            log_weight=torch.full((n,), -log_f32(n), device=log_weight.device),
        ),
        maps=maps,
        generator=state.generator,
        best_pose=best_pose,
        best_map_idx=best_map_idx,
        step=state.step + 1,
    )


def step(state: RBPFState, odom: Odometry, scan: Scan, cfg: MCLConfig,
         rc: RaycastConfig, noise=None, u0=None, u=None, maps_out=None) -> RBPFState:
    """One full RBPF step: predict -> fused weight + map -> resample.
    `noise` (CPU only: the CUDA kernel draws its own) injects the motion
    draws, `u0` / `u` the resampler's; `maps_out` is `update`'s."""
    with profiling.span("motion", state.particles.pose.x.device):
        pose = sample_motion_model_odometry_fused(
            odom, state.particles.pose, ALPHAS, generator=state.generator, noise=noise)
    return update(state, pose, scan, cfg, rc, u0=u0, u=u, maps_out=maps_out)


def best_map_prob_free(state: RBPFState) -> torch.Tensor:
    """f32[H, W] P(free) of the best particle's map, what the reference
    renders (`apps/grid_slam.cpp:112`)."""
    return state.maps[state.best_map_idx.view(1)][0].to(torch.float32) / 255.0


def mean_pose(state: RBPFState) -> Pose:
    pp = state.particles.pose
    x, y, th = stats.average_pose(pp.x, pp.y, pp.theta)
    return Pose(x=x, y=y, theta=th)


class RBPF:
    """The RBPF on an explicit `device` (the CUDA card unless the caller
    asks for another, `device="cpu"`); cfg held fixed. `step` runs as one
    block of `graphs`: one CUDA graph replay a step on the card, the same
    block code eagerly on the CPU."""

    def __init__(self, cfg: MCLConfig, rc: RaycastConfig = RaycastConfig(), seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.rc = rc
        self._seed = seed
        self.device = entry_device(device)
        self.graphs = StepGraphs()

    def init(self, pose: Pose, shape) -> RBPFState:
        return init(make_generator(self._seed, self.device), self.cfg.n_particles,
                    pose.to(self.device), shape)

    def step(self, state: RBPFState, odom: Odometry, scan: Scan) -> RBPFState:
        cfg, rc = self.cfg, self.rc
        # The block gathers the resampled maps straight into its buffer.
        with profiling.root("RBPF.step"):
            return self.graphs.run(lambda s, o, z: step(s, o, z, cfg, rc, maps_out=s.maps),
                                   state, odom, scan, key=("step", cfg, rc))
