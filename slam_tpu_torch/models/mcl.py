"""Monte-Carlo localization: the particle filter core (port of
`slam_tpu/models/mcl.py`, beam measurement).

    predict  -> the fused odometry motion kernel (`ops/motion_cuda.py`) on
                CUDA, its plain PyTorch version on the CPU;
    update   -> beam log weights (the fused LUT panorama route runs the
                CUDA row gather `ops/pano_cuda.py`), the best / sharpened
                mode estimates, then gated systematic resampling.

Functions of an explicit `MCLState`; randomness comes from the state's
`torch.Generator` (on the particles' device), or is injected (`noise=`,
`u0=`) so tests can feed in JAX's own draws. No step syncs with the host:
the data-dependent choices (uninformative-measurement fallback, ESS gate)
are `torch.where` selections, and the every-k resample gate counts
updates on the host.

Not ported yet: adaptive injection, the likelihood-field measurements,
`ray_sharding`, `resample_fn` and `measurement_fn` (ROADMAP.md Queue 1
items 9, 11 and 14); they raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from slam_tpu_torch.core import stats
from slam_tpu_torch.core.config import MCLConfig, RaycastConfig
from slam_tpu_torch.core.types import Odometry, Particles, Pose, Scan
from slam_tpu_torch.ops import measurement, rayfield, resample
from slam_tpu_torch.ops.motion_cuda import sample_motion_model_odometry_fused


@dataclasses.dataclass
class MCLState:
    particles: Particles
    generator: torch.Generator
    # Best particle (by pre-resample weight) after the latest update.
    best_pose: Pose
    # softmax(tau * log_w)-weighted circular mean, pre-resample.
    mode_pose: Pose
    # Predict-frame and update counters (host ints). The adaptive-injection
    # EMAs of the JAX state come with adaptive injection.
    step: int
    updates: int

    def replace(self, **changes) -> "MCLState":
        return dataclasses.replace(self, **changes)


def make_generator(seed: int, device=None) -> torch.Generator:
    g = torch.Generator(device=torch.device(device) if device is not None else "cpu")
    g.manual_seed(int(seed))
    return g


def starting_pose(h: int, w: int, device=None) -> Pose:
    """Canvas-center start (`slam/mcl.cpp:22-25`: {w/2, h/2, pi/2})."""
    return Pose.create(w / 2.0, h / 2.0, math.pi / 2.0, device=device)


def init(generator, n_particles: int, pose: Pose) -> MCLState:
    """All particles at `pose` with uniform weights (`slam/mcl.cpp:27-39`).
    `generator` is a torch.Generator on the pose's device, or an int seed."""
    if not isinstance(generator, torch.Generator):
        generator = make_generator(generator, pose.x.device)
    return MCLState(
        particles=Particles.uniform_at(pose, n_particles),
        generator=generator,
        best_pose=pose,
        mode_pose=pose,
        step=0,
        updates=0,
    )


def predict(state: MCLState, odom: Odometry, alphas, noise=None) -> MCLState:
    """Diffuse every particle through the odometry motion model. `noise`
    (CPU only) injects the three standard-normal draws."""
    pose = sample_motion_model_odometry_fused(
        odom, state.particles.pose, alphas, generator=state.generator, noise=noise
    )
    return state.replace(
        particles=state.particles.replace(pose=pose), step=state.step + 1
    )


def _select(cond, a: Pose, b: Pose) -> Pose:
    return Pose(
        x=torch.where(cond, a.x, b.x),
        y=torch.where(cond, a.y, b.y),
        theta=torch.where(cond, a.theta, b.theta),
    )


def update(
    state: MCLState,
    scan: Scan,
    field,
    cfg: MCLConfig,
    rc: RaycastConfig,
    ray_sharding=None,
    resample_fn=None,
    measurement_fn=None,
    u0=None,
) -> MCLState:
    """Weight against one scan, then (conditionally) resample.

    `field` is a prebuilt `RayField` (static map) or a raw bool[H, W] mask.
    `u0` injects the systematic resampler's uniform draw."""
    for name, v in (
        ("ray_sharding", ray_sharding),
        ("resample_fn", resample_fn),
        ("measurement_fn", measurement_fn),
        ("cfg.adaptive", cfg.adaptive),
    ):
        if v is not None:
            raise NotImplementedError(
                f"{name} is not ported to slam_tpu_torch yet (ROADMAP.md Queue 1)"
            )
    if cfg.measurement != "beam":
        raise NotImplementedError(
            f"measurement={cfg.measurement!r} is not ported to slam_tpu_torch "
            "yet (ROADMAP.md Queue 1 item 9)"
        )
    field = rayfield.as_ray_field(field, rc)
    pp = state.particles.pose
    lw = measurement.particle_log_weights(
        field, pp, scan,
        rc=rc, scanner_offset=cfg.scanner_offset, stddev=cfg.meas_stddev,
        eps=cfg.meas_epsilon, lut_beam_stride=cfg.lut_beam_stride,
    )
    log_weight = state.particles.log_weight + lw

    # Best particle: the FIRST maximum, as jnp.argmax.
    k = torch.argmax(log_weight).view(1)
    best_pose = Pose(
        x=pp.x.index_select(0, k)[0],
        y=pp.y.index_select(0, k)[0],
        theta=pp.theta.index_select(0, k)[0],
    )
    wm = torch.softmax(log_weight * cfg.mode_tau, dim=0)
    mode_pose = Pose(
        x=torch.sum(wm * pp.x),
        y=torch.sum(wm * pp.y),
        theta=torch.atan2(
            torch.sum(wm * torch.sin(pp.theta)), torch.sum(wm * torch.cos(pp.theta))
        ),
    )
    # Uninformative measurement (the top score is a majority tie, within a
    # tolerance RELATIVE to |max|): the argmax is arbitrary, so fall back
    # to the sharpened mean (slam_tpu/models/mcl.py:289-312 has the why).
    max_lw = torch.max(lw)
    tie_tol = torch.clamp(1e-6 * torch.abs(max_lw), min=1e-6)
    top_tie_frac = torch.mean(((max_lw - lw) < tie_tol).to(torch.float32))
    informative = top_tie_frac < 0.5
    best_pose = _select(informative, best_pose, mode_pose)
    particles = state.particles.replace(log_weight=log_weight)

    # Resample when ESS <= ess_threshold * N (1.0 == every update, the
    # reference's behavior) AND on every resample_every-th update. The
    # every-k gate is a host int and skips the work; the ESS gate is a
    # device value and selects.
    if state.updates % cfg.resample_every == 0:
        ess = resample.effective_sample_size(log_weight)
        do_it = ess <= cfg.ess_threshold * particles.n
        new = resample.resample(
            particles, cfg.resample, u0=u0, generator=state.generator
        )
        particles = Particles(
            pose=_select(do_it, new.pose, particles.pose),
            log_weight=torch.where(do_it, new.log_weight, particles.log_weight),
        )

    return state.replace(
        particles=particles,
        best_pose=best_pose,
        mode_pose=mode_pose,
        updates=state.updates + 1,
    )


def mean_pose(state: MCLState) -> Pose:
    """Unweighted circular-mean pose over particles (`slam/util.cpp:66-85`)."""
    pp = state.particles.pose
    x, y, th = stats.average_pose(pp.x, pp.y, pp.theta)
    return Pose(x=x, y=y, theta=th)


class MCL:
    """Wrapper mirroring the reference's class API (`slam/mcl.h:12-46`)
    with explicit state on `device`."""

    def __init__(
        self,
        cfg: MCLConfig,
        rc: RaycastConfig = RaycastConfig(),
        seed: int = 0,
        device=None,
    ):
        self.cfg = cfg
        self.rc = rc
        self._seed = seed
        self.device = torch.device(device) if device is not None else torch.device("cpu")

    def init(self, h: int, w: int) -> MCLState:
        return init(
            make_generator(self._seed, self.device),
            self.cfg.n_particles,
            starting_pose(h, w, self.device),
        )

    def predict(self, state, odom: Odometry, alphas) -> MCLState:
        return predict(state, odom, alphas)

    def update(self, state, scan: Scan, field) -> MCLState:
        return update(state, scan, field, self.cfg, self.rc)

    @staticmethod
    def sensor_position(pose: Pose, scanner_offset) -> Pose:
        return measurement.sensor_pose(pose, scanner_offset)
