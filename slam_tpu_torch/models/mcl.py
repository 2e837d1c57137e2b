"""Monte-Carlo localization: the particle filter core (port of
`slam_tpu/models/mcl.py`, beam measurement).

    predict  -> the odometry motion kernel (`ops/motion_cuda.py`) on
                CUDA, its plain PyTorch version on the CPU;
    update   -> beam log weights (on CUDA the fused LUT panorama route
                runs the kernel `ops/lut_weights_cuda.py`), the best /
                sharpened mode estimates, then gated systematic resampling;
    step     -> update(predict(...)); on CUDA with the beam measurement on
                the LUT route, predict and the weights are ONE launch of
                that kernel (bench.py's jitted step), then the rest of
                update.

Functions of an explicit `MCLState`; randomness comes from the state's
`torch.Generator` (on the particles' device), or is injected (`noise=`,
`u0=`) so tests can feed in JAX's own draws. No step syncs with the host:
the data-dependent choices (uninformative-measurement fallback, ESS gate)
are `torch.where` selections, and the every-k resample gate counts
updates on the host.

Measurements: "beam" (raycast or fused LUT route), "likelihood_field"
(direct) and "likelihood_field_table" (boxed correlative table). Not
ported yet: adaptive injection, "likelihood_field_auto", `ray_sharding`,
`resample_fn` and `measurement_fn` (ROADMAP.md Queue 1 items 11 and 14);
they raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from slam_tpu_torch.core import stats
from slam_tpu_torch.core.config import MCLConfig, RaycastConfig
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Odometry, Particles, Pose, Scan
from slam_tpu_torch.ops import edt as edtlib
from slam_tpu_torch.ops import lut_weights_cuda, measurement, rayfield, resample
from slam_tpu_torch.ops.motion_cuda import draw_seed, sample_motion_model_odometry_fused


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


def estimate(pp: Pose, log_weight, lw, mode_tau: float):
    """(best_pose, mode_pose) of particles `pp` with accumulated log weights
    `log_weight` after a measurement that scored them `lw`: the best
    particle (the FIRST maximum, as jnp.argmax) and the softmax(tau *
    log_w)-weighted circular mean. Under an uninformative measurement (the
    top score is a majority tie, within a tolerance RELATIVE to |max|) the
    argmax is arbitrary, so best_pose falls back to the sharpened mean
    (slam_tpu/models/mcl.py:289-312 has the why)."""
    k = torch.argmax(log_weight).view(1)
    best_pose = Pose(
        x=pp.x.index_select(0, k)[0],
        y=pp.y.index_select(0, k)[0],
        theta=pp.theta.index_select(0, k)[0],
    )
    wm = torch.softmax(log_weight * mode_tau, dim=0)
    mode_pose = Pose(
        x=torch.sum(wm * pp.x),
        y=torch.sum(wm * pp.y),
        theta=torch.atan2(
            torch.sum(wm * torch.sin(pp.theta)), torch.sum(wm * torch.cos(pp.theta))
        ),
    )
    max_lw = torch.max(lw)
    tie_tol = torch.clamp(1e-6 * torch.abs(max_lw), min=1e-6)
    top_tie_frac = torch.mean(((max_lw - lw) < tie_tol).to(torch.float32))
    informative = top_tie_frac < 0.5
    return _select(informative, best_pose, mode_pose), mode_pose


def _check_ported(cfg: MCLConfig, **options) -> None:
    for name, v in (*options.items(), ("cfg.adaptive", cfg.adaptive)):
        if v is not None:
            raise NotImplementedError(
                f"{name} is not ported to slam_tpu_torch yet (ROADMAP.md Queue 1)"
            )
    if cfg.measurement == "likelihood_field_auto":
        raise NotImplementedError(
            "measurement='likelihood_field_auto' is not ported to "
            "slam_tpu_torch yet (ROADMAP.md Queue 1 item 11)"
        )


def _weigh(pp: Pose, scan: Scan, field, cfg: MCLConfig, rc: RaycastConfig):
    """Measurement log weights f32[N] of poses `pp` (update's first half)."""
    if cfg.measurement in ("likelihood_field", "likelihood_field_table"):
        if not isinstance(field, rayfield.RayField):
            # A raw mask (SLAM mode): the capped transform the LF pdf
            # resolves, ~5 sigma of distance.
            blocked = torch.as_tensor(field, dtype=torch.bool)
            field = rayfield.RayField(
                blocked=blocked,
                edt=edtlib.edt_capped(blocked, 5.0 * cfg.meas_stddev + 2.0),
            )
        lf = dict(
            rc=rc, scanner_offset=cfg.scanner_offset, stddev=cfg.meas_stddev,
            z_hit=cfg.lf_z_hit, z_rand=cfg.lf_z_rand,
        )
        if cfg.measurement == "likelihood_field_table":
            return measurement.particle_log_weights_lf_table(
                field, pp, scan, table_bins=cfg.lf_table_bins,
                spread_mult=cfg.lf_table_spread,
                min_halfwidth=cfg.lf_table_min_halfwidth,
                table_dtype=cfg.lf_table_dtype, box_size=cfg.lf_table_box, **lf,
            )
        return measurement.particle_log_weights_likelihood_field(field, pp, scan, **lf)
    return measurement.particle_log_weights(
        field, pp, scan,
        rc=rc, scanner_offset=cfg.scanner_offset, stddev=cfg.meas_stddev,
        eps=cfg.meas_epsilon, lut_beam_stride=cfg.lut_beam_stride,
    )


def _finish(state: MCLState, lw, cfg: MCLConfig, u0=None) -> MCLState:
    """Update's second half: add the measurement's log weights `lw` to the
    particles', estimate, then (conditionally) resample."""
    pp = state.particles.pose
    log_weight = state.particles.log_weight + lw
    best_pose, mode_pose = estimate(pp, log_weight, lw, cfg.mode_tau)
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
    _check_ported(cfg, ray_sharding=ray_sharding, resample_fn=resample_fn,
                  measurement_fn=measurement_fn)
    return _finish(state, _weigh(state.particles.pose, scan, field, cfg, rc), cfg, u0)


def _fused_route(pose: Pose, field, cfg: MCLConfig, rc: RaycastConfig) -> bool:
    """Whether `step` predicts and weighs in one kernel launch: particles
    on a CUDA device and the beam measurement on the LUT panorama route
    (the dispatch of `measurement.particle_log_weights`)."""
    return (pose.x.is_cuda and cfg.measurement == "beam"
            and cfg.lut_beam_stride is not None and rc.backend == "lut"
            and isinstance(field, rayfield.RayField) and field.lut is not None)


def step(
    state: MCLState,
    odom: Odometry,
    alphas,
    scan: Scan,
    field,
    cfg: MCLConfig,
    rc: RaycastConfig,
    u0=None,
    noise=None,
) -> MCLState:
    """predict -> update in one call (`bench.py:111-114`'s jitted step).

    On CUDA with the beam measurement on the LUT route, the motion sample
    and the log weights are one launch of `csrc/lut_weights.cu`, seeded
    from the state's generator on the device exactly as `predict` seeds
    K1 (same generator state, same poses); then the rest of `update`.
    Elsewhere it is exactly `update(predict(...))`. `noise` (CPU only)
    and `u0` inject the draws, as in `predict` and `update`."""
    if not _fused_route(state.particles.pose, field, cfg, rc):
        return update(predict(state, odom, alphas, noise=noise), scan, field, cfg, rc, u0=u0)
    _check_ported(cfg)
    if noise is not None:
        raise ValueError(
            "injected noise is a CPU-path argument; the CUDA kernel draws its own"
        )
    pose = state.particles.pose
    new_pose, lw = lut_weights_cuda.launch(
        field.lut, field.lut_bins or field.lut.shape[-1], pose, scan,
        beam_stride=cfg.lut_beam_stride,
        displacement=measurement.scanner_displacement(cfg.scanner_offset),
        max_dist=rc.max_dist, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon,
        motion=(draw_seed(state.generator, pose.x.device), odom, alphas),
    )
    state = state.replace(
        particles=state.particles.replace(pose=new_pose), step=state.step + 1
    )
    return _finish(state, lw, cfg, u0)


def mean_pose(state: MCLState) -> Pose:
    """Unweighted circular-mean pose over particles (`slam/util.cpp:66-85`)."""
    pp = state.particles.pose
    x, y, th = stats.average_pose(pp.x, pp.y, pp.theta)
    return Pose(x=x, y=y, theta=th)


class MCL:
    """Wrapper mirroring the reference's class API (`slam/mcl.h:12-46`)
    with explicit state on `device`: the CUDA card unless the caller asks
    for another (`device="cpu"`)."""

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
        self.device = entry_device(device)

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
