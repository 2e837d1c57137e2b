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
`u0=`, `inject=`) so tests can feed in JAX's own draws. No step syncs with
the host: the data-dependent choices (uninformative-measurement fallback,
ESS gate, the auto tier, the injection ratio) are `torch.where`
selections, and the every-k resample gate counts updates on the host.

Measurements: "beam" (raycast or fused LUT route), "likelihood_field"
(direct), "likelihood_field_table" (boxed correlative table) and
"likelihood_field_auto", which computes BOTH of the last two and selects
per update by `measurement.lf_auto_converged` on the device (JAX's
`lax.cond` has no torch counterpart without a host read; the host-lagged
alternative is `models/slam.py:AutoTierDispatcher`). `MCLConfig.adaptive`
adds augmented-MCL injection over free space (`init_uniform` is the
global-localization start). Not ported: `ray_sharding`, `resample_fn` and
`measurement_fn` (ROADMAP.md Queue 1 item 5, `parallel/`); they raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from slam_tpu_torch.core import stats
from slam_tpu_torch.core.config import MCLConfig, RaycastConfig
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Odometry, Particles, Pose, Scan, log_f32
from slam_tpu_torch.ops import edt as edtlib
from slam_tpu_torch.ops import lut_weights_cuda, measurement, rayfield, resample
from slam_tpu_torch.ops.motion_cuda import (
    draw_seed, odometry_rows, sample_motion_model_odometry_fused,
)


@dataclasses.dataclass
class MCLState:
    particles: Particles
    generator: torch.Generator
    # Best particle (by pre-resample weight) after the latest update.
    best_pose: Pose
    # softmax(tau * log_w)-weighted circular mean, pre-resample.
    mode_pose: Pose
    # Augmented-MCL likelihood EMAs in log space, f32 0-d tensors on the
    # particles' device; NaN until the first update (warm start).
    log_w_slow: torch.Tensor
    log_w_fast: torch.Tensor
    # Predict-frame and update counters (host ints).
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
    nan = torch.full((), math.nan, dtype=torch.float32, device=pose.x.device)
    return MCLState(
        particles=Particles.uniform_at(pose, n_particles),
        generator=generator,
        best_pose=pose,
        mode_pose=pose,
        log_w_slow=nan,
        log_w_fast=nan.clone(),
        step=0,
        updates=0,
    )


def init_uniform(generator, n_particles: int, blocked: torch.Tensor, draws=None) -> MCLState:
    """Global-localization start: particles uniform over the free cells of
    `blocked` with uniform headings (the notebook's initialization, cell
    9), on `blocked`'s device. It injects at ratio 1 into `init`'s
    canvas-center cloud, so a draw that lands on a blocked cell keeps the
    center start pose, as in JAX. `draws` injects (u, i, j, theta) (see
    `resample.injection_draws`)."""
    h, w = blocked.shape
    state = init(generator, n_particles, starting_pose(h, w, blocked.device))
    particles = resample.inject_random_particles(
        state.particles, blocked, 1.0, draws=draws, generator=state.generator)
    return state.replace(particles=particles)


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
    (slam_tpu/models/mcl.py:289-312 has the why). Particles [..., N]: the
    estimates are taken along the last axis, per batch row."""
    k = torch.argmax(log_weight, dim=-1, keepdim=True)
    best_pose = Pose(
        x=pp.x.gather(-1, k)[..., 0],
        y=pp.y.gather(-1, k)[..., 0],
        theta=pp.theta.gather(-1, k)[..., 0],
    )
    wm = torch.softmax(log_weight * mode_tau, dim=-1)
    mode_pose = Pose(
        x=torch.sum(wm * pp.x, dim=-1),
        y=torch.sum(wm * pp.y, dim=-1),
        theta=torch.atan2(torch.sum(wm * torch.sin(pp.theta), dim=-1),
                          torch.sum(wm * torch.cos(pp.theta), dim=-1)),
    )
    max_lw = torch.amax(lw, dim=-1, keepdim=True)
    tie_tol = torch.clamp(1e-6 * torch.abs(max_lw), min=1e-6)
    top_tie_frac = torch.mean(((max_lw - lw) < tie_tol).to(torch.float32), dim=-1)
    informative = top_tie_frac < 0.5
    return _select(informative, best_pose, mode_pose), mode_pose


def _check_ported(**options) -> None:
    for name, v in options.items():
        if v is not None:
            raise NotImplementedError(
                f"{name} is not ported to slam_tpu_torch yet (ROADMAP.md Queue 1 item 5, parallel/)"
            )


LF_MEASUREMENTS = ("likelihood_field", "likelihood_field_table", "likelihood_field_auto")


def _weigh(pp: Pose, scan: Scan, field, cfg: MCLConfig, rc: RaycastConfig):
    """(measurement log weights f32[N] of poses `pp`, the field as a
    RayField): update's first half."""
    if cfg.measurement in LF_MEASUREMENTS:
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

        def table():
            return measurement.particle_log_weights_lf_table(
                field, pp, scan, table_bins=cfg.lf_table_bins,
                spread_mult=cfg.lf_table_spread,
                min_halfwidth=cfg.lf_table_min_halfwidth,
                table_dtype=cfg.lf_table_dtype, box_size=cfg.lf_table_box, **lf,
            )

        def direct():
            return measurement.particle_log_weights_likelihood_field(field, pp, scan, **lf)

        if cfg.measurement == "likelihood_field_table":
            return table(), field
        if cfg.measurement == "likelihood_field":
            return direct(), field
        # Auto tier: the boxed table on a converged cloud, the direct field
        # on a dispersed one. Both are computed and the predicate selects
        # on the device, so the weights equal the forced tier's exactly.
        converged = measurement.lf_auto_converged(
            pp, cfg, field.edt.shape, scanner_offset=cfg.scanner_offset)
        return torch.where(converged, table(), direct()), field
    field = rayfield.as_ray_field(field, rc)
    return measurement.particle_log_weights(
        field, pp, scan,
        rc=rc, scanner_offset=cfg.scanner_offset, stddev=cfg.meas_stddev,
        eps=cfg.meas_epsilon, lut_beam_stride=cfg.lut_beam_stride,
    ), field


def adaptive_emas(log_w_slow, log_w_fast, lw, adaptive):
    """The augmented-MCL EMAs of the mean unnormalized likelihood after a
    measurement `lw` [..., N], in log space, and the capped injection
    ratio: (log_w_slow, log_w_fast, ratio), one per batch row. WARM START:
    the first update (NaN EMAs) seeds both with the observed average, so the ratio
    starts at 0 and answers only to changes (slam_tpu/models/mcl.py:
    335-343 has the measurement behind it); the ratio is capped at
    `adaptive.max_ratio`."""
    log_w_avg = torch.logsumexp(lw, dim=-1) - log_f32(lw.shape[-1])
    first = torch.isnan(log_w_slow)
    out = []
    for prev, a in ((log_w_slow, adaptive.alpha_slow), (log_w_fast, adaptive.alpha_fast)):
        keep = float(torch.log1p(torch.tensor(-a, dtype=torch.float32)))
        out.append(torch.where(first, log_w_avg, torch.logaddexp(
            keep + prev, log_f32(a) + log_w_avg)))
    ratio = torch.clamp(1.0 - torch.exp(out[1] - out[0]), 0.0, adaptive.max_ratio)
    return out[0], out[1], ratio


def _finish(state: MCLState, lw, cfg: MCLConfig, u0=None, blocked=None,
            inject=None, u=None) -> MCLState:
    """Update's second half: add the measurement's log weights `lw` to the
    particles', estimate, then (conditionally) resample and, with
    `cfg.adaptive`, inject over the free cells of `blocked`. `u0` (the
    systematic resampler's draw), `u` (the multinomial resampler's) and
    `inject` (the injection's (u, i, j, theta)) inject the draws. The
    particles may carry a leading batch axis ([R, N], `models/fleet.py`,
    which then passes every draw): each batch row is one filter."""
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
        do_it = (ess <= cfg.ess_threshold * particles.n)[..., None]
        new = resample.resample(
            particles, cfg.resample, u0=u0, u=u, generator=state.generator
        )
        particles = Particles(
            pose=_select(do_it, new.pose, particles.pose),
            log_weight=torch.where(do_it, new.log_weight, particles.log_weight),
        )

    log_w_slow, log_w_fast = state.log_w_slow, state.log_w_fast
    if cfg.adaptive is not None:
        log_w_slow, log_w_fast, ratio = adaptive_emas(log_w_slow, log_w_fast, lw, cfg.adaptive)
        particles = resample.inject_random_particles(
            particles, blocked, ratio[..., None], draws=inject, generator=state.generator)

    return state.replace(
        particles=particles,
        best_pose=best_pose,
        mode_pose=mode_pose,
        log_w_slow=log_w_slow,
        log_w_fast=log_w_fast,
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
    inject=None,
) -> MCLState:
    """Weight against one scan, then (conditionally) resample and inject.

    `field` is a prebuilt `RayField` (static map) or a raw bool[H, W] mask.
    `u0` injects the systematic resampler's uniform draw, `inject` the
    adaptive injection's draws."""
    _check_ported(ray_sharding=ray_sharding, resample_fn=resample_fn,
                  measurement_fn=measurement_fn)
    lw, field = _weigh(state.particles.pose, scan, field, cfg, rc)
    return _finish(state, lw, cfg, u0, field.blocked, inject)


def _fused_route(pose: Pose, field, cfg: MCLConfig, rc: RaycastConfig) -> bool:
    """Whether `step` predicts and weighs in one kernel launch: particles
    on a CUDA device and the beam measurement on the LUT panorama route
    (the dispatch of `measurement.particle_log_weights`)."""
    return (pose.x.is_cuda and cfg.measurement == "beam"
            and cfg.lut_beam_stride is not None and rc.backend == "lut"
            and isinstance(field, rayfield.RayField) and field.lut is not None)


def predict_weigh(pose: Pose, scan: Scan, field, cfg: MCLConfig, rc: RaycastConfig,
                  seed, odom: Odometry, alphas):
    """The fused route's one launch of `csrc/lut_weights.cu`: K1's sampler
    with `seed` (int64 [R]) and `odom` (scalar fields for one filter, [R]
    fields for a fleet, host or device), then the LUT beam weights of
    `scan`. Poses [N] (one filter) or [R, N] (a fleet; the scan [R, B]).
    Returns (the sampled poses, their log weights)."""
    return lut_weights_cuda.launch(
        field.lut, field.lut_bins or field.lut.shape[-1], pose, scan,
        beam_stride=cfg.lut_beam_stride,
        displacement=measurement.scanner_displacement(cfg.scanner_offset),
        max_dist=rc.max_dist, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon,
        motion=(seed, odometry_rows(odom, pose.x.device), alphas),
    )


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
    inject=None,
) -> MCLState:
    """predict -> update in one call (`bench.py:111-114`'s jitted step).

    On CUDA with the beam measurement on the LUT route, the motion sample
    and the log weights are one launch of `csrc/lut_weights.cu`, seeded
    from the state's generator on the device exactly as `predict` seeds
    K1 (same generator state, same poses); then the rest of `update`.
    Elsewhere it is exactly `update(predict(...))`. `noise` (CPU only),
    `u0` and `inject` inject the draws, as in `predict` and `update`."""
    if not _fused_route(state.particles.pose, field, cfg, rc):
        return update(predict(state, odom, alphas, noise=noise), scan, field, cfg, rc,
                      u0=u0, inject=inject)
    if noise is not None:
        raise ValueError(
            "injected noise is a CPU-path argument; the CUDA kernel draws its own"
        )
    pose = state.particles.pose
    new_pose, lw = predict_weigh(pose, scan, field, cfg, rc,
                                 draw_seed(state.generator, pose.x.device), odom, alphas)
    state = state.replace(
        particles=state.particles.replace(pose=new_pose), step=state.step + 1
    )
    return _finish(state, lw, cfg, u0, field.blocked, inject)


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
