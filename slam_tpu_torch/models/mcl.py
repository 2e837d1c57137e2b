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
`u0=`, `inject=`) so tests can feed in JAX's own draws. The data-dependent
choices are device values: the uninformative-measurement fallback and the
injection ratio select (`torch.where`); the auto tier and a single
filter's ESS gate are JAX's `lax.cond`s (`core/graph.py:cond`: IF nodes in
a graphed step; elsewhere both branches and a select, but an eager auto
tier on the card reads its predicate once and computes one tier); the
every-k resample gate counts updates on the host. So no step syncs with
the host but the eager auto tier's one read.

Sharding (`slam_tpu_torch/parallel/`): each rank runs these functions on
its own particle shard. With a `ray_sharding` (a `parallel.mesh.Sharding`
over ('p', 'b')) every cloud statistic (the estimate, the ESS gate, the
weight EMAs, the auto tier's predicate) is taken over the whole sharded
particle axis with explicit collectives, the motion draws count by global
particle index, and `resample_fn` replaces the plain resampler (the
engines pass `parallel.resample.systematic_resample_sharded`). Without
one, or with one particle shard, the single-device code runs unchanged.
`measurement_fn(poses, scan) -> lw` replaces the measurement (the
map-sharded engine weighs against a distributed grid).

Measurements: "beam" (raycast or fused LUT route), "likelihood_field"
(direct), "likelihood_field_table" (boxed correlative table) and
"likelihood_field_auto", which runs ONE of the last two under `cond`, as
JAX's `lax.cond` does, picked by `measurement.lf_auto_converged` (the
host-lagged alternative is `models/slam.py:AutoTierDispatcher`).
`MCLConfig.adaptive` adds augmented-MCL injection
over free space (`init_uniform` is the global-localization start).

The `MCL` class runs each `predict`, `update` and `step` as one CUDA graph
replay on the card (`models/_graph.py`), as the JAX class jits them; the
functions here stay eager and are the graphs' reference.

Spans (`utils/profiling.py`): `MCL.predict`, `MCL.update`, `MCL.step` and
`init_uniform` each open a request; the layers inside a step are sibling
spans that time the device, inside a step's graph too: `lut_weights` (the
fused launch with its seed), `motion` (the sampler), `measurement` (the
weights), `estimate` and `resample` (the gated block: ESS, draws and the
resampler).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from slam_tpu_torch.core import stats
from slam_tpu_torch.core.config import MCLConfig, RaycastConfig
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.graph import cond
from slam_tpu_torch.core.types import Odometry, Particles, Pose, Scan, f32_host, log_f32
from slam_tpu_torch.models._graph import StepGraphs
from slam_tpu_torch.ops import edt as edtlib
from slam_tpu_torch.ops import lut_weights_cuda, measurement, rayfield, resample
from slam_tpu_torch.ops.motion_cuda import (
    draw_seed, odometry_rows, sample_motion_model_odometry_fused,
)
from slam_tpu_torch.parallel.mesh import particle_axis, particle_shard
from slam_tpu_torch.utils import profiling


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
    with profiling.root("mcl.init_uniform"):
        h, w = blocked.shape
        state = init(generator, n_particles, starting_pose(h, w, blocked.device))
        particles = resample.inject_random_particles(
            state.particles, blocked, 1.0, draws=draws, generator=state.generator)
        return state.replace(particles=particles)


def predict(state: MCLState, odom: Odometry, alphas, noise=None,
            ray_sharding=None) -> MCLState:
    """Diffuse every particle through the odometry motion model. `noise`
    (CPU only) injects the three standard-normal draws; under
    `ray_sharding` the particles draw by their global index."""
    with profiling.span("motion", state.particles.pose.x.device):
        pose = sample_motion_model_odometry_fused(
            odom, state.particles.pose, alphas, generator=state.generator, noise=noise,
            shard=_shard(ray_sharding, state.particles.pose),
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


def _shard(ray_sharding, pose: Pose):
    """(i0, n_global) of a particle shard, None when unsharded."""
    i0, n = particle_shard(ray_sharding, pose.x.shape[-1])
    return None if n is None else (i0, n)


def estimate_sharded(pp: Pose, log_weight, lw, mode_tau: float, ax):
    """`estimate` and the ESS of a particle shard over the 'p' `Axis` `ax`
    in two collectives: an all-gather of each shard's [6] summary (its
    first best particle and three maxima), then one psum of eight sums.
    The best particle is the first global maximum: the lowest rank among
    the shards that share the top weight, its first local maximum. Returns
    (best_pose, mode_pose, ess)."""
    n = ax.size * log_weight.shape[0]
    k = torch.argmax(log_weight)
    t = log_weight * mode_tau
    row = torch.stack([log_weight[k], torch.amax(t), torch.amax(lw),
                       pp.x[k], pp.y[k], pp.theta[k]])
    g = ax.all_gather(row)  # [D, 6]
    top = torch.argmax(g[:, 0])  # the first maximum: the lowest rank
    best_pose = Pose(x=g[top, 3], y=g[top, 4], theta=g[top, 5])
    m, tmax, max_lw = torch.amax(g[:, 0]), torch.amax(g[:, 1]), torch.amax(g[:, 2])
    e = torch.exp(t - tmax)
    ew = torch.exp(log_weight - m)
    tie_tol = torch.clamp(1e-6 * torch.abs(max_lw), min=1e-6)
    s = ax.psum(torch.stack([
        torch.sum(e), torch.sum(e * pp.x), torch.sum(e * pp.y),
        torch.sum(e * torch.sin(pp.theta)), torch.sum(e * torch.cos(pp.theta)),
        torch.sum(((max_lw - lw) < tie_tol).to(torch.float32)),
        torch.sum(ew), torch.sum(ew * ew),
    ]))
    mode_pose = Pose(x=s[1] / s[0], y=s[2] / s[0],
                     theta=torch.atan2(s[3] / s[0], s[4] / s[0]))
    informative = s[5] / n < 0.5
    ess = s[6] * s[6] / s[7]
    return _select(informative, best_pose, mode_pose), mode_pose, ess


def _resample_gathered(particles: Particles, method: str, ax, *, u0=None, u=None,
                       generator=None) -> Particles:
    """The plain resampler over the whole sharded cloud: the shards'
    particles all-gathered ([N]-sized), resampled with the draws the
    unsharded filter makes, and this rank's slice kept. The sharded
    engines' systematic path avoids it (`parallel/resample.py`)."""
    p = particles.pose
    l = p.x.shape[0]
    g = ax.all_gather(torch.stack([p.x, p.y, p.theta, particles.log_weight]))  # [D, 4, L]
    g = g.permute(1, 0, 2).reshape(4, -1)
    whole = Particles(pose=Pose(x=g[0], y=g[1], theta=g[2]), log_weight=g[3])
    if u is not None:  # this shard's uniforms
        u = ax.all_gather(u).reshape(-1)
    new = resample.resample(whole, method, u0=u0, u=u, generator=generator)
    sl = slice(ax.index * l, (ax.index + 1) * l)
    return Particles(pose=Pose(x=new.pose.x[sl], y=new.pose.y[sl], theta=new.pose.theta[sl]),
                     log_weight=new.log_weight[sl])


LF_MEASUREMENTS = ("likelihood_field", "likelihood_field_table", "likelihood_field_auto")


def lf_field(field, cfg: MCLConfig) -> rayfield.RayField:
    """`field` as the likelihood-field measurements read it: a RayField as
    it is; a raw mask (SLAM mode) with the capped transform the LF pdf
    resolves, ~5 sigma of distance."""
    if isinstance(field, rayfield.RayField):
        return field
    blocked = torch.as_tensor(field, dtype=torch.bool)
    return rayfield.RayField(blocked=blocked,
                             edt=edtlib.edt_capped(blocked, 5.0 * cfg.meas_stddev + 2.0))


def _weigh(pp: Pose, scan: Scan, field, cfg: MCLConfig, rc: RaycastConfig,
           ray_sharding=None, early_exit: bool = True):
    """(measurement log weights f32[N] of poses `pp`, the field as a
    RayField): update's first half. `ray_sharding` splits the beams (or
    the table's heading bins) over its 'b' axis and takes the cloud
    statistics over its 'p' axis; `early_exit` is the beam measurement's
    (`measurement.particle_log_weights`)."""
    if cfg.measurement in LF_MEASUREMENTS:
        field = lf_field(field, cfg)
        lf = dict(
            rc=rc, scanner_offset=cfg.scanner_offset, stddev=cfg.meas_stddev,
            z_hit=cfg.lf_z_hit, z_rand=cfg.lf_z_rand, ray_sharding=ray_sharding,
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
        # on a dispersed one, under JAX's lax.cond (`core/graph.py:cond`):
        # a graphed step runs one tier with no host read; the weights are
        # the forced tier's.
        converged = auto_converged(pp, field, cfg, ray_sharding)
        return cond(converged, table, direct, host_read=True), field
    field = rayfield.as_ray_field(field, rc)
    return measurement.particle_log_weights(
        field, pp, scan,
        rc=rc, scanner_offset=cfg.scanner_offset, stddev=cfg.meas_stddev,
        eps=cfg.meas_epsilon, lut_beam_stride=cfg.lut_beam_stride,
        ray_sharding=ray_sharding, early_exit=early_exit,
    ), field


def auto_converged(pp: Pose, field, cfg: MCLConfig, ray_sharding=None) -> torch.Tensor:
    """The auto tier's predicate of poses `pp` on `field` (a RayField or a
    raw mask), a bool 0-d tensor on their device."""
    shape = field.edt.shape if isinstance(field, rayfield.RayField) else field.shape
    return measurement.lf_auto_converged(pp, cfg, tuple(shape), scanner_offset=cfg.scanner_offset,
                                         ray_sharding=ray_sharding)


def adaptive_emas(log_w_slow, log_w_fast, lw, adaptive, ax=None):
    """The augmented-MCL EMAs of the mean unnormalized likelihood after a
    measurement `lw` [..., N], in log space, and the capped injection
    ratio: (log_w_slow, log_w_fast, ratio), one per batch row. WARM START:
    the first update (NaN EMAs) seeds both with the observed average, so the ratio
    starts at 0 and answers only to changes (slam_tpu/models/mcl.py:
    335-343 has the measurement behind it); the ratio is capped at
    `adaptive.max_ratio`. With a 'p' `Axis` `ax` the average is over the
    whole sharded cloud."""
    if ax is None:
        log_w_avg = torch.logsumexp(lw, dim=-1) - log_f32(lw.shape[-1])
    else:
        m = ax.pmax(torch.amax(lw).reshape(1))[0]
        total = ax.psum(torch.sum(torch.exp(lw - m)).reshape(1))[0]
        log_w_avg = m + torch.log(total) - log_f32(ax.size * lw.shape[-1])
    first = torch.isnan(log_w_slow)
    out = []
    for prev, a in ((log_w_slow, adaptive.alpha_slow), (log_w_fast, adaptive.alpha_fast)):
        keep = f32_host(torch.log1p, -a)
        out.append(torch.where(first, log_w_avg, torch.logaddexp(
            keep + prev, log_f32(a) + log_w_avg)))
    ratio = torch.clamp(1.0 - torch.exp(out[1] - out[0]), 0.0, adaptive.max_ratio)
    return out[0], out[1], ratio


def _finish(state: MCLState, lw, cfg: MCLConfig, u0=None, blocked=None,
            inject=None, u=None, ray_sharding=None, resample_fn=None) -> MCLState:
    """Update's second half: add the measurement's log weights `lw` to the
    particles', estimate, then (conditionally) resample and, with
    `cfg.adaptive`, inject over the free cells of `blocked`. `u0` (the
    systematic resampler's draw), `u` (the multinomial resampler's) and
    `inject` (the injection's (u, i, j, theta)) inject the draws. The
    particles may carry a leading batch axis ([R, N], `models/fleet.py`,
    which then passes every draw): each batch row is one filter. Under
    `ray_sharding` the statistics are global and `resample_fn(particles,
    u0=, generator=)` (else the plain resampler over the gathered cloud)
    selects; injected draws are this shard's."""
    pp = state.particles.pose
    log_weight = state.particles.log_weight + lw
    ax = particle_axis(ray_sharding)
    ess = None
    with profiling.span("estimate", pp.x.device):
        if ax is None:
            best_pose, mode_pose = estimate(pp, log_weight, lw, cfg.mode_tau)
        else:
            best_pose, mode_pose, ess = estimate_sharded(pp, log_weight, lw, cfg.mode_tau, ax)
    particles = state.particles.replace(log_weight=log_weight)

    # Resample when ESS <= ess_threshold * N (1.0 == every update, the
    # reference's behavior) AND on every resample_every-th update. The
    # every-k gate is a host int and skips the work. The ESS gate is a
    # device value: one filter resamples under JAX's lax.cond
    # (`slam_tpu/models/mcl.py:331`, `core/graph.py:cond`) with its draws
    # made first; a fleet's rows and a shard select, as JAX's vmap does.
    if state.updates % cfg.resample_every == 0:
        with profiling.span("resample", pp.x.device):
            n = particles.n if ax is None else ax.size * particles.n
            if ess is None:
                ess = resample.effective_sample_size(log_weight)
            do_it = (ess <= cfg.ess_threshold * n)[..., None]
            if resample_fn is None and ax is None and log_weight.dim() == 1:
                u0, u = resample.resample_draws(log_weight, cfg.resample, u0=u0, u=u,
                                                generator=state.generator)

                def do_resample(x, y, theta, lw):
                    new = resample.resample(Particles(pose=Pose(x=x, y=y, theta=theta),
                                                      log_weight=lw), cfg.resample, u0=u0, u=u)
                    return new.pose.x, new.pose.y, new.pose.theta, new.log_weight

                pp_ = particles.pose
                x, y, theta, lw_ = cond(do_it[0], do_resample, lambda *p: p,
                                        pp_.x, pp_.y, pp_.theta, particles.log_weight)
                particles = Particles(pose=Pose(x=x, y=y, theta=theta), log_weight=lw_)
            else:
                if resample_fn is not None:
                    new = resample_fn(particles, u0=u0, generator=state.generator)
                elif ax is not None:
                    new = _resample_gathered(particles, cfg.resample, ax, u0=u0, u=u,
                                             generator=state.generator)
                else:
                    new = resample.resample(
                        particles, cfg.resample, u0=u0, u=u, generator=state.generator
                    )
                particles = Particles(
                    pose=_select(do_it, new.pose, particles.pose),
                    log_weight=torch.where(do_it, new.log_weight, particles.log_weight),
                )

    log_w_slow, log_w_fast = state.log_w_slow, state.log_w_fast
    if cfg.adaptive is not None:
        log_w_slow, log_w_fast, ratio = adaptive_emas(log_w_slow, log_w_fast, lw,
                                                      cfg.adaptive, ax)
        shard = _shard(ray_sharding, pp)
        if inject is None and shard is not None:
            # The unsharded filter's draws, this shard's slice of them.
            i0, n = shard
            l = pp.x.shape[-1]
            inject = tuple(v[i0:i0 + l] for v in resample.injection_draws(
                n, blocked.shape, generator=state.generator, device=pp.x.device))
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
    early_exit: bool = True,
) -> MCLState:
    """Weight against one scan, then (conditionally) resample and inject.

    `field` is a prebuilt `RayField` (static map) or a raw bool[H, W] mask.
    `ray_sharding` (a `parallel.mesh.Sharding` over ('p', 'b')) marks the
    particles as one shard of a sharded cloud, `resample_fn(particles,
    u0=, generator=)` replaces the resampler, `measurement_fn(poses, scan)
    -> lw` the measurement (`field` is then unused). `u0` injects the
    systematic resampler's uniform draw, `inject` the adaptive injection's
    draws. `early_exit` False casts the beam measurement's rays by the
    march or the sphere trace to their whole count with no host read, to
    the same weights (the entry points' graphed steps)."""
    if measurement_fn is not None:
        if cfg.adaptive is not None:
            raise ValueError(
                "adaptive injection needs the map; it is not supported with "
                "a custom measurement_fn"
            )
        lw = measurement_fn(state.particles.pose, scan)
        return _finish(state, lw, cfg, u0, None, inject, ray_sharding=ray_sharding,
                       resample_fn=resample_fn)
    with profiling.span("measurement", state.particles.pose.x.device):
        lw, field = _weigh(state.particles.pose, scan, field, cfg, rc, ray_sharding, early_exit)
    return _finish(state, lw, cfg, u0, field.blocked, inject, ray_sharding=ray_sharding,
                   resample_fn=resample_fn)


def _fused_route(pose: Pose, field, cfg: MCLConfig, rc: RaycastConfig) -> bool:
    """Whether `step` predicts and weighs in one kernel launch: particles
    on a CUDA device and the beam measurement on the LUT panorama route
    (the dispatch of `measurement.particle_log_weights`)."""
    return (pose.x.is_cuda and cfg.measurement == "beam"
            and cfg.lut_beam_stride is not None and rc.backend == "lut"
            and isinstance(field, rayfield.RayField) and field.lut is not None)


def predict_weigh(pose: Pose, scan: Scan, field, cfg: MCLConfig, rc: RaycastConfig,
                  seed, odom: Odometry, alphas, i0: int = 0):
    """The fused route's one launch of `csrc/lut_weights.cu`: K1's sampler
    with `seed` (int64 [R]) and `odom` (scalar fields for one filter, [R]
    fields for a fleet, host or device), then the LUT beam weights of
    `scan`. Poses [N] (one filter) or [R, N] (a fleet; the scan [R, B]);
    `i0` is the global index of a particle shard's first particle.
    Returns (the sampled poses, their log weights)."""
    return lut_weights_cuda.launch(
        field.lut, field.lut_bins or field.lut.shape[-1], pose, scan,
        beam_stride=cfg.lut_beam_stride,
        displacement=measurement.scanner_displacement(cfg.scanner_offset),
        max_dist=rc.max_dist, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon,
        motion=(seed, odometry_rows(odom, pose.x.device), alphas), i0=i0,
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
    ray_sharding=None,
    resample_fn=None,
    early_exit: bool = True,
) -> MCLState:
    """predict -> update in one call (`bench.py:111-114`'s jitted step).

    On CUDA with the beam measurement on the LUT route, the motion sample
    and the log weights are one launch of `csrc/lut_weights.cu`, seeded
    from the state's generator on the device exactly as `predict` seeds
    K1 (same generator state, same poses); then the rest of `update`.
    Elsewhere it is exactly `update(predict(...))`. `noise` (CPU only),
    `u0` and `inject` inject the draws, as in `predict` and `update`;
    `ray_sharding`, `resample_fn` and `early_exit` as in `update` (the
    fused launch then counts Philox from the shard's first global index)."""
    if not _fused_route(state.particles.pose, field, cfg, rc):
        return update(predict(state, odom, alphas, noise=noise, ray_sharding=ray_sharding),
                      scan, field, cfg, rc, ray_sharding=ray_sharding,
                      resample_fn=resample_fn, u0=u0, inject=inject, early_exit=early_exit)
    if noise is not None:
        raise ValueError(
            "injected noise is a CPU-path argument; the CUDA kernel draws its own"
        )
    pose = state.particles.pose
    shard = _shard(ray_sharding, pose)
    with profiling.span("lut_weights", pose.x.device):
        new_pose, lw = predict_weigh(pose, scan, field, cfg, rc,
                                     draw_seed(state.generator, pose.x.device), odom, alphas,
                                     i0=0 if shard is None else shard[0])
    state = state.replace(
        particles=state.particles.replace(pose=new_pose), step=state.step + 1
    )
    return _finish(state, lw, cfg, u0, field.blocked, inject, ray_sharding=ray_sharding,
                   resample_fn=resample_fn)


def mean_pose(state: MCLState, ray_sharding=None) -> Pose:
    """Unweighted circular-mean pose over particles (`slam/util.cpp:66-85`),
    over the whole sharded cloud under `ray_sharding`."""
    pp = state.particles.pose
    ax = particle_axis(ray_sharding)
    if ax is None:
        x, y, th = stats.average_pose(pp.x, pp.y, pp.theta)
        return Pose(x=x, y=y, theta=th)
    n = ax.size * pp.x.shape[0]
    s = ax.psum(torch.stack([torch.sum(pp.x), torch.sum(pp.y),
                             torch.sum(torch.sin(pp.theta)), torch.sum(torch.cos(pp.theta))]))
    return Pose(x=s[0] / n, y=s[1] / n, theta=torch.atan2(s[2] / n, s[3] / n))


class MCL:
    """Wrapper mirroring the reference's class API (`slam/mcl.h:12-46`)
    with explicit state on `device`: the CUDA card unless the caller asks
    for another (`device="cpu"`).

    `predict`, `update` and `step` each run as one block of `graphs`
    (`models/_graph.py`): one CUDA graph replay a call on the card, as the
    JAX class jits `predict` and `update` (`slam_tpu/models/mcl.py:
    408-409`) and `bench.py:109-112` its step; the same block code eagerly
    on the CPU. The auto measurement tier branches inside the block
    (`cond`), so its update and step are one replay with no host read.
    A block casts the beam measurement's rays to their whole count
    (`early_exit=False`): the free functions' weights, with no host read."""

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
        self.graphs = StepGraphs()

    def init(self, h: int, w: int) -> MCLState:
        return init(
            make_generator(self._seed, self.device),
            self.cfg.n_particles,
            starting_pose(h, w, self.device),
        )

    def predict(self, state, odom: Odometry, alphas) -> MCLState:
        with profiling.root("MCL.predict"):
            alphas = tuple(float(a) for a in alphas)
            return self.graphs.run(lambda s, o, _: predict(s, o, alphas), state, odom,
                                   key=("predict", alphas))

    def update(self, state, scan: Scan, blocked) -> MCLState:
        """Weigh against `scan`, then resample as `cfg` says. `blocked` (JAX's
        name) is a prebuilt `RayField` or a raw bool[H, W] mask, as `update`
        takes it."""
        cfg = self.cfg
        with profiling.root("MCL.update"):
            return self.graphs.run(
                lambda s, _, z: update(s, z, blocked, cfg, self.rc, early_exit=False), state,
                scan=scan, key=("update", cfg, self.rc, id(blocked)),
                gates=(cfg.resample_every,))

    def step(self, state, odom: Odometry, alphas, scan: Scan, field) -> MCLState:
        """predict -> update as one block (`step`: on the card with the
        beam measurement on the LUT route, one fused kernel launch for
        both; with the auto tier, K1 then the tier under `cond`)."""
        with profiling.root("MCL.step"):
            alphas = tuple(float(a) for a in alphas)
            cfg = self.cfg
            return self.graphs.run(lambda s, o, z: step(s, o, alphas, z, field, cfg, self.rc,
                                                        early_exit=False),
                                   state, odom, scan,
                                   key=("step", cfg, self.rc, alphas, id(field)),
                                   gates=(cfg.resample_every,))

    @staticmethod
    def sensor_position(pose: Pose, scanner_offset) -> Pose:
        return measurement.sensor_pose(pose, scanner_offset)
