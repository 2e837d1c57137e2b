"""Multi-robot MCL: R independent filters on one shared map (port of
`slam_tpu/models/fleet.py`).

The JAX package `vmap`s the single-filter step over the robots. The port
stacks them instead: a fleet state is an `MCLState` whose particles are
[R, N], whose estimates and EMAs are [R], and whose `generator` is a tuple
of R generators, robot q's filter drawing from generator q exactly what a
single filter seeded like robot q draws.

On CUDA with the beam measurement on the LUT route, a fleet step is ONE
launch of `csrc/lut_weights.cu` with a robot axis (every robot's predict
and weights; `mcl.predict_weigh`, the launch a single filter's step
makes with R = 1), then the estimate, the EMAs and the resampler batched over
[R, N] on the last axis (`mcl._finish`), so R filters cost about one
filter's launches. With other backends and measurements on CUDA, every
robot predicts in ONE launch of `csrc/motion_odometry.cu` with a robot
axis (seeds [R] drawn in place, as the fused route draws them), then each
robot weighs its row through the single-filter code. On the CPU each robot
predicts and weighs through the single-filter code; that loop is also the
kernels' plain version. The batched finish runs either way.
The auto tier weighs every robot with each tier some robot needs, under
a `cond` a tier, and selects per robot, as JAX's `vmap` of `lax.cond`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_tpu_torch.core.config import MCLConfig, RaycastConfig
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.graph import cond
from slam_tpu_torch.core.types import Odometry, Particles, Pose, Scan, log_f32
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.models._graph import StepGraphs
from slam_tpu_torch.ops import motion_cuda, resample


def fleet_seeds(seed: int, n_robots: int) -> list:
    """Robot q's generator seed: the q-th child of `seed`'s
    `numpy.random.SeedSequence` (the counterpart of JAX's key split)."""
    return [int(c.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for c in np.random.SeedSequence(seed).spawn(n_robots)]


def init_fleet(seed: int, n_robots: int, n_particles: int, poses: Pose) -> mcl_mod.MCLState:
    """Stacked state of R filters on `poses`' device; `poses` has [R]
    fields. Robot q equals `mcl.init(make_generator(fleet_seeds(seed,
    R)[q]), n_particles, poses[q])`."""
    dev = poses.x.device
    gens = tuple(mcl_mod.make_generator(s, dev) for s in fleet_seeds(seed, n_robots))

    def spread(v):
        return v[:, None].expand(n_robots, n_particles).contiguous()

    nan = torch.full((n_robots,), float("nan"), dtype=torch.float32, device=dev)
    return mcl_mod.MCLState(
        particles=Particles(
            pose=Pose(x=spread(poses.x), y=spread(poses.y), theta=spread(poses.theta)),
            log_weight=torch.full((n_robots, n_particles), -log_f32(n_particles), device=dev),
        ),
        generator=gens,
        best_pose=poses,
        mode_pose=poses,
        log_w_slow=nan,
        log_w_fast=nan.clone(),
        step=0,
        updates=0,
    )


def _row(p: Pose, q: int) -> Pose:
    return Pose(x=p.x[q], y=p.y[q], theta=p.theta[q])


def robot(states: mcl_mod.MCLState, q: int) -> mcl_mod.MCLState:
    """Robot q's filter as a single-filter MCLState (views of the fleet's
    tensors; its generator is the fleet's)."""
    p = states.particles
    return states.replace(
        particles=Particles(pose=_row(p.pose, q), log_weight=p.log_weight[q]),
        generator=states.generator[q], best_pose=_row(states.best_pose, q),
        mode_pose=_row(states.mode_pose, q), log_w_slow=states.log_w_slow[q],
        log_w_fast=states.log_w_fast[q])


def fleet_step(states, odoms: Odometry, scans: Scan, field, alphas, cfg: MCLConfig,
               rc: RaycastConfig, u0=None, noise=None, inject=None, early_exit: bool = True):
    """One predict -> update step of every robot. `odoms` has [R] fields
    (host or device), `scans` [R, B]; the map / `field` is shared. `u0`
    ([R], the systematic resampler's draws), `noise` (CPU only, robot q's
    three normal draws at noise[q]) and `inject` ((u, i, j, theta), each
    [R, N]) inject the draws, as in `mcl.step`; `early_exit` as there."""
    gens = states.generator
    pose = states.particles.pose
    r, n = pose.x.shape
    dev = pose.x.device
    if pose.x.is_cuda and noise is not None:
        raise ValueError("injected noise is a CPU-path argument; the CUDA kernels draw their own")
    if mcl_mod._fused_route(pose, field, cfg, rc):
        new_pose, lw = mcl_mod.predict_weigh(pose, scans, field, cfg, rc,
                                             motion_cuda.draw_seeds(gens, dev), odoms, alphas)
        blocked = field.blocked
    else:
        if pose.x.is_cuda:
            new_pose = motion_cuda.launch(motion_cuda.draw_seeds(gens, dev), odoms, pose,
                                          alphas)
            poses = [_row(new_pose, q) for q in range(r)]
        else:
            poses = []
            for q in range(r):
                odom = Odometry(rot1=odoms.rot1[q], trans=odoms.trans[q], rot2=odoms.rot2[q])
                poses.append(motion_cuda.sample_motion_model_odometry_fused(
                    odom, _row(pose, q), alphas, generator=gens[q],
                    noise=None if noise is None else noise[q]))
            new_pose = Pose(*(torch.stack([getattr(p, f) for p in poses])
                              for f in ("x", "y", "theta")))
        rows = [Scan(angles=scans.angles[q], dists=scans.dists[q]) for q in range(r)]
        lw, f = _weigh_rows(poses, rows, field, cfg, rc, early_exit)
        blocked = f.blocked
    states = states.replace(
        particles=states.particles.replace(pose=new_pose), step=states.step + 1)

    # Robot q's draws from generator q, in a single filter's order.
    u = None
    if states.updates % cfg.resample_every == 0:
        if cfg.resample == "systematic" and u0 is None:
            u0 = torch.empty((r,), dtype=torch.float32, device=dev)
            for q, g in enumerate(gens):
                torch.rand((), generator=g, out=u0[q])
        elif cfg.resample == "multinomial":
            u = torch.stack([torch.rand((n,), generator=g, device=dev) for g in gens])
    if cfg.adaptive is not None and inject is None:
        draws = [resample.injection_draws(n, blocked.shape, generator=g, device=dev)
                 for g in gens]
        inject = tuple(torch.stack(d) for d in zip(*draws))
    return mcl_mod._finish(states, lw, cfg, u0, blocked, inject, u=u)


def _weigh_rows(poses, scans, field, cfg: MCLConfig, rc: RaycastConfig, early_exit: bool):
    """(log weights [R, N] of robot q's poses `poses[q]` against
    `scans[q]`, the field as a RayField): each robot through
    `mcl._weigh`. The auto tier is JAX's `lax.cond` under `vmap` (both
    tiers, then a select per robot) with each tier under `core/graph.py:
    cond` on whether any robot needs it: the direct field when some cloud
    is dispersed, the table when some is converged, so a graphed step
    runs a tier only when a robot reads it, with no host read (an eager
    step on the card reads the two predicates)."""
    def tier(c):
        out = [mcl_mod._weigh(p, z, field, c, rc, early_exit=early_exit)
               for p, z in zip(poses, scans)]
        return torch.stack([lw for lw, _ in out]), out[-1][1]

    if cfg.measurement != "likelihood_field_auto":
        return tier(cfg)
    f = mcl_mod.lf_field(field, cfg)
    conv = torch.stack([mcl_mod.auto_converged(p, f, cfg) for p in poses])
    shape = (len(poses), poses[0].x.shape[-1])

    def zeros():
        return torch.zeros(shape, dtype=torch.float32, device=f.blocked.device)

    def forced(name):
        return lambda: tier(dataclasses.replace(cfg, measurement=name))[0]

    lw_t = cond(conv.any(), forced("likelihood_field_table"), zeros, host_read=True)
    lw_d = cond((~conv).any(), forced("likelihood_field"), zeros, host_read=True)
    return torch.where(conv[:, None], lw_t, lw_d), f


class MCLFleet:
    """R reference-API filters advanced in lockstep on one device: the CUDA
    card unless the caller asks for another (`device="cpu"`). `step` runs
    as one block of `graphs` (`models/_graph.py`): one CUDA graph replay a
    fleet step on the card, as the JAX class jits it (`slam_tpu/models/
    fleet.py:61`), registering the R generators; the beam measurement's
    rays run their whole count (`early_exit=False`); the auto tier
    branches inside the block (`_weigh_rows`)."""

    def __init__(self, n_robots: int, cfg: MCLConfig, rc: RaycastConfig = RaycastConfig(),
                 seed: int = 0, device=None):
        self.n_robots = n_robots
        self.cfg = cfg
        self.rc = rc
        self._seed = seed
        self.device = entry_device(device)
        self.graphs = StepGraphs()

    def init(self, poses: Pose):
        return init_fleet(self._seed, self.n_robots, self.cfg.n_particles, poses.to(self.device))

    def step(self, states, odoms: Odometry, scans: Scan, field, alphas):
        cfg, rc = self.cfg, self.rc
        alphas = tuple(float(a) for a in alphas)
        return self.graphs.run(
            lambda s, o, z: fleet_step(s, o, z, field, alphas, cfg, rc, early_exit=False),
            states, odoms, scans,
            key=("fleet", cfg, rc, alphas, id(field)), gates=(cfg.resample_every,))


def mean_poses(states) -> Pose:
    """[R] unweighted circular-mean poses (`mcl.mean_pose` per robot)."""
    pp = states.particles.pose
    return Pose(x=torch.mean(pp.x, dim=-1), y=torch.mean(pp.y, dim=-1),
                theta=torch.atan2(torch.mean(torch.sin(pp.theta), dim=-1),
                                  torch.mean(torch.cos(pp.theta), dim=-1)))
