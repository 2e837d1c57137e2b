"""Particle-sharded MCL and grid SLAM over a `parallel.mesh.Mesh` (port of
`slam_tpu/parallel/sharded.py`).

One process per rank. Rank (p, b) of the ('p', 'b') mesh holds particle
shard p (N / |p| particles, as ordinary tensors on its device), splits
each particle's beams over 'b', and holds the replicated map, the
generator (seeded alike on every rank) and the scalar state. The step
functions are the single-device ones of `models/mcl.py` and
`models/slam.py`, given a `Sharding` (`ray_sharding`): every cloud
statistic is then a collective over 'p', the per-beam log weights a psum
over 'b', the motion draws count by global particle index (K1's `i0`), so
a shard draws exactly what the unsharded filter draws for its particles,
and the resampler is the reduce-scatter one (`parallel/resample.py`).
JAX gets the same collectives from GSPMD; here each is explicit.

Each engine steps through its `StepGraphs` (`models/_graph.py`), as JAX
jits each step into one SPMD program: over NCCL one CUDA graph replay a
step on each rank, the collectives captured as NCCL kernels; over gloo
(CPU ranks, or ranks that share one card), whose collectives run on the
host, the same block code eagerly. The backend decides, never a failure:
a capture that fails raises. `engine_graphs(mesh)` makes that choice.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_tpu_torch.core.config import MCLConfig, RaycastConfig, SLAMConfig
from slam_tpu_torch.core.types import Odometry, Particles, Pose, Scan
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.models import slam as slam_mod
from slam_tpu_torch.models._graph import StepGraphs
from slam_tpu_torch.parallel import resample as dist_resample
from slam_tpu_torch.parallel.mesh import Mesh, Sharding


def _resample_fn(mesh: Mesh, cfg: MCLConfig):
    """The reduce-scatter systematic resampler for the sharded engines.
    Multinomial resampling keeps the plain resampler over the gathered
    cloud (`mcl._finish`), and a trivial particle axis (|p| == 1: one
    rank, or a beams-only mesh) keeps the plain resampler: with one shard
    there is nothing to exchange, and its routing would only cost."""
    if cfg.resample != "systematic" or mesh.shape.get("p", 1) == 1:
        return None

    def fn(particles, *, u0=None, generator=None):
        return dist_resample.systematic_resample_sharded(
            mesh, particles, u0=u0, generator=generator)

    return fn


def particle_sharding(mesh: Mesh) -> Sharding:
    """[N, ...] arrays split over the particle axis."""
    return Sharding(mesh, ("p",))


def ray_sharding(mesh: Mesh) -> Sharding:
    """[N, B] ray batches split over both mesh axes."""
    return Sharding(mesh, ("p", "b"))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _map_leaves(fn, tree, particle: bool = False):
    """`fn(leaf, particle)` over the tensors of a state (dataclasses,
    tuples, lists, dicts), `particle` telling the leaves of its `Particles`
    (the particle axis; a grid whose height happens to equal N is not one)
    from the rest; other leaves (generators, ints, None) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, particle)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        inner = particle or isinstance(tree, Particles)
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(fn, getattr(tree, f.name), inner)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, particle) for v in tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, particle) for k, v in tree.items()}
    return tree


def state_shardings(state, mesh: Mesh, n_particles: int):
    """The state's tree with each tensor leaf replaced by its `Sharding`:
    the particle leaves ([N] fields of its `Particles`) split over 'p',
    everything else replicated."""
    p, r = particle_sharding(mesh), replicated(mesh)
    return _map_leaves(lambda t, part: p if part and t.shape[:1] == (n_particles,) else r,
                       state)


def shard_state(state, mesh: Mesh, n_particles: int):
    """This rank's shard of a whole (host or single-device) state: the
    particle leaves sliced to shard `index` of 'p', every leaf moved to the
    mesh's device. Generators and host counters are kept as they are."""
    ax = mesh.axis("p")
    if n_particles % ax.size:
        raise ValueError(f"{n_particles} particles do not split over 'p'={ax.size}")
    l = n_particles // ax.size
    sl = slice(ax.index * l, (ax.index + 1) * l)

    def put(t, part):
        if part and t.shape[:1] == (n_particles,):
            t = t[sl]
        return t.to(mesh.device).contiguous()

    return _map_leaves(put, state)


def _generator(seed: int, mesh: Mesh) -> torch.Generator:
    return mcl_mod.make_generator(seed, mesh.device)


def engine_graphs(mesh: Mesh) -> StepGraphs:
    """A sharded engine's step graphs: captured over NCCL, whose
    collectives a CUDA graph holds; eager blocks over gloo."""
    return StepGraphs(capture=mesh.backend == "nccl")


class ShardedMCL:
    """Multi-rank MCL localization (static map), one particle shard per
    rank of 'p'.

    The beams split over 'b' on the raycast routes. The fused LUT route
    (the lut backend with `lut_beam_stride`, and `step` on CUDA) does not
    split them: every rank of 'b' weighs every beam of its particle shard,
    as JAX's fused route does, so |b| > 1 there repeats the same work on
    each of its ranks. `predict`, `update` and `step` each run as one block
    of `graphs` (`engine_graphs`; the beam march to its whole count).

    Usage (on every rank, after `distributed.initialize`):
        mesh = make_mesh()
        m = ShardedMCL(mesh, cfg, rc)
        state = m.init(h, w)            # this rank's shard
        state = m.predict(state, odom, alphas)
        state = m.update(state, scan, field)
        state = m.step(state, odom, alphas, scan, field)  # fused on CUDA
    """

    def __init__(self, mesh: Mesh, cfg: MCLConfig, rc: RaycastConfig = RaycastConfig()):
        self.mesh = mesh
        self.cfg = cfg
        self.rc = rc
        self.sharding = ray_sharding(mesh)
        self._rfn = _resample_fn(mesh, cfg)
        self.graphs = engine_graphs(mesh)

    def init(self, h: int, w: int, seed: int = 0) -> mcl_mod.MCLState:
        state = mcl_mod.init(
            _generator(seed, self.mesh), self.cfg.n_particles,
            mcl_mod.starting_pose(h, w, self.mesh.device),
        )
        return shard_state(state, self.mesh, self.cfg.n_particles)

    def predict(self, state, odom: Odometry, alphas):
        alphas, rs = tuple(float(a) for a in alphas), self.sharding
        return self.graphs.run(lambda s, o, _: mcl_mod.predict(s, o, alphas, ray_sharding=rs),
                               state, odom, key=("predict", alphas))

    def update(self, state, scan: Scan, blocked):
        """`blocked` (JAX's name): a `RayField` or a raw bool[H, W] mask."""
        cfg, rc, rs, rfn = self.cfg, self.rc, self.sharding, self._rfn
        return self.graphs.run(
            lambda s, _, z: mcl_mod.update(s, z, blocked, cfg, rc, ray_sharding=rs,
                                           resample_fn=rfn, early_exit=False),
            state, scan=scan, key=("update", cfg, rc, id(blocked)), gates=(cfg.resample_every,))

    def step(self, state, odom: Odometry, alphas, scan: Scan, field):
        alphas = tuple(float(a) for a in alphas)
        cfg, rc, rs, rfn = self.cfg, self.rc, self.sharding, self._rfn
        return self.graphs.run(
            lambda s, o, z: mcl_mod.step(s, o, alphas, z, field, cfg, rc, ray_sharding=rs,
                                         resample_fn=rfn, early_exit=False),
            state, odom, scan, key=("step", cfg, rc, alphas, id(field)),
            gates=(cfg.resample_every,))


class ShardedGridSLAM:
    """Multi-rank full grid SLAM: particles sharded over 'p', the log-odds
    grid replicated (every rank applies the same update from the global
    map pose). ``likelihood_field_auto`` runs through
    `slam.AutoTierDispatcher`, whose predicate is the whole cloud's. `step`
    (each forced tier's step under the dispatcher) and `predict` each run
    as one block of `graphs` (`engine_graphs`), a block per phase of the
    resample and map gates, as `GridSLAM` runs them."""

    def __init__(self, mesh: Mesh, cfg: SLAMConfig):
        self.mesh = mesh
        self.cfg = cfg
        self.sharding = rs = ray_sharding(mesh)
        self.graphs = engine_graphs(mesh)

        def make_step(c):
            rfn = _resample_fn(mesh, c.mcl)

            def fn(s, o, z):
                return slam_mod.step(s, o, z, c, ray_sharding=rs, resample_fn=rfn,
                                     early_exit=False)

            return lambda s, o, z: self.graphs.run(
                fn, s, o, z, key=("step", c), gates=(c.mcl.resample_every, c.map_every))

        self._auto = None
        if cfg.mcl.measurement == "likelihood_field_auto":
            self._auto = slam_mod.AutoTierDispatcher(cfg, make_step, ray_sharding=rs)
        else:
            self._step = make_step(cfg)

    def init(self, pose: Pose | None = None, seed: int = 0) -> slam_mod.SLAMState:
        if self._auto is not None:
            self._auto.reset()
        state = slam_mod.init(_generator(seed, self.mesh), self.cfg, pose,
                              device=self.mesh.device)
        return shard_state(state, self.mesh, self.cfg.mcl.n_particles)

    def step(self, state, odom: Odometry, scan: Scan):
        if self._auto is not None:
            return self._auto.step(state, odom, scan)
        return self._step(state, odom, scan)

    def predict(self, state, odom: Odometry):
        cfg, rs = self.cfg, self.sharding
        return self.graphs.run(lambda s, o, _: slam_mod.predict_only(s, o, cfg, ray_sharding=rs),
                               state, odom, key=("predict", cfg))


def gather_particles(mesh: Mesh, state):
    """The whole cloud's (x, y, theta, log_weight), [4, N], from every
    rank's shard of an MCL or SLAM state: an [N]-sized all-gather, for
    checks and checkpoints, not for the step."""
    mcl = getattr(state, "mcl", state)
    p = mcl.particles
    g = mesh.axis("p").all_gather(torch.stack([p.pose.x, p.pose.y, p.pose.theta,
                                               p.log_weight]))
    return g.permute(1, 0, 2).reshape(4, -1)
