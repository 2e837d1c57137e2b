"""Full grid SLAM: MCL localization + one shared log-odds occupancy grid
(port of `slam_tpu/models/slam.py`).

One SLAM step = predict(odometry) -> [capped EDT of the frozen grid] ->
weight(scan) -> estimate -> map update from the estimate -> resample. All
particles weight against the same frozen grid, then the grid updates once
(the JAX package's docstring has the design against the reference's
per-particle maps).

Functions of an explicit `SLAMState` on one device; `GridSLAM` wraps them
and runs each step as one CUDA graph replay on the card
(`models/_graph.py`), as the JAX class jits its step. The every-k gates
(resample, map update) count on the host. With `SLAMConfig.edt_box` the
incremental EDT refresh chooses among its three branches on the device
(`ops/edt.py:edt_refresh`, nested `core/graph.py:cond`s), so that step
too is one replay with no host sync. `SLAMConfig.scanmatch` refines the
output estimate on the device (`ops/scanmatch.py`), and
``likelihood_field_auto`` runs through `GridSLAM`'s host-lagged
`AutoTierDispatcher` (in `step` itself, through `mcl.update`'s `cond` on
the predicate).

Under a `ray_sharding` (`slam_tpu_torch/parallel/sharded.py`) each rank
steps its particle shard with the sharded `mcl` functions; the map pose
is a global estimate, so every rank applies the same map update and the
replicated grids stay identical.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from slam_tpu_torch.core import grid as gridlib
from slam_tpu_torch.core.config import SLAMConfig
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.models._graph import StepGraphs
from slam_tpu_torch.ops import edt as edtlib
from slam_tpu_torch.ops import mapping, measurement, rayfield, scanmatch


@dataclasses.dataclass
class SLAMState:
    mcl: mcl_mod.MCLState
    grid: torch.Tensor  # f32[H, W] log-odds of occupancy
    # The engine's output pose estimate after the latest update: the
    # correlative scan-matched pose with `SLAMConfig.scanmatch`, otherwise
    # the best particle.
    est_pose: Pose
    # Derived cache (`SLAMConfig.edt_box`): the capped EDT of
    # blocked_from_logodds(grid), refreshed incrementally each step. None
    # when edt_box is unset. After an out-of-band grid edit re-derive it
    # with `rebuild_edt`.
    edt: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "SLAMState":
        return dataclasses.replace(self, **changes)


def _lf_cap(cfg: SLAMConfig) -> float:
    """EDT cap: the LF pdf only resolves ~5 sigma of distance."""
    return 5.0 * cfg.mcl.meas_stddev + 2.0


def _needs_field(cfg: SLAMConfig) -> bool:
    return cfg.mcl.measurement in mcl_mod.LF_MEASUREMENTS or cfg.scanmatch is not None


def rebuild_edt(state: SLAMState, cfg: SLAMConfig) -> SLAMState:
    """(Re)derive the cached EDT from the grid (init, or after any
    out-of-band grid edit)."""
    if cfg.edt_box is None or not _needs_field(cfg):
        return state.replace(edt=None)
    blocked = gridlib.blocked_from_logodds(state.grid)
    return state.replace(edt=edtlib.edt_capped(blocked, _lf_cap(cfg)))


def init(generator, cfg: SLAMConfig, pose: Optional[Pose] = None, device=None) -> SLAMState:
    """A fresh state: all particles at `pose` (default: the canvas center)
    and an unknown grid, on `device` (default: the pose's). `generator` is
    a torch.Generator on that device, or an int seed."""
    h, w = cfg.map.shape
    if pose is None:
        pose = mcl_mod.starting_pose(h, w, device)
    elif device is not None:
        pose = pose.to(device)
    state = SLAMState(
        mcl=mcl_mod.init(generator, cfg.mcl.n_particles, pose),
        grid=gridlib.uniform_logodds((h, w), device=pose.x.device),
        est_pose=pose,
    )
    return rebuild_edt(state, cfg)


def resolve_map_pose(cfg: SLAMConfig) -> str:
    """``SLAMConfig.map_pose`` as a concrete estimator: ``"auto"`` is
    "best" below 10k particles, "mode" with ``resample_every > 1``, "mean"
    otherwise (the JAX package's docstring has the measurements behind
    the rule)."""
    if cfg.map_pose != "auto":
        return cfg.map_pose
    if cfg.mcl.n_particles < 10_000:
        return "best"
    if cfg.mcl.resample_every > 1:
        return "mode"
    return "mean"


def step(
    state: SLAMState,
    odom: Odometry,
    scan: Scan,
    cfg: SLAMConfig,
    ray_sharding=None,
    resample_fn=None,
    noise=None,
    u0=None,
    early_exit: bool = True,
) -> SLAMState:
    """One full SLAM step (predict + update + [refine] + map + resample).
    `noise` (CPU only) and `u0` inject the motion draws and the
    resampler's uniform. `ray_sharding`, `resample_fn` and `early_exit`
    are `mcl.update`'s: the state is one particle shard of a sharded
    filter; the beam measurement's rays run their whole count."""
    st = mcl_mod.predict(state.mcl, odom, cfg.motion.alphas, noise=noise,
                         ray_sharding=ray_sharding)
    blocked = gridlib.blocked_from_logodds(state.grid)

    # The likelihood-field measurements and the scan-matching refinement
    # read one capped EDT: the state's incremental cache with `edt_box`,
    # else a rebuild of the frozen grid.
    lf_meas = cfg.mcl.measurement in mcl_mod.LF_MEASUREMENTS
    lf_field = None
    if _needs_field(cfg):
        if cfg.edt_box is not None:
            if state.edt is None:
                raise ValueError(
                    "SLAMConfig.edt_box is set but the state carries no EDT "
                    "cache — initialize with slam.init(cfg) or call "
                    "slam.rebuild_edt(state, cfg) after out-of-band grid edits"
                )
            edt = state.edt
        else:
            edt = edtlib.edt_capped(blocked, _lf_cap(cfg))
        lf_field = rayfield.RayField(blocked=blocked, edt=edt)

    st = mcl_mod.update(
        st, scan, lf_field if lf_meas else blocked, cfg.mcl, cfg.raycast,
        ray_sharding=ray_sharding, resample_fn=resample_fn, u0=u0, early_exit=early_exit,
    )

    # The map follows `map_pose`'s estimator; the output estimate is the
    # best particle (the reference keeps the best particle's map), refined
    # by scan matching when configured (and then mapped from with
    # `ScanMatchConfig.mapping`).
    mp = resolve_map_pose(cfg)
    if mp == "mean":
        map_pose = mcl_mod.mean_pose(st, ray_sharding)
    elif mp == "mode":
        map_pose = st.mode_pose
    else:
        map_pose = st.best_pose
    est_pose = st.best_pose
    if cfg.scanmatch is not None:
        est_pose, _ = scanmatch.refine_pose(
            lf_field, st.best_pose, scan, rc=cfg.raycast, cfg=cfg.scanmatch,
            scanner_offset=cfg.mcl.scanner_offset, stddev=cfg.mcl.meas_stddev,
            z_hit=cfg.mcl.lf_z_hit, z_rand=cfg.mcl.lf_z_rand,
        )
        if cfg.scanmatch.mapping:
            map_pose = est_pose

    # `st.updates` is post-increment here, so the first scan (the
    # bootstrap against the empty grid) always maps. A skipped map update
    # leaves the grid, and so the EDT cache, as they were.
    new_grid, new_edt = state.grid, state.edt
    if (st.updates - 1) % cfg.map_every == 0:
        new_grid = mapping.scan_logodds_update(
            state.grid, map_pose, scan,
            scanner_offset=cfg.mcl.scanner_offset, step=cfg.raycast.step,
            max_dist=cfg.raycast.max_dist, l_occ=cfg.map.l_occ,
            l_free=cfg.map.l_free, l_min=cfg.map.l_min, l_max=cfg.map.l_max,
        )
        if cfg.edt_box is not None and lf_field is not None:
            new_edt = edtlib.edt_refresh(
                state.edt, blocked, gridlib.blocked_from_logodds(new_grid),
                max_dist=_lf_cap(cfg), box=cfg.edt_box,
            )
    return SLAMState(mcl=st, grid=new_grid, est_pose=est_pose, edt=new_edt)


def predict_only(state: SLAMState, odom: Odometry, cfg: SLAMConfig,
                 ray_sharding=None) -> SLAMState:
    """Motion-only step for frames without a scan."""
    return state.replace(mcl=mcl_mod.predict(state.mcl, odom, cfg.motion.alphas,
                                             ray_sharding=ray_sharding))


class AutoTierDispatcher:
    """Host-lagged tier dispatch for ``measurement="likelihood_field_auto"``.

    Two steps with a forced measurement, the boxed table and the direct
    likelihood field, and the tier predicate (`measurement.
    lf_auto_converged`) of the engine's state. The predicate of the state
    after every ``check_every``-th step is copied ``non_blocking`` into
    pinned host memory behind a recorded CUDA event; the next `step` call
    waits for that event and reads the flag (`read_tier`), which is the
    only host read, so the step itself never syncs. That is the JAX
    package's lag: the tier of steps k*c + 1 .. k*c + c follows the state
    after step k*c. ``check_every`` defaults to 4, or to 1 under
    `MCLConfig.adaptive`, where injection disperses the cloud in one step
    (`slam_tpu/models/slam.py:245-277` has the trade-off). The first step
    reads the predicate of its input state at once.

    ``make_step(cfg) -> fn(state, odom, scan)`` builds the engine's step
    for a forced-measurement config. ``host_reads`` counts the predicate
    reads and ``tiers`` records the tier each step ran ("table" or
    "direct"). Under ``ray_sharding`` the predicate is the whole sharded
    cloud's, so every rank reads the same tier."""

    def __init__(self, cfg: SLAMConfig, make_step, check_every: Optional[int] = None,
                 ray_sharding=None):
        self._step_table = make_step(dataclasses.replace(
            cfg, mcl=dataclasses.replace(cfg.mcl, measurement="likelihood_field_table")))
        self._step_direct = make_step(dataclasses.replace(
            cfg, mcl=dataclasses.replace(cfg.mcl, measurement="likelihood_field")))
        if check_every is None:
            check_every = 1 if cfg.mcl.adaptive is not None else 4
        self._cfg = cfg
        self._sharding = ray_sharding
        self._flag = None
        self.check_every = check_every
        self.reset()

    def reset(self):
        self._pending = None
        self._tick = 0
        self.converged = None
        self.host_reads = 0
        self.tiers = []

    def _predicate(self, state) -> torch.Tensor:
        cfg = self._cfg
        return measurement.lf_auto_converged(
            state.mcl.particles.pose, cfg.mcl, cfg.map.shape,
            scanner_offset=cfg.mcl.scanner_offset, ray_sharding=self._sharding)

    def read_tier(self, state) -> bool:
        """Settle the tier the next step runs: the pending lagged predicate
        (waiting for its copy), or, before the first step, `state`'s own.
        Call it outside a region that must not sync; `step` calls it."""
        if self.converged is None:
            self.converged = bool(self._predicate(state))
            self.host_reads += 1
        elif self._pending is not None:
            flag, event = self._pending
            if event is not None:
                event.synchronize()
            self.converged = bool(flag)
            self._pending = None
            self.host_reads += 1
        return self.converged

    def step(self, state, odom, scan):
        converged = self.read_tier(state)
        out = (self._step_table if converged else self._step_direct)(state, odom, scan)
        self.tiers.append("table" if converged else "direct")
        self._tick += 1
        if self._tick % self.check_every == 0:
            p = self._predicate(out)
            flag, event = p, None
            if p.is_cuda:
                # One pinned flag, reused: its last copy was read before
                # this step ran.
                if self._flag is None:
                    self._flag = torch.empty((), dtype=torch.bool, pin_memory=True)
                flag = self._flag
                flag.copy_(p, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            self._pending = (flag, event)
        return out


class GridSLAM:
    """The SLAM engine on an explicit `device` (the CUDA card unless the
    caller asks for another, `device="cpu"`); cfg held fixed.
    ``likelihood_field_auto`` runs through `AutoTierDispatcher`.

    `step` and `predict` each run as one block of `graphs`
    (`models/_graph.py`): one CUDA graph replay a call on the card, as the
    JAX class jits them (`slam_tpu/models/slam.py:336-340`), one block per
    phase of the resample and map gates; the dispatcher's forced-tier steps
    too, and a step with `edt_box` (its refresh branches on the device); a
    block casts the beam measurement's rays to their whole count
    (`early_exit=False`, no host read)."""

    def __init__(self, cfg: SLAMConfig, seed: int = 0, device=None):
        self.cfg = cfg
        self._seed = seed
        self.device = entry_device(device)
        self.graphs = StepGraphs()
        self._auto = None
        if cfg.mcl.measurement == "likelihood_field_auto":
            self._auto = AutoTierDispatcher(
                cfg, lambda c: (lambda s, o, z: self._step(s, o, z, c)))

    def _step(self, state: SLAMState, odom: Odometry, scan: Scan, cfg: SLAMConfig) -> SLAMState:
        return self.graphs.run(lambda s, o, z: step(s, o, z, cfg, early_exit=False),
                               state, odom, scan,
                               key=("step", cfg),
                               gates=(cfg.mcl.resample_every, cfg.map_every))

    def init(self, pose: Optional[Pose] = None) -> SLAMState:
        if self._auto is not None:
            self._auto.reset()
        return init(
            mcl_mod.make_generator(self._seed, self.device), self.cfg, pose,
            device=self.device,
        )

    def step(self, state: SLAMState, odom: Odometry, scan: Scan) -> SLAMState:
        if self._auto is not None:
            return self._auto.step(state, odom, scan)
        return self._step(state, odom, scan, self.cfg)

    def predict(self, state: SLAMState, odom: Odometry) -> SLAMState:
        cfg = self.cfg
        return self.graphs.run(lambda s, o, _: predict_only(s, o, cfg), state, odom,
                               key=("predict", cfg))

    def prob_map(self, state: SLAMState) -> torch.Tensor:
        """P(occupied) in [0, 1] from the log-odds grid."""
        return gridlib.log_odds_inv(state.grid)
