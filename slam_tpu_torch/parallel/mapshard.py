"""Map-block sharding: the occupancy grid in row blocks over the mesh's
'b' axis, particles over 'p' (port of `slam_tpu/parallel/mapshard.py`).

No step needs a halo for the grid itself: a ray's first hit on the map is
the least of its first hits over the blocks (cells outside a block read
as free: `ops/raycast.py:raycast_march`'s row-window mode), so the
sharded march is one local march and a `pmin` over 'b'; the mapping
scatter applies, on each block, the updates that land in its rows
(`ops/mapping.py:scan_logodds_update`'s row-window mode) and the blocks
never talk. The likelihood-field tiers read a distributed capped EDT
(`parallel/edt.py`), whose halo exchange is the only neighbour traffic.

Each rank marches every ray of its particle shard to the end of its own
block (no cross-block early exit): more work in all, less map memory per
rank; the trade for maps that do not fit one device.

`MapShardedGridSLAM.step` and `predict` run as blocks of the engine's
`StepGraphs` (`sharded.engine_graphs`: one CUDA graph replay a step over
NCCL, the same block code eagerly over gloo), as JAX jits them;
`eager_step` is the step as the free functions run it.
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.core import grid as gridlib
from slam_tpu_torch.core.config import SLAMConfig
from slam_tpu_torch.core.types import Odometry, Pose, Scan
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.models import slam as slam_mod
from slam_tpu_torch.ops import mapping
from slam_tpu_torch.ops import measurement as meas_ops
from slam_tpu_torch.ops.measurement import beam_log_weights, sensor_pose
from slam_tpu_torch.ops.raycast import raycast_march
from slam_tpu_torch.parallel import edt as dist_edt
from slam_tpu_torch.parallel import sharded as sharded_mod
from slam_tpu_torch.parallel.mesh import Mesh


def grid_rows(mesh: Mesh, h: int, map_axis: str = "b") -> slice:
    """The rows of an h-row map that this rank's block holds."""
    ax = mesh.axis(map_axis)
    if h % ax.size != 0:
        raise ValueError(f"map rows {h} not divisible by '{map_axis}'={ax.size}")
    lh = h // ax.size
    return slice(ax.index * lh, (ax.index + 1) * lh)


def raycast_march_sharded(mesh: Mesh, blocked: torch.Tensor, x, y, theta, *, full_h: int,
                          step: float, max_dist: float, chunk: int = 64,
                          map_axis: str = "b", early_exit: bool = True):
    """The exact march of this rank's rays against the row-block-sharded
    map (`blocked` is this rank's block): a local march, then a min over
    the map axis. Returns (dist, hit) of the whole map. `early_exit` is the
    local march's (`raycast_march`: False marches the whole count with no
    host read)."""
    rows = grid_rows(mesh, full_h, map_axis)
    dist, hit = raycast_march(blocked, x, y, theta, step=step, max_dist=max_dist,
                              chunk=chunk, row_offset=rows.start, full_h=full_h,
                              early_exit=early_exit)
    cand = torch.where(hit, dist, torch.full_like(dist, max_dist))
    dmin = mesh.axis(map_axis).pmin(cand)
    return dmin, dmin < max_dist


def scan_logodds_update_sharded(mesh: Mesh, grid_l: torch.Tensor, pose: Pose, scan: Scan, *,
                                cfg: SLAMConfig, full_h: int, map_axis: str = "b"):
    """The mapping scatter on this rank's block: the updates that land in
    its rows; no communication."""
    rows = grid_rows(mesh, full_h, map_axis)
    return mapping.scan_logodds_update(
        grid_l, pose, scan, scanner_offset=cfg.mcl.scanner_offset, step=cfg.raycast.step,
        max_dist=cfg.raycast.max_dist, l_occ=cfg.map.l_occ, l_free=cfg.map.l_free,
        l_min=cfg.map.l_min, l_max=cfg.map.l_max, row_offset=rows.start, full_h=full_h,
    )


class MapShardedGridSLAM:
    """Full grid SLAM with the log-odds grid row-block-sharded over 'b' and
    particles over 'p'. The step functions are `models/mcl.py`'s, with a
    block-sharded measurement (`measurement_fn`) and the block-local
    mapping scatter.

    Measurement tiers: ``beam`` marches rays per block (min over 'b');
    ``likelihood_field`` and ``likelihood_field_table`` (with the
    mandatory ``lf_table_box``) read a distributed capped EDT
    (`parallel/edt.py`), the table through a padded score window
    assembled from it. A state's ``grid`` is this rank's block."""

    def __init__(self, mesh: Mesh, cfg: SLAMConfig):
        if cfg.scanmatch is not None:
            # The correlative refinement needs a replicated likelihood-field
            # EDT of the WHOLE map — exactly the per-device map footprint
            # this engine exists to avoid. Reject loudly instead of silently
            # pinning est_pose to the best particle (the particle-sharded
            # engine honors cfg.scanmatch; same config must not silently
            # behave differently per engine).
            raise ValueError(
                "MapShardedGridSLAM does not support SLAMConfig.scanmatch: "
                "the refinement requires a replicated full-map EDT, which "
                "defeats map-block sharding. Use ShardedGridSLAM (particle "
                "sharding) for scan-matched estimates, or unset scanmatch."
            )
        meas = cfg.mcl.measurement
        if meas == "likelihood_field_auto":
            raise ValueError(
                "MapShardedGridSLAM does not support "
                "measurement='likelihood_field_auto': pick "
                "'likelihood_field' (dispersed clouds) or "
                "'likelihood_field_table' (tracking) explicitly."
            )
        if meas == "likelihood_field_table" and cfg.mcl.lf_table_box is None:
            raise ValueError(
                "MapShardedGridSLAM's table tier requires "
                "MCLConfig.lf_table_box: the dense full-map table would "
                "materialize a [T, H, W] array per device — exactly the "
                "footprint map-block sharding exists to avoid."
            )
        if cfg.edt_box is not None:
            raise ValueError(
                "MapShardedGridSLAM does not support SLAMConfig.edt_box "
                "(the incremental EDT cache is replicated state). Unset "
                "edt_box, or use ShardedGridSLAM (particle sharding) for "
                "the incremental refresh."
            )
        self.mesh = mesh
        self.cfg = cfg
        self.full_shape = cfg.map.shape
        self.rows = grid_rows(mesh, self.full_shape[0])
        # Particle statistics over 'p'; the beams stay whole ('b' is the
        # map axis here).
        self.sharding = sharded_mod.particle_sharding(mesh)
        self._rfn = sharded_mod._resample_fn(mesh, cfg.mcl)
        self._lf = meas in ("likelihood_field", "likelihood_field_table")
        self.graphs = sharded_mod.engine_graphs(mesh)

    def _measure_march(self, grid_blk, poses: Pose, scan: Scan, early_exit: bool = True):
        cfg = self.cfg
        blocked = gridlib.blocked_from_logodds(grid_blk)
        sp = sensor_pose(poses, cfg.mcl.scanner_offset)
        angles = sp.theta[:, None] + scan.angles[None, :]
        px = sp.x[:, None].expand(angles.shape)
        py = sp.y[:, None].expand(angles.shape)
        dist, hit = raycast_march_sharded(
            self.mesh, blocked, px, py, angles, full_h=self.full_shape[0],
            step=cfg.raycast.step, max_dist=cfg.raycast.max_dist, chunk=cfg.raycast.chunk,
            early_exit=early_exit,
        )
        lw = beam_log_weights(dist, hit, scan.dists[None, :], stddev=cfg.mcl.meas_stddev,
                              max_dist=cfg.raycast.max_dist, eps=cfg.mcl.meas_epsilon)
        return torch.sum(lw, dim=-1)

    def edt(self, grid_blk) -> torch.Tensor:
        """This block's rows of the capped EDT of the whole map."""
        blocked = gridlib.blocked_from_logodds(grid_blk)
        cap = 5.0 * self.cfg.mcl.meas_stddev + 2.0
        return dist_edt.edt_capped_sharded(self.mesh, blocked, max_dist=cap,
                                           full_shape=self.full_shape)

    def _measure_lf(self, grid_blk, poses: Pose, scan: Scan):
        cfg, m = self.cfg, self.cfg.mcl
        edt = self.edt(grid_blk)
        lf = dict(stddev=m.meas_stddev, z_hit=m.lf_z_hit, z_rand=m.lf_z_rand)
        if m.measurement == "likelihood_field":
            return dist_edt.lf_log_weights_sharded(
                self.mesh, edt, poses, scan, rc=cfg.raycast, full_shape=self.full_shape,
                scanner_offset=m.scanner_offset, **lf)
        # The boxed table: the window statistics over the whole cloud, the
        # padded score window (a few MB, whatever the map) assembled from
        # the sharded EDT, then the replicated table build and lookup.
        mu, binw, halfwidth, headings, i0, j0, si, sj = meas_ops.lf_table_window(
            poses, grid_shape=self.full_shape, scanner_offset=m.scanner_offset,
            table_bins=m.lf_table_bins, spread_mult=m.lf_table_spread,
            min_halfwidth=m.lf_table_min_halfwidth, box_size=m.lf_table_box,
            ray_sharding=self.sharding,
        )
        pad = int(math.ceil(cfg.raycast.max_dist)) + 1
        window = dist_edt.lf_window_sharded(
            self.mesh, edt, i0 - pad, j0 - pad, out_shape=(si + 2 * pad, sj + 2 * pad),
            full_shape=self.full_shape, max_dist=cfg.raycast.max_dist, **lf)
        table = meas_ops.lf_score_table(
            edt, scan, headings, rc=cfg.raycast, dtype=m.lf_table_dtype,
            out_shape=(si, sj), lpad=window, **lf)
        prep = (table.permute(1, 2, 0).contiguous(), mu, binw, halfwidth, i0, j0)
        return meas_ops.lf_table_lookup(
            prep, poses, scan, rc=cfg.raycast, scanner_offset=m.scanner_offset,
            z_rand=m.lf_z_rand, grid_shape=self.full_shape)

    def init(self, pose: Pose | None = None, seed: int = 0) -> slam_mod.SLAMState:
        state = slam_mod.init(sharded_mod._generator(seed, self.mesh), self.cfg, pose,
                              device=self.mesh.device).replace(edt=None)
        state = sharded_mod.shard_state(state, self.mesh, self.cfg.mcl.n_particles)
        return state.replace(grid=state.grid[self.rows].contiguous())

    def step(self, state, odom: Odometry, scan: Scan):
        """One step as one block of `graphs` (the beam march to its whole
        count), a block per phase of the resample and map gates."""
        cfg = self.cfg
        return self.graphs.run(lambda s, o, z: self.eager_step(s, o, z, early_exit=False),
                               state, odom, scan, key=("step", cfg),
                               gates=(cfg.mcl.resample_every, cfg.map_every))

    def eager_step(self, state, odom: Odometry, scan: Scan, noise=None, u0=None,
                   early_exit: bool = True):
        """One step, eagerly; `noise` (this shard's, CPU only) and `u0`
        inject the draws, as in `models/slam.py:step`, and `early_exit` is
        the beam march's."""
        cfg = self.cfg
        st = mcl_mod.predict(state.mcl, odom, cfg.motion.alphas, noise=noise,
                             ray_sharding=self.sharding)
        st = mcl_mod.update(
            st, scan, None, cfg.mcl, cfg.raycast, ray_sharding=self.sharding,
            resample_fn=self._rfn, u0=u0,
            measurement_fn=lambda poses, z: (
                self._measure_lf(state.grid, poses, z) if self._lf
                else self._measure_march(state.grid, poses, z, early_exit)),
        )
        mp = slam_mod.resolve_map_pose(cfg)
        if mp == "mean":
            map_pose = mcl_mod.mean_pose(st, self.sharding)
        elif mp == "mode":
            map_pose = st.mode_pose
        else:
            map_pose = st.best_pose
        grid = state.grid
        # Same phase as models/slam.py: st.updates is post-increment, the
        # first update maps.
        if (st.updates - 1) % cfg.map_every == 0:
            grid = scan_logodds_update_sharded(self.mesh, grid, map_pose, scan, cfg=cfg,
                                               full_h=self.full_shape[0])
        return slam_mod.SLAMState(mcl=st, grid=grid, est_pose=st.best_pose)

    def predict(self, state, odom: Odometry):
        cfg, ps = self.cfg, self.sharding
        return self.graphs.run(lambda s, o, _: slam_mod.predict_only(s, o, cfg, ray_sharding=ps),
                               state, odom, key=("predict", cfg))
