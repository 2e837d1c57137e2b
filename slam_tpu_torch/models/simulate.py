"""Closed-loop simulation harness: scripted odometry + fake lidar + filter
(port of `slam_tpu/models/simulate.py`).

Re-creates the `apps/grid_slam.cpp` main loop headlessly: ground truth
advances through the same noisy motion model the filter predicts with, the
fake lidar scans the ground-truth map from the sensor pose, and the filter
consumes (odometry, scan) pairs. Each run takes a `device`: the CUDA card
unless the caller asks for another (`device="cpu"`), like the entry
points. The ground truth's noise comes from a generator of its own,
seeded `seed + 1` (the JAX package splits its key instead; the two
streams never agree, so runs are compared by their error bounds). The
harness reads each step's estimates on the host, as the JAX one does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from slam_tpu_torch.core.config import SLAMConfig
from slam_tpu_torch.core.device import entry_device
from slam_tpu_torch.core.types import Odometry, Pose
from slam_tpu_torch.models import fake_lidar
from slam_tpu_torch.models import mcl as mcl_mod
from slam_tpu_torch.models import slam as slam_mod
from slam_tpu_torch.ops import edt as edtlib
from slam_tpu_torch.ops import motion, rayfield, scanmatch
from slam_tpu_torch.ops.measurement import sensor_pose


def forward_arc_commands(n_steps: int, trans: float = 2.5, rot: float = 0.0):
    """Constant forward(+turn) odometry commands, host-side (the
    benchmark's fixed pattern, `benchmark/mcl.cpp:58-64`)."""
    return [Odometry.create(rot / 2, trans, rot / 2) for _ in range(n_steps)]


@dataclasses.dataclass
class SimResult:
    est_xy: np.ndarray  # [T, 2] estimated (mean pose) trajectory
    best_xy: np.ndarray  # [T, 2] best-particle trajectory
    gt_xy: np.ndarray  # [T, 2] ground-truth trajectory
    final_state: object
    # [T, 2] engine output-estimate trajectory (the scan-matched pose with
    # SLAMConfig.scanmatch); None for localization runs without it.
    sm_xy: Optional[np.ndarray] = None


def _xy(p: Pose):
    return [float(p.x), float(p.y)]


def _scanner(gt_blocked, cfg: SLAMConfig, generator):
    def scan(sensor: Pose):
        return fake_lidar.scan(gt_blocked, sensor, cfg.lidar, cfg.raycast,
                               generator=generator if cfg.lidar.noise_stddev > 0 else None)
    return scan


def run_localization(
    gt_blocked,
    cfg: SLAMConfig,
    commands: List[Odometry],
    start_pose: Pose,
    seed: int = 0,
    update_every: int = 1,
    field=None,
    device=None,
) -> SimResult:
    """MCL against the known (static) map `gt_blocked` (bool[H, W], numpy
    or tensor). Pass a prebuilt `field` to reuse a LUT / EDT. With
    `cfg.scanmatch`, the mean pose of each update frame is refined
    against the latest scan (`sm_xy`)."""
    dev = entry_device(device)
    gt_blocked = torch.as_tensor(gt_blocked, dtype=torch.bool).to(dev)
    start_pose = start_pose.to(dev)
    g_gt = mcl_mod.make_generator(seed + 1, dev)
    state = mcl_mod.init(mcl_mod.make_generator(seed, dev), cfg.mcl.n_particles, start_pose)
    if field is None:
        field = rayfield.make_ray_field(gt_blocked, cfg.raycast)

    refine = None
    if cfg.scanmatch is not None:
        sm_field = field
        if sm_field.edt is None:
            sm_field = rayfield.RayField(blocked=gt_blocked, edt=edtlib.edt_capped(
                gt_blocked, 5.0 * cfg.mcl.meas_stddev + 2.0))

        def refine(p, z):
            return scanmatch.refine_pose(
                sm_field, p, z, rc=cfg.raycast, cfg=cfg.scanmatch,
                scanner_offset=cfg.mcl.scanner_offset, stddev=cfg.mcl.meas_stddev,
                z_hit=cfg.mcl.lf_z_hit, z_rand=cfg.mcl.lf_z_rand)[0]

    scan_fn = _scanner(gt_blocked, cfg, g_gt)
    gt_pose = start_pose
    est_xy, best_xy, gt_xy, sm_xy = [], [], [], []
    scan = None
    for t, odom in enumerate(commands):
        state = mcl_mod.predict(state, odom, cfg.motion.alphas)
        gt_pose = motion.sample_motion_model_odometry(odom, gt_pose, cfg.motion.alphas,
                                                      generator=g_gt)
        updated = (t + 1) % update_every == 0
        if updated:
            scan = scan_fn(sensor_pose(gt_pose, cfg.mcl.scanner_offset))
            state = mcl_mod.update(state, scan, field, cfg.mcl, cfg.raycast)
        mp = mcl_mod.mean_pose(state)
        est_xy.append(_xy(mp))
        best_xy.append(_xy(state.best_pose))
        gt_xy.append(_xy(gt_pose))
        # Refine only on update frames: between updates the latest scan is
        # stale.
        if refine is not None and updated and scan is not None:
            sm_xy.append(_xy(refine(mp, scan)))
        else:
            sm_xy.append(est_xy[-1])
    return SimResult(
        est_xy=np.array(est_xy), best_xy=np.array(best_xy), gt_xy=np.array(gt_xy),
        final_state=state, sm_xy=np.array(sm_xy) if refine is not None else None,
    )


def _slam_record(state, gt: Pose, est_xy, best_xy, sm_xy, gt_xy):
    est_xy.append(_xy(mcl_mod.mean_pose(state.mcl)))
    best_xy.append(_xy(state.mcl.best_pose))
    sm_xy.append(_xy(state.est_pose))
    gt_xy.append(_xy(gt))


def run_slam(
    gt_blocked,
    cfg: SLAMConfig,
    commands: List[Odometry],
    start_pose: Pose,
    seed: int = 0,
    update_every: int = 1,
    device=None,
) -> SimResult:
    """Full SLAM: unknown map, scans against the ground truth, mapping from
    the estimated pose."""
    engine = slam_mod.GridSLAM(cfg, seed=seed, device=device)
    dev = engine.device
    gt_blocked = torch.as_tensor(gt_blocked, dtype=torch.bool).to(dev)
    state = engine.init(start_pose)
    g_gt = mcl_mod.make_generator(seed + 1, dev)
    scan_fn = _scanner(gt_blocked, cfg, g_gt)
    gt_pose = start_pose.to(dev)
    est_xy, best_xy, gt_xy, sm_xy = [], [], [], []
    for t, odom in enumerate(commands):
        gt_pose = motion.sample_motion_model_odometry(odom, gt_pose, cfg.motion.alphas,
                                                      generator=g_gt)
        if (t + 1) % update_every == 0:
            state = engine.step(state, odom, scan_fn(sensor_pose(gt_pose,
                                                                 cfg.mcl.scanner_offset)))
        else:
            state = engine.predict(state, odom)
        _slam_record(state, gt_pose, est_xy, best_xy, sm_xy, gt_xy)
    return SimResult(est_xy=np.array(est_xy), best_xy=np.array(best_xy),
                     gt_xy=np.array(gt_xy), final_state=state, sm_xy=np.array(sm_xy))


def run_slam_deterministic(
    gt_blocked,
    cfg: SLAMConfig,
    n_steps: int,
    trans: float = 2.5,
    rot: float = 0.02,
    seed: int = 0,
    device=None,
) -> SimResult:
    """Grid SLAM along the C++ head-to-head harness's DETERMINISTIC arc
    (`tools/refbench/ref_mcl_traj.cpp`): the truth integrates theta +=
    rot/2; x += trans*cos(theta); theta += rot/2 with no noise, from the
    canvas center heading pi/2."""
    engine = slam_mod.GridSLAM(cfg, seed=seed, device=device)
    dev = engine.device
    gt_blocked = torch.as_tensor(gt_blocked, dtype=torch.bool).to(dev)
    h, w = gt_blocked.shape
    gt = Pose.create(w / 2.0, h / 2.0, math.pi / 2, device=dev)
    state = engine.init(gt)
    odom = Odometry.create(rot / 2, trans, rot / 2)
    scan_fn = _scanner(gt_blocked, cfg, None)
    est_xy, best_xy, gt_xy, sm_xy = [], [], [], []
    for _ in range(n_steps):
        th1 = gt.theta + rot / 2
        gt = Pose(x=gt.x + trans * torch.cos(th1), y=gt.y + trans * torch.sin(th1),
                  theta=th1 + rot / 2)
        state = engine.step(state, odom, scan_fn(sensor_pose(gt, cfg.mcl.scanner_offset)))
        _slam_record(state, gt, est_xy, best_xy, sm_xy, gt_xy)
    return SimResult(est_xy=np.array(est_xy), best_xy=np.array(best_xy),
                     gt_xy=np.array(gt_xy), final_state=state, sm_xy=np.array(sm_xy))


def synthetic_room(h: int = 128, w: int = 128) -> np.ndarray:
    """A walled room with interior obstacles; bool[h, w] blocked mask (a
    copy of `slam_tpu/models/simulate.py:synthetic_room`)."""
    blocked = np.zeros((h, w), bool)
    blocked[:2, :] = blocked[-2:, :] = True
    blocked[:, :2] = blocked[:, -2:] = True
    blocked[h // 4 : h // 4 + 6, w // 3 : 2 * w // 3] = True
    blocked[2 * h // 3 : 2 * h // 3 + 8, w // 5 : w // 5 + 8] = True
    blocked[h // 2 : h // 2 + 4, 3 * w // 4 : 3 * w // 4 + 10] = True
    return blocked
