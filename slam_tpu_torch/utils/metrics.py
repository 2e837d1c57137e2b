"""Trajectory evaluation: absolute trajectory error (ATE). A copy of
`slam_tpu/utils/metrics.py` (numpy only), which the port cannot import
without loading JAX."""

from __future__ import annotations

import numpy as np


def fit_se2(est_xy: np.ndarray, gt_xy: np.ndarray):
    """Closed-form rigid SE(2) alignment est -> gt (Umeyama, no scale).

    Returns (R[2,2], t[2]) with gt ~= est @ R.T + t.
    """
    est = np.asarray(est_xy, np.float64)
    gt = np.asarray(gt_xy, np.float64)
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    h = (est - mu_e).T @ (gt - mu_g)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, d]) @ u.T
    t = mu_g - r @ mu_e
    return r, t


def ate_rmse(est_xy: np.ndarray, gt_xy: np.ndarray, align: bool = False) -> float:
    """RMSE of position error between two [T, 2] trajectories; with
    align=True after the closed-form SE(2) alignment (`fit_se2`)."""
    est = np.asarray(est_xy, np.float64)
    gt = np.asarray(gt_xy, np.float64)
    if est.shape != gt.shape or est.ndim != 2 or est.shape[1] != 2:
        raise ValueError(f"need two [T, 2] trajectories, got {est.shape}, {gt.shape}")

    if align:
        r, t = fit_se2(est, gt)
        est = est @ r.T + t

    err = est - gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))
