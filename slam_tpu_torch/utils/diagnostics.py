"""Filter health diagnostics (port of `slam_tpu/utils/diagnostics.py`):
effective sample size (degeneracy), weight entropy, particle spread and
non-finite detection, plus a recovery action (uniform reinitialization
over free space, the augmented-MCL injection reused as an explicit
kidnapped-robot reset)."""

from __future__ import annotations

import torch

from slam_tpu_torch.core.types import log_f32
from slam_tpu_torch.models.mcl import MCLState
from slam_tpu_torch.ops import resample


def filter_health(state: MCLState) -> dict:
    """Health summary of an MCL state, 0-d tensors on its device (no host
    read):
      ess_frac: effective sample size / N (1 = healthy, -> 0 = degenerate)
      weight_entropy_frac: normalized weight entropy (1 = uniform)
      spread_x / spread_y: particle position population std
      any_nan: True if any pose or weight is non-finite"""
    lw = state.particles.log_weight
    n = lw.shape[0]
    ess = resample.effective_sample_size(lw)
    w = torch.softmax(lw, dim=0)
    entropy = -torch.sum(w * torch.log(torch.clamp(w, min=1e-30)))
    pose = state.particles.pose
    finite = torch.stack([torch.isfinite(v).all() for v in (lw, pose.x, pose.y, pose.theta)]).all()
    return {
        "ess_frac": ess / n,
        "weight_entropy_frac": entropy / log_f32(n),
        "spread_x": torch.std(pose.x, correction=0),
        "spread_y": torch.std(pose.y, correction=0),
        "any_nan": ~finite,
    }


def needs_recovery(health, ess_floor: float = 0.02, spread_ceiling: float | None = None) -> bool:
    """Degeneracy / divergence trigger (a host-side decision: it reads the
    health values)."""
    bad = bool(health["any_nan"]) or float(health["ess_frac"]) < ess_floor
    if spread_ceiling is not None:
        bad = bad or (float(health["spread_x"]) > spread_ceiling
                      or float(health["spread_y"]) > spread_ceiling)
    return bad


def recover(state: MCLState, blocked: torch.Tensor, fraction: float = 1.0, *,
            draws=None) -> MCLState:
    """Recovery action: reinitialize a `fraction` of the particles uniformly
    over free space, from the state's generator (or the injected `draws`,
    see `resample.injection_draws`), with uniform weights."""
    n = state.particles.n
    particles = resample.inject_random_particles(
        state.particles, blocked, fraction, draws=draws, generator=state.generator)
    return state.replace(particles=particles.replace(log_weight=torch.full(
        (n,), -log_f32(n), dtype=torch.float32, device=particles.log_weight.device)))

