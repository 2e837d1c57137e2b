"""Configuration dataclasses: a copy of `slam_tpu/core/config.py`.

Importing `slam_tpu.core.config` loads JAX (through `slam_tpu/__init__.py`),
and the port must run where JAX is not installed, so the pure-Python
dataclasses are copied here. `tests/test_torch_core.py` holds this copy to
the original: same classes, field names, defaults and `beam_bin_stride`
results. The rationale behind each knob is documented in the original.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RaycastConfig:
    """Ray-march parameters (`slam/raycast.h:13-28` defaults step=0.5)."""

    step: float = 0.5
    max_dist: float = 500.0
    # "march" | "sdf" | "lut" | "cddt" (see slam_tpu.core.config).
    backend: str = "march"
    chunk: int = 64
    lut_bins: int = 360
    cddt_k: Optional[int] = None
    # "bf16" or "u8" (fixed-point, +-max_dist*1.25/510 quantization error).
    lut_dtype: str = "bf16"
    sdf_margin: float = 1.5

    @property
    def max_steps(self) -> int:
        return int(math.ceil(self.max_dist / self.step))


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """Simulated lidar (`slam/fake_lidar.h:10-23`)."""

    start: float = 0.0
    stop: float = 2.0 * math.pi
    max_dist: float = 500.0
    stddev: float = 5.0
    n_rays: int = 90
    noise_stddev: float = 0.0

    @property
    def angles(self) -> Tuple[float, ...]:
        rng = self.stop - self.start
        step = rng / self.n_rays
        return tuple(k * step - rng / 2.0 for k in range(self.n_rays))


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    """Thrun odometry motion-model noise (`slam/motion.cpp:9-32`)."""

    alphas: Tuple[float, float, float, float] = (0.001, 0.001, 0.001, 0.001)


@dataclasses.dataclass(frozen=True)
class VelocityMotionConfig:
    """Velocity motion-model noise (`slam/motion.cpp:34-56`)."""

    alphas: Tuple[float, float, float, float, float, float] = (
        0.001,
        0.001,
        0.001,
        0.001,
        0.001,
        0.001,
    )


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Shared log-odds occupancy grid."""

    height: int = 1000
    width: int = 1000
    l_occ: float = 0.42
    l_free: float = -0.2
    l_min: float = -6.0
    l_max: float = 6.0

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Augmented MCL random-particle injection (notebook cell 9)."""

    alpha_slow: float = 0.1
    alpha_fast: float = 0.9
    max_ratio: float = 1.0


@dataclasses.dataclass(frozen=True)
class MCLConfig:
    n_particles: int = 1000
    # "beam" | "likelihood_field" | "likelihood_field_table" |
    # "likelihood_field_auto".
    measurement: str = "beam"
    meas_stddev: float = 5.0
    meas_epsilon: float = 0.1
    lf_z_hit: float = 0.95
    lf_z_rand: float = 0.05
    lf_table_bins: int = 32
    lf_table_spread: float = 4.0
    lf_table_min_halfwidth: float = 0.02
    lf_table_box: int | None = None
    lf_auto_max_halfwidth: float = 0.6
    lf_auto_sigma: float = 4.0

    def __post_init__(self):
        if self.lf_table_box is not None and self.lf_table_box < 1:
            raise ValueError(
                f"lf_table_box must be >= 1 cells or None (dense build), "
                f"got {self.lf_table_box} — a degenerate box floors every "
                "particle"
            )
        if self.resample_every < 1:
            raise ValueError(
                f"resample_every must be >= 1, got {self.resample_every}"
            )

    lf_table_dtype: str = "f32"
    # "systematic" or "multinomial".
    resample: str = "systematic"
    # Resample only when ESS <= ess_threshold * N (1.0 = every update).
    ess_threshold: float = 1.0
    # Resample only on every k-th update.
    resample_every: int = 1
    # Temperature of the sharpened weighted-mean estimate (mode_pose).
    mode_tau: float = 8.0
    scanner_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    adaptive: Optional[AdaptiveConfig] = None
    # Static promise that beams are evenly spaced by exactly this many LUT
    # bins (derive with `beam_bin_stride`): enables the fused panorama path.
    lut_beam_stride: Optional[int] = None


def beam_bin_stride(lidar: "LidarConfig", rc: "RaycastConfig") -> Optional[int]:
    """Beam angular spacing measured in LUT bins, when it is an exact
    positive integer (the precondition of the fused panorama measurement
    path); None otherwise."""
    spacing = (lidar.stop - lidar.start) / lidar.n_rays
    g = spacing * rc.lut_bins / (2.0 * math.pi)
    gi = round(g)
    if gi >= 1 and abs(g - gi) < 1e-9 and lidar.n_rays * gi <= rc.lut_bins:
        return gi
    return None


@dataclasses.dataclass(frozen=True)
class ScanMatchConfig:
    """Correlative scan-matching pose refinement (slam_tpu.ops.scanmatch)."""

    window: int = 5
    theta_halfwidth: float = 0.06
    theta_bins: int = 13
    subcell: bool = True
    mapping: bool = False
    edt_offset: float = 0.5
    coarse_window: int = 0
    coarse_stride: int = 4
    coarse_theta_halfwidth: float = 0.25
    coarse_theta_bins: int = 11

    def __post_init__(self):
        if self.coarse_window > 0:
            if self.coarse_stride > 2 * self.window + 1:
                raise ValueError(
                    f"coarse_stride {self.coarse_stride} exceeds the fine "
                    f"window's reach 2*window+1 = {2 * self.window + 1}: "
                    "the fine level could not reach the true peak inside "
                    "the winning coarse block"
                )
            coarse_step = (
                2.0 * self.coarse_theta_halfwidth
                / max(1, self.coarse_theta_bins - 1)
            )
            if coarse_step > 2.0 * self.theta_halfwidth:
                raise ValueError(
                    f"coarse heading step {coarse_step:.4f} exceeds the "
                    f"fine level's span 2*theta_halfwidth = "
                    f"{2 * self.theta_halfwidth:.4f}: raise "
                    "coarse_theta_bins or theta_halfwidth"
                )


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Full grid-SLAM: MCL + shared-map log-odds occupancy mapping."""

    mcl: MCLConfig = MCLConfig()
    map: MapConfig = MapConfig()
    lidar: LidarConfig = LidarConfig()
    motion: MotionConfig = MotionConfig()
    raycast: RaycastConfig = RaycastConfig()
    map_every: int = 1
    # "best" | "mean" | "mode" | "auto".
    map_pose: str = "best"
    scanmatch: Optional[ScanMatchConfig] = None
    edt_box: Optional[int] = None

    def __post_init__(self):
        if self.map_pose not in ("best", "mean", "mode", "auto"):
            raise ValueError(
                f"map_pose must be 'best', 'mean', 'mode', or 'auto', got "
                f"{self.map_pose!r}"
            )


@dataclasses.dataclass(frozen=True)
class HybridAStarConfig:
    """Kinematic planner parameters (`slam/hastar.h:14-119`)."""

    velocity: float = 10.0
    max_steering: float = 40.0 * math.pi / 180.0
    length: float = 10.0 / math.tan(40.0 * math.pi / 180.0) * 2.0
    theta_res: int = 5
    branching_factor: int = 3
    tol: float = 5.0
    diff_drive: bool = True
    reverse_factor: float = 10.0
    batch: int = 256
    max_rounds: int = 4096
    selection: str = "grouped"
    heuristic: str = "geodesic"
    coarse: int = 4
    mode: str = "continuous"
    open_capacity: Optional[int] = None
    lattice_depth: int = 1
    lattice_reps: int = 1
    heuristic_weight: float = 1.0
    lattice_skip_precheck: bool = False


@dataclasses.dataclass(frozen=True)
class RRTStarConfig:
    """RRT* parameters (`slam/rrtstar.h:12-64`)."""

    reach: float = 20.0
    radius: float = 50.0
    max_nodes: int = 4096
    batch: int = 64
