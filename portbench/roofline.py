"""Peaks of the card and the work each measured operation needs, counted
from its inputs and outputs.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit:
3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor cores. A
share of a roofline is the least time (the larger of the bytes over the
memory rate and the operations over the float32 rate) over the measured
device time.

Operations counted from the kernels' arithmetic, integer and float alike,
at the float32 rate (the counts `chip_smoke.py` uses): the odometry motion
sampler ~130 a particle (Philox4x32-10's 10 rounds, Box-Muller, the
integration and the wrap), locating the sensor's cell and bin ~20, one
beam of the LUT weights ~12 (bin index, decode, hit test, error, the
clamped pdf, exp, log, the sum).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_SAMPLE = 130
OPS_LOCATE = 20
OPS_BEAM = 12


def least_ms(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least ms the card can take to move `n_bytes` and compute
    `n_ops`."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3


def share(n_bytes: float, n_ops: float, device_ms: float) -> float:
    """% of the roofline that an operation measured at `device_ms` reaches."""
    return 100.0 * least_ms(n_bytes, n_ops) / device_ms


def resample_work(n: int):
    """(bytes, operations) of systematic resampling of n particles: the
    log weights and the poses (16 B a particle) read once, the new poses
    and log weights written once."""
    return 32.0 * n, 0.0


def lut_weights_work(n: int, distinct_cells: int, n_beams: int):
    """(bytes, operations) of the fused predict -> LUT-weigh over n
    particles: each pose read and written (12 + 12 B) and its weight
    written (4 B), each distinct sensor cell's beams read once (2 B a bf16
    value), the scan's angles and ranges (8 B a beam) and the seed."""
    return (n * (12 + 12 + 4) + distinct_cells * n_beams * 2 + n_beams * 8 + 8,
            n * (OPS_SAMPLE + OPS_LOCATE + n_beams * OPS_BEAM))


def edt_capped_work(h: int, w: int, cap: float):
    """(bytes, operations) of the capped distance transform of an h x w
    map: the bool map read (1 B a cell) and the f32 field written (4 B);
    a cell's vertical pass (two scans, ~4 operations) and its row pass
    over 2C + 1 candidates (an add and a min each)."""
    c = int(math.ceil(cap))
    return 5.0 * h * w, h * w * (4 + 2 * (2 * c + 1))
