"""Beam-endpoint measurement model (port of the beam half of
`slam_tpu/ops/measurement.py`).

The likelihood-field measurements (`particle_log_weights_likelihood_field`,
the correlative table) wait for the full-SLAM slice (ROADMAP.md Queue 1
item 9).
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.core.config import RaycastConfig
from slam_tpu_torch.core.stats import log_pdf_normal_clamp_eps
from slam_tpu_torch.core.types import Pose, Scan
from slam_tpu_torch.ops import lut as lutlib
from slam_tpu_torch.ops.rayfield import as_ray_field, raycast_field


def scanner_displacement(scanner_offset):
    """Decompose a mounting offset pose into (d, theta, rot)
    (`slam/mcl.cpp:80-86`)."""
    ox, oy, orot = scanner_offset
    return math.hypot(ox, oy), math.atan2(oy, ox), orot


def sensor_pose(pose: Pose, scanner_offset) -> Pose:
    """Sensor pose in the world frame given the robot pose and the lidar
    mounting offset (`slam/mcl.cpp:88-100`)."""
    d, th, rot = scanner_displacement(scanner_offset)
    return Pose(
        x=pose.x + torch.cos(pose.theta + th) * d,
        y=pose.y + torch.sin(pose.theta + th) * d,
        theta=pose.theta + rot,
    )


def beam_log_weights(pred_dist, hit, meas_dist, *, stddev, max_dist, eps=0.1):
    """Per-beam log weight: hit -> log(pdf_clamp(sigma, pred - meas) + eps),
    no hit -> log(pdf_clamp(sigma, meas - max_dist) + eps)
    (`slam/raycast.cpp:225-242`)."""
    err = torch.where(hit, pred_dist - meas_dist, meas_dist - max_dist)
    return log_pdf_normal_clamp_eps(stddev, err, eps)


def pano_log_weights(
    pano, inb, theta, scan: Scan, *, n_bins: int, beam_stride: int,
    lut_dtype, max_dist: float, stddev: float = 5.0, eps: float = 0.1,
):
    """Log weights of N sensors from their panorama rows `pano`
    [N, n_bins] (raw table values), in-bounds mask `inb` [N] and sensor
    headings `theta` [N]; the part of `particle_log_weights_lut_fused` after
    the row gather.

    Beam k of sensor n reads bin (s_n + g*k) mod n_bins with
    s_n = round((theta_n + a_0) / binw), exactly the per-beam rounding of
    `raycast_lut`. With s_n = g*q_n + r_n, beam k sits at position
    (q_n + k) mod M of comb r_n (M = n_bins / g). The JAX package selects
    the comb and aligns the scan with one-hot contractions
    (`measurement.py:732-752`); here both are direct indexing, which picks
    the same values exactly."""
    g = beam_stride
    m = n_bins // g
    n = pano.shape[0]
    b_beams = scan.angles.shape[0]
    binw = 2.0 * math.pi / n_bins
    s = torch.remainder(
        torch.round((theta + scan.angles[0]) / binw).to(torch.int32), n_bins
    )
    q = torch.div(s, g, rounding_mode="floor").long()
    r = torch.remainder(s, g).long()

    # Comb select: position p of comb r_n is bin g*p + r_n.
    raw = pano.reshape(n, m, g).gather(2, r[:, None, None].expand(n, m, 1))[..., 0]
    pred = lutlib.dequantize(raw, lut_dtype, max_dist)  # [N, M]

    # Position p holds beam (p - q_n) mod M; positions past the last beam
    # read the zero padding and are masked by `valid`.
    dev = pano.device
    ztab = torch.zeros((m,), dtype=torch.float32, device=dev)
    ztab[:b_beams] = scan.dists.to(torch.float32)
    vtab = torch.zeros((m,), dtype=torch.float32, device=dev)
    vtab[:b_beams] = 1.0
    beam = torch.remainder(
        torch.arange(m, device=dev)[None, :] - q[:, None], m
    )  # [N, M]
    z_at = ztab[beam]
    valid = vtab[beam]

    hit = (pred < max_dist) & inb[:, None]
    err = torch.where(hit, pred - z_at, z_at - max_dist)
    lw = log_pdf_normal_clamp_eps(stddev, err, eps) * valid
    return torch.sum(lw, dim=-1)


def particle_log_weights_lut_fused(
    field,
    poses: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig,
    beam_stride: int,
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    eps: float = 0.1,
):
    """Fused beam-model weights via LUT panorama rows: ONE row gather per
    particle (all bins of its sensor cell; every beam of a particle starts
    there, `slam/mcl.cpp:60-75`), then the bin->beam alignment and the
    clamped-Gaussian log-pdf reduce of `pano_log_weights`.

    `beam_stride` g is the static promise that beam angles are evenly
    spaced by exactly g bins (`config.beam_bin_stride`)."""
    lut = field.lut
    if lut is None:
        raise ValueError("lut-fused measurement needs field.lut")
    _h, _w, stride = lut.shape
    n_bins = field.lut_bins or stride
    g = int(beam_stride)
    if g < 1 or n_bins % g != 0:
        raise ValueError(f"beam_stride {g} must divide lut bins {n_bins}")
    m = n_bins // g
    b_beams = scan.angles.shape[0]
    if b_beams > m:
        raise ValueError(
            f"{b_beams} beams at stride {g} exceed {m} distinct positions"
        )
    sp = sensor_pose(poses, scanner_offset)
    pano, inb = lutlib.panorama_rows(lut, sp.x, sp.y, n_bins)  # [N, n_bins]
    return pano_log_weights(
        pano, inb, sp.theta, scan, n_bins=n_bins, beam_stride=g,
        lut_dtype=lut.dtype, max_dist=rc.max_dist, stddev=stddev, eps=eps,
    )


def particle_log_weights(
    field,
    poses: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig = RaycastConfig(),
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    eps: float = 0.1,
    lut_beam_stride=None,
):
    """Log measurement likelihood f32[N] of every particle given one scan
    (the log of `slam/mcl.cpp:69-75`'s product of beam weights).

    `field` is a `RayField` or a raw bool[H, W] blocked mask. With the lut
    backend and a `lut_beam_stride`, the fused panorama route; otherwise one
    raycast per (particle, beam) through `raycast_field`."""
    field = as_ray_field(field, rc)
    if lut_beam_stride is not None and rc.backend == "lut" and field.lut is not None:
        return particle_log_weights_lut_fused(
            field, poses, scan, rc=rc, beam_stride=lut_beam_stride,
            scanner_offset=scanner_offset, stddev=stddev, eps=eps,
        )
    sp = sensor_pose(poses, scanner_offset)
    angles = sp.theta[:, None] + scan.angles[None, :]  # [N, B]
    px = sp.x[:, None].expand(angles.shape)
    py = sp.y[:, None].expand(angles.shape)
    pred, hit = raycast_field(field, px, py, angles, rc)
    lw = beam_log_weights(
        pred, hit, scan.dists[None, :],
        stddev=stddev, max_dist=rc.max_dist, eps=eps,
    )
    return torch.sum(lw, dim=-1)
