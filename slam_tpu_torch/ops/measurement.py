"""Measurement models (port of `slam_tpu/ops/measurement.py`): the beam
model (raycast or fused LUT panorama route) and the likelihood field,
direct or through the boxed correlative score table of the SLAM step.

Also the auto tier's predicate `lf_auto_converged` and the notebook's
probabilistic beam model `beam_weights_probabilistic`. Not ported: the
sharded table build (`bin_sharding`, `ray_sharding`, `lpad=`; ROADMAP.md
Queue 1 item 5, `parallel/`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_tpu_torch.core import grid as gridlib
from slam_tpu_torch.core.config import RaycastConfig
from slam_tpu_torch.core.stats import log_pdf_normal_clamp_eps, pdf_normal, pdf_normal_clamp
from slam_tpu_torch.core.types import Pose, Scan
from slam_tpu_torch.ops import lut as lutlib
from slam_tpu_torch.ops import lut_weights_cuda
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


def beam_weights_probabilistic(
    prob_occ: torch.Tensor,
    poses: Pose,
    scan: Scan,
    *,
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    max_dist: float = 500.0,
    step: float = 0.5,
):
    """'Most probable along ray' beam model over an uncertain occupancy map
    `prob_occ` f32[H, W] (the notebook's cell-10
    `measurement_model_beam_probabilistic`). Marching along each beam, a
    new in-map cell at distance d < max_dist scores q = p * P(occ) *
    pdf_clamp(z - d), where p is the survival probability (p <- p * (1 -
    q)); the beam weight is the max q, floored by pdf(1.5 sigma) and, for
    a ray that stayed in the map, the max-range term. JAX's `lax.scan`
    over ray steps is a loop over the K steps here, with [N, B] tensors.

    Returns f32[N, B] beam weights (probabilities, not logs)."""
    h, w = prob_occ.shape
    dev = prob_occ.device
    prob_flat = prob_occ.reshape(-1)
    sp = sensor_pose(poses, scanner_offset)
    angles = sp.theta[:, None] + scan.angles[None, :]  # [N, B]
    dx = torch.cos(angles) * step
    dy = torch.sin(angles) * step
    z = scan.dists[None, :]
    i0, j0 = gridlib.world_to_cell((h, w), sp.x, sp.y)
    k_total = int(math.ceil(max_dist / step))
    p = torch.ones_like(angles)
    best = torch.full_like(angles, float(pdf_normal(
        stddev, torch.tensor(1.5 * stddev, dtype=torch.float32))))
    prev_cell = (i0 * w + j0)[:, None].expand(angles.shape)
    alive = torch.ones(angles.shape, dtype=torch.bool, device=dev)
    for k in range(k_total):
        kk = float(k + 1)
        d = float(np.float32(kk) * np.float32(step))  # JAX's f32 (k + 1) * step
        i, j = gridlib.world_to_cell((h, w), sp.x[:, None] + kk * dx, sp.y[:, None] + kk * dy)
        inb = gridlib.in_bounds((h, w), i, j)
        ic, jc = gridlib.clamp_cell((h, w), i, j)
        cell = i * w + j
        # The notebook breaks at the first out-of-bounds position and stops
        # scoring before d >= z_max; `alive` is the not-yet-broken flag.
        score = (cell != prev_cell) & inb & alive
        if not np.float32(d) < np.float32(max_dist):
            score = torch.zeros_like(score)
        occ = prob_flat[ic.long() * w + jc]
        q = torch.where(score, p * occ * pdf_normal_clamp(stddev, z - d), 0.0)
        best = torch.maximum(best, q)
        p = torch.where(score, p * (1.0 - q), p)
        prev_cell = torch.where(score, cell, prev_cell)
        alive = alive & inb
    # Max-range term, only for rays that reached z_max inside the map.
    return torch.maximum(
        best, torch.where(alive, p * pdf_normal_clamp(stddev, z - max_dist), 0.0))


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
    clamped-Gaussian log-pdf reduce of `pano_log_weights`. A table on a
    CUDA device goes to the kernel `csrc/lut_weights.cu`, which reads each
    beam's bin from the table row and writes no panorama; a table on the
    CPU to the composition above, its plain version.

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
    if lut.is_cuda:
        return lut_weights_cuda.launch(
            lut, n_bins, poses, scan, beam_stride=g,
            displacement=scanner_displacement(scanner_offset), max_dist=rc.max_dist,
            stddev=stddev, eps=eps,
        )[1]
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


# --------------------------------------------------------------------------
# Likelihood field (Thrun et al. table 6.3), direct and through the boxed
# correlative score table.
# --------------------------------------------------------------------------

_SHARDING = "is not ported to slam_tpu_torch yet (ROADMAP.md Queue 1 item 5, parallel/)"

# Elements of one gathered [T, beams, si, sj] window stack in the table
# build (256 MiB in f32): beams are taken in chunks of at most this size.
_TABLE_CHUNK_ELEMS = 1 << 26


def _needs_edt(field, measurement: str):
    if field.edt is None:
        raise ValueError(
            f"{measurement} needs field.edt (build the RayField with an EDT, "
            "e.g. ops/edt.py:edt_capped)"
        )


def particle_log_weights_likelihood_field(
    field,
    poses: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig = RaycastConfig(),
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    z_hit: float = 0.95,
    z_rand: float = 0.05,
    ray_sharding=None,
):
    """Likelihood-field log weights f32[N]: each beam endpoint scores
    log(z_hit * N(edt at its cell; sigma) + z_rand / z_max); max-range
    beams score 0 (no endpoint information) and out-of-map endpoints the
    z_rand floor. One EDT gather per (particle, beam)."""
    if ray_sharding is not None:
        raise NotImplementedError(f"ray_sharding {_SHARDING}")
    field = as_ray_field(field, rc)
    _needs_edt(field, "likelihood_field")
    h, w = field.edt.shape
    sp = sensor_pose(poses, scanner_offset)
    angles = sp.theta[:, None] + scan.angles[None, :]  # [N, B]
    z = scan.dists[None, :]
    ex = sp.x[:, None] + z * torch.cos(angles)
    ey = sp.y[:, None] + z * torch.sin(angles)
    i, j = gridlib.world_to_cell((h, w), ex, ey)
    inb = gridlib.in_bounds((h, w), i, j)
    ic, jc = gridlib.clamp_cell((h, w), i, j)
    d = field.edt.reshape(-1)[ic.long() * w + jc]
    p_hit = torch.where(inb, pdf_normal(stddev, d), 0.0)
    p = z_hit * p_hit + z_rand / rc.max_dist
    lw = torch.log(torch.clamp(p, min=1e-30))
    lw = torch.where(z >= rc.max_dist, 0.0, lw)
    return torch.sum(lw, dim=-1)


def lf_log_score_field(edt, *, stddev, z_hit, z_rand, max_dist):
    """Per-cell beam-endpoint log score over the EDT:
    log(z_hit * N(edt; sigma) + z_rand / z_max)."""
    return torch.log(
        torch.clamp(z_hit * pdf_normal(stddev, edt) + z_rand / max_dist, min=1e-30)
    )


def lf_cell_offsets(scan: Scan, headings, *, max_dist: float):
    """(oi, oj) int32[T, B]: the cell offset of beam b's endpoint at
    heading ``headings[t]``, in rows (i grows downward = -y) and columns,
    plus the field's pad ceil(max_dist) + 1: the window start of the (bin,
    beam) term in `lf_score_table`."""
    pad = int(math.ceil(max_dist)) + 1
    ang = headings[:, None] + scan.angles[None, :]  # [T, B]
    dx = scan.dists[None, :] * torch.cos(ang)
    dy = scan.dists[None, :] * torch.sin(ang)
    oi = torch.floor(0.5 - dy).to(torch.int32) + pad
    oj = torch.floor(0.5 + dx).to(torch.int32) + pad
    return oi, oj


def lf_score_table(
    edt,
    scan: Scan,
    headings,
    *,
    rc,
    stddev,
    z_hit,
    z_rand,
    dtype="f32",
    bin_sharding=None,
    origin=None,
    out_shape=None,
    lpad=None,
):
    """Correlative likelihood-field score table over heading bins, f32[T,
    si, sj]: S[t, a, b] = sum over valid beams of the per-cell log score
    (`lf_log_score_field`) at the endpoint of the beam fired from cell
    (i0 + a, j0 + b) at heading ``headings[t]``. Max-range beams are
    excluded; endpoints off the map read the log(z_rand / z_max) floor.

    Offsets use the snapped-sensor arithmetic floor(0.5 + dx) /
    floor(0.5 - dy), as the JAX package does. Dense build (``origin``
    None): the whole map, from the map padded by ceil(max_dist) + 1 floor
    cells. Boxed build: ``origin`` = (i0, j0), tensors that stay on the
    device, ``out_shape`` = static (si, sj); the padded window around the
    box is assembled from clipped row / column `index_select`s and a floor
    mask, bit for bit the padded field's values.

    Each (bin, beam) term is a window of that padded field. The windows
    are rows of an `unfold` view of it, so one advanced-indexing op
    gathers the windows of all bins and a chunk of beams; beams are
    valid-masked and summed in f32 (``dtype="bf16"`` stores the score
    field in bf16, accumulation stays f32)."""
    if bin_sharding is not None or lpad is not None:
        raise NotImplementedError(f"bin_sharding / lpad {_SHARDING}")
    h, w = edt.shape
    dev = edt.device
    si, sj = (h, w) if out_shape is None else out_shape
    pad = int(math.ceil(rc.max_dist)) + 1
    floor_val = float(math.log(max(z_rand / rc.max_dist, 1e-30)))
    store = torch.bfloat16 if dtype == "bf16" else torch.float32
    score = lf_log_score_field(
        edt, stddev=stddev, z_hit=z_hit, z_rand=z_rand, max_dist=rc.max_dist
    ).to(store)
    if origin is None:
        lpad = torch.nn.functional.pad(score, (pad, pad, pad, pad), value=floor_val)
    else:
        i0, j0 = (torch.as_tensor(o, device=dev) for o in origin)
        rows = i0 - pad + torch.arange(si + 2 * pad, device=dev)
        cols = j0 - pad + torch.arange(sj + 2 * pad, device=dev)
        in_i = (rows >= 0) & (rows < h)
        in_j = (cols >= 0) & (cols < w)
        core = score.index_select(0, rows.clamp(0, h - 1)).index_select(
            1, cols.clamp(0, w - 1)
        )
        lpad = torch.where(in_i[:, None] & in_j[None, :], core, floor_val)

    valid = (scan.dists < rc.max_dist).to(torch.float32)  # [B]
    # Window starts, clamped as a dynamic slice clamps its start.
    oi, oj = (o.clamp(0, 2 * pad).long()
              for o in lf_cell_offsets(scan, headings, max_dist=rc.max_dist))
    wins = lpad.unfold(0, si, 1).unfold(1, sj, 1)  # [., ., si, sj] view
    t, b = oi.shape
    chunk = max(1, _TABLE_CHUNK_ELEMS // (t * si * sj))
    acc = torch.zeros((t, si, sj), dtype=torch.float32, device=dev)
    for c0 in range(0, b, chunk):
        win = wins[oi[:, c0 : c0 + chunk], oj[:, c0 : c0 + chunk]]  # [T, c, si, sj]
        v = valid[c0 : c0 + chunk][None, :, None, None]
        acc += torch.sum(win.to(torch.float32) * v, dim=1)
    return acc


def lf_auto_converged(poses: Pose, cfg, grid_shape, scanner_offset=(0.0, 0.0, 0.0)):
    """The auto tier's predicate (``measurement="likelihood_field_auto"``),
    a bool 0-d tensor on the poses' device: True iff the cloud is
    table-eligible, i.e. the 4-sigma heading window is tighter than
    ``cfg.lf_auto_max_halfwidth`` AND the ``cfg.lf_auto_sigma``-sigma
    spatial extent (population std) fits the half box. Reductions only, no
    host read; one definition shared by `models/mcl.py:update` and
    `models/slam.py:AutoTierDispatcher`."""
    sp = sensor_pose(poses, scanner_offset)
    c = torch.mean(torch.cos(sp.theta))
    s = torch.mean(torch.sin(sp.theta))
    rbar = torch.clamp(torch.sqrt(c * c + s * s), 1e-7, 1.0 - 1e-7)
    cstd = torch.sqrt(-2.0 * torch.log(rbar))
    halfwidth = cfg.lf_table_spread * cstd + cfg.lf_table_min_halfwidth
    box_eff = float(cfg.lf_table_box if cfg.lf_table_box is not None else min(grid_shape))
    return (
        (halfwidth <= cfg.lf_auto_max_halfwidth)
        & (cfg.lf_auto_sigma * torch.std(sp.x, correction=0) <= box_eff / 2.0)
        & (cfg.lf_auto_sigma * torch.std(sp.y, correction=0) <= box_eff / 2.0)
    )


def lf_table_window(
    poses: Pose,
    *,
    grid_shape,
    scanner_offset=(0.0, 0.0, 0.0),
    table_bins: int = 32,
    spread_mult: float = 4.0,
    min_halfwidth: float = 0.02,
    box_size=None,
):
    """Particle-count-independent window statistics of the correlative
    table: the heading-bin window from the cloud's circular spread and the
    box origin from its mean sensor cell. Returns ``(mu, binw, halfwidth,
    headings[t], i0, j0, si, sj)``: tensors on the poses' device (no host
    read), except the static box dims ``si, sj`` (the map's without a
    ``box_size``)."""
    t = int(table_bins)
    if t < 2:
        raise ValueError(f"table_bins must be >= 2, got {t}")
    h, w = grid_shape
    sp = sensor_pose(poses, scanner_offset)
    dev = sp.theta.device
    c = torch.mean(torch.cos(sp.theta))
    s = torch.mean(torch.sin(sp.theta))
    mu = torch.atan2(s, c)
    rbar = torch.clamp(torch.sqrt(c * c + s * s), 1e-7, 1.0 - 1e-7)
    cstd = torch.sqrt(-2.0 * torch.log(rbar))
    halfwidth = torch.clamp(spread_mult * cstd + min_halfwidth, min_halfwidth, math.pi)
    binw = 2.0 * halfwidth / (t - 1)
    headings = mu + (torch.arange(t, dtype=torch.float32, device=dev) - (t - 1) / 2.0) * binw

    if box_size is None:
        si, sj = h, w
        i0 = j0 = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        si = min(int(box_size), h)
        sj = min(int(box_size), w)
        mi, mj = gridlib.world_to_cell((h, w), torch.mean(sp.x), torch.mean(sp.y))
        i0 = torch.clamp(mi - si // 2, 0, h - si).to(torch.int32)
        j0 = torch.clamp(mj - sj // 2, 0, w - sj).to(torch.int32)
    return mu, binw, halfwidth, headings, i0, j0, si, sj


def lf_table_prepare(
    field,
    poses: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig = RaycastConfig(),
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    z_hit: float = 0.95,
    z_rand: float = 0.05,
    table_bins: int = 32,
    spread_mult: float = 4.0,
    min_halfwidth: float = 0.02,
    table_dtype: str = "f32",
    box_size=None,
    ray_sharding=None,
):
    """Particle-count-independent half of `particle_log_weights_lf_table`:
    heading window, box origin and score-table build. Returns ``(tbl[si,
    sj, T] bins-last, mu, binw, halfwidth, i0, j0)`` for `lf_table_lookup`."""
    if ray_sharding is not None:
        raise NotImplementedError(f"ray_sharding {_SHARDING}")
    field = as_ray_field(field, rc)
    _needs_edt(field, "likelihood_field_table")
    h, w = field.edt.shape
    mu, binw, halfwidth, headings, i0, j0, si, sj = lf_table_window(
        poses, grid_shape=(h, w), scanner_offset=scanner_offset,
        table_bins=table_bins, spread_mult=spread_mult,
        min_halfwidth=min_halfwidth, box_size=box_size,
    )
    boxed = box_size is not None
    table = lf_score_table(
        field.edt, scan, headings, rc=rc, stddev=stddev, z_hit=z_hit,
        z_rand=z_rand, dtype=table_dtype,
        origin=(i0, j0) if boxed else None, out_shape=(si, sj) if boxed else None,
    )
    tbl = table.permute(1, 2, 0).contiguous()  # [si, sj, T]
    return (tbl, mu, binw, halfwidth, i0, j0)


def lf_table_lookup(
    prep,
    poses: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig,
    scanner_offset=(0.0, 0.0, 0.0),
    z_rand: float = 0.05,
    grid_shape=None,
):
    """Per-particle half of `particle_log_weights_lf_table`: the sensor
    cell's score, linearly interpolated between the two heading bins
    around the particle's heading. The bins-last table puts the (t0, t0+1)
    pair side by side, so one int64 flat index per particle reads both
    through a 2-wide `unfold` view: one gather. Particles heading more than
    half a bin past the window's edge, or whose cell lies outside the box,
    score the z_rand floor n_valid_beams * log(z_rand / z_max)."""
    tbl, mu, binw, halfwidth, i0, j0 = prep
    si, sj, t = tbl.shape
    h, w = grid_shape
    sp = sensor_pose(poses, scanner_offset)
    # An all-zeros prep would make d / binw NaN at d = 0; the floor below
    # discards those lanes either way.
    binw = torch.where(binw > 0, binw, 1.0)
    i, j = gridlib.world_to_cell((h, w), sp.x, sp.y)
    ic, jc = gridlib.clamp_cell((h, w), i, j)
    il = ic - i0
    jl = jc - j0
    in_box = (il >= 0) & (il < si) & (jl >= 0) & (jl < sj)
    ilc = torch.clamp(il, 0, si - 1)
    jlc = torch.clamp(jl, 0, sj - 1)
    d = torch.atan2(torch.sin(sp.theta - mu), torch.cos(sp.theta - mu))
    u = torch.clamp(d / binw + (t - 1) / 2.0, 0.0, float(t - 1))
    t0 = torch.clamp(torch.floor(u).to(torch.int32), 0, t - 2)
    frac = u - t0.to(u.dtype)
    flat = (ilc.long() * sj + jlc) * t + t0
    pair = tbl.reshape(-1).unfold(0, 2, 1)[flat]  # [N, 2]
    score = (1.0 - frac) * pair[:, 0] + frac * pair[:, 1]
    n_valid = torch.sum(scan.dists < rc.max_dist).to(torch.float32)
    floor_lw = n_valid * float(math.log(max(z_rand / rc.max_dist, 1e-30)))
    out = (torch.abs(d) > halfwidth + 0.5 * binw) | ~in_box
    return torch.where(out, floor_lw, score)


def particle_log_weights_lf_table(
    field,
    poses: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig = RaycastConfig(),
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    z_hit: float = 0.95,
    z_rand: float = 0.05,
    table_bins: int = 32,
    spread_mult: float = 4.0,
    min_halfwidth: float = 0.02,
    table_dtype: str = "f32",
    box_size=None,
    ray_sharding=None,
):
    """Likelihood-field weights f32[N] through the correlative score table:
    `lf_table_prepare` (build cost independent of the particle count) over
    `table_bins` heading bins spanning the cloud's circular spread, within
    a `box_size` box around its mean sensor cell when set, then
    `lf_table_lookup` (one pair gather per particle). The large-N tracking
    and SLAM fast path; the JAX package's docstring has the accuracy
    argument."""
    field = as_ray_field(field, rc)
    prep = lf_table_prepare(
        field, poses, scan, rc=rc, scanner_offset=scanner_offset,
        stddev=stddev, z_hit=z_hit, z_rand=z_rand, table_bins=table_bins,
        spread_mult=spread_mult, min_halfwidth=min_halfwidth,
        table_dtype=table_dtype, box_size=box_size, ray_sharding=ray_sharding,
    )
    return lf_table_lookup(
        prep, poses, scan, rc=rc, scanner_offset=scanner_offset, z_rand=z_rand,
        grid_shape=field.edt.shape,
    )
