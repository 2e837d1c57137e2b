"""Euclidean distance transforms over occupancy grids (port of the capped
and exact transforms of `slam_tpu/ops/edt.py`).

  * `edt_capped` -- the range-capped exact separable transform the SLAM
    step rebuilds every map update (the likelihood field only resolves
    ~5 sigma of distance). A vertical clamped column distance (cummax /
    cummin index tricks on int32), then a (2C+1)-candidate shifted-min row
    pass. Every candidate is an integer g^2 + k^2 below 2^24, min is
    order-free and the square root is correctly rounded (`_sqrt`), so the
    result is bit for bit the JAX package's.
  * `edt_refresh` -- the incremental refresh of a capped EDT after a
    localized map edit (window re-run, full rebuild or skip, chosen on the
    device by `core/graph.py:cond`), bit for bit equal to a full rebuild.
  * `edt_exact` -- the exact (uncapped) transform, O(H W^2 / block): the
    oracle, and the sdf ray field's static transform.
  * `edt_jfa` -- jump flooding (JFA+1), the uncapped per-step transform of
    the sdf backend (`rayfield.dynamic_ray_field`). Seeds pack as
    (row << 16) | col, every pass reads only the previous pass's field,
    and candidates are exact integers in f32, so it too is bit for bit
    the JAX package's.

Distances are between cell centers in pixels; blocked cells are 0.
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.core.graph import cond

# Sentinels of the vertical pass: no blocked cell above / below.
_NONE_UP = -(1 << 30)
_NONE_DOWN = 1 << 30


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root. torch's CPU sqrt is off by an ulp
    on some f32 inputs (e.g. 2925); one taken in f64 and rounded to f32 is
    exact (53 >= 2 * 24 + 2 bits), as XLA's and CUDA's f32 sqrt are."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _vertical_dist(blocked: torch.Tensor, clamp: int) -> torch.Tensor:
    """int32[H, W]: rows to the nearest blocked cell in the same column,
    clamped to `clamp` (cells of a column with none read `clamp`)."""
    h, w = blocked.shape
    ii = torch.arange(h, dtype=torch.int32, device=blocked.device)[:, None].expand(h, w)
    up = ii - torch.cummax(torch.where(blocked, ii, _NONE_UP), 0).values
    below = torch.where(blocked, ii, _NONE_DOWN).flip(0)
    down = torch.cummin(below, 0).values.flip(0) - ii
    return torch.clamp(torch.minimum(up, down), max=clamp)


def edt_exact(blocked: torch.Tensor, block: int = 64) -> torch.Tensor:
    """Exact Euclidean distance transform, f32[H, W] pixels (cells with no
    blocked cell anywhere read h + w)."""
    h, w = blocked.shape
    big = float(h + w)
    g = _vertical_dist(blocked, int(big)).to(torch.float32)
    g2 = g * g
    kk = torch.arange(w, dtype=torch.float32, device=blocked.device)
    outs = []
    for j0 in range(0, w, block):
        j = j0 + torch.arange(block, dtype=torch.float32, device=blocked.device)
        d2 = g2[:, None, :] + (j[None, :, None] - kk) ** 2  # [H, block, W]
        outs.append(torch.amin(d2, dim=-1))
    e2 = torch.cat(outs, dim=1)[:, :w]
    return _sqrt(torch.clamp(e2, max=big * big))


def _jfa_steps(max_dim: int, max_dist: float | None) -> list:
    """The JFA+1 pass step sizes: powers of two down to 1, then one more
    pass of 1."""
    if max_dist is None:
        s = 1 << max(0, math.ceil(math.log2(max_dim)) - 1)
    else:
        rng = max(1, min(max_dim, int(math.ceil(max_dist))))
        s = 1 << math.ceil(math.log2(rng))
    steps = []
    while s >= 1:
        steps.append(s)
        s //= 2
    steps.append(1)  # the "+1" refinement pass
    return steps


def jfa_reach(max_dist: float) -> int:
    """L-infinity propagation reach of the capped JFA: the sum of all pass
    step sizes (no seed farther than that can be adopted)."""
    return sum(_jfa_steps(1 << 30, max_dist))


# The 8 JFA directions in the JAX package's order; with a strict `<` the
# earliest of equal candidates wins, which fixes how ties resolve.
_JFA_DIRS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1) if (di, dj) != (0, 0)]


def edt_jfa(
    blocked: torch.Tensor,
    max_dist: float | None = None,
    sentinel: float | None = None,
) -> torch.Tensor:
    """Jump-flooding EDT (JFA+1), f32[H, W] pixels.

    Each cell carries its nearest seed packed as (row << 16) | col (-1 =
    none) and that seed's squared distance. A pass of step s offers every
    cell the seeds of its 8 neighbours at (+-s, +-s), read from the
    previous pass's field (ping-pong), and keeps the nearest. `max_dist`
    starts the steps at 2^ceil(log2(max_dist)) instead of half the map
    (farther cells saturate to the sentinel); `sentinel` (default h + w)
    caps the result.

    The JAX package rolls the field and masks the wrapped entries; here
    the field is padded by s with -1 (no seed, distance 1e9: the masked
    value) and the 8 shifted views are stacked behind the current field.
    The JAX loop keeps a candidate only where it is strictly nearer, so
    its result is the FIRST minimum of [current, dir 1, ..., dir 8]: one
    `argmin` over the stack (first index on ties) picks the same seed."""
    h, w = blocked.shape
    if h >= (1 << 15) or w >= (1 << 16):
        raise ValueError(f"map {h}x{w} exceeds the 32768x65536 JFA limit")
    dev = blocked.device
    big = float(h + w if sentinel is None else sentinel)
    ii = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    jj = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    iif, jjf = ii.to(torch.float32), jj.to(torch.float32)
    idx = torch.where(blocked, (ii << 16) | jj, -1)

    def d2_of(idx_):
        si = (idx_ >> 16).to(torch.float32)
        sj = (idx_ & 0xFFFF).to(torch.float32)
        d2 = (iif - si) ** 2 + (jjf - sj) ** 2
        return torch.where(idx_ < 0, 1e9, d2)

    for s in _jfa_steps(max(h, w), max_dist):
        pad = torch.nn.functional.pad(idx, (s, s, s, s), value=-1)
        # roll by (di, dj) reads [i - di, j - dj]: the padded view at
        # offset s - d.
        cand = torch.stack(
            [idx] + [pad[s - di * s: s - di * s + h, s - dj * s: s - dj * s + w]
                     for di, dj in _JFA_DIRS]
        )
        best = torch.argmin(d2_of(cand), dim=0, keepdim=True)
        idx = torch.gather(cand, 0, best)[0]
    return _sqrt(torch.clamp(d2_of(idx), max=big * big))


def edt_capped_reach(max_dist: float) -> int:
    """L-infinity influence radius of `edt_capped`: ceil(cap) + 1 per axis
    (the vertical clamp C+1 bounds how far a column seed can matter; the
    row pass adds at most C columns)."""
    return int(math.ceil(max_dist)) + 1


def edt_capped(
    blocked: torch.Tensor, max_dist: float, sentinel: float | None = None
) -> torch.Tensor:
    """Range-capped exact Euclidean distance transform, f32[H, W].

    Distances <= max_dist are exact; farther cells read at least C+1
    (C = ceil(max_dist)), and every capped consumer only tests `> cap`.
    Blocked cells are exactly 0. `sentinel` (default h + w) caps the
    maximum; the windowed refresh passes the full map's.

    The row pass takes the 2C+1 shifted candidates of each cell as one
    `unfold` view of the padded squared column distances, adds the k^2
    constants and reduces with one `amin`: two launches where a loop of
    shifted `minimum` calls takes 4C (the choice is measured in PERF.md).
    Work and the temporary are O(H W C): use it for capped transforms."""
    h, w = blocked.shape
    big = float(h + w if sentinel is None else sentinel)
    c = int(math.ceil(max_dist))
    g = _vertical_dist(blocked, c + 1).to(torch.float32)
    lpad = torch.nn.functional.pad(g * g, (c, c), value=1e9)
    k = torch.arange(-c, c + 1, dtype=torch.float32, device=blocked.device)
    d2 = torch.amin(lpad.unfold(1, 2 * c + 1, 1) + k * k, dim=-1)
    return _sqrt(torch.clamp(d2, max=big * big))


def _refresh_plan(blocked_old, blocked_new, *, reach: int, box: int):
    """(any_diff, fits, si, sj), 0-d tensors on the masks' device: the
    flipped-cell bbox, the window placement (clipped to the map) and
    whether the bbox dilated by `reach` fits the window's composite
    interior (margin `reach`, except along window edges flush with MAP
    edges, where none is needed)."""
    h, w = blocked_new.shape
    diff = blocked_old ^ blocked_new
    rows = torch.any(diff, dim=1).to(torch.uint8)  # argmax takes no bool
    cols = torch.any(diff, dim=0).to(torch.uint8)
    any_diff = torch.any(rows.bool())
    # argmax returns the FIRST maximum, as jnp.argmax.
    r0 = torch.argmax(rows)
    r1 = h - 1 - torch.argmax(rows.flip(0))
    c0 = torch.argmax(cols)
    c1 = w - 1 - torch.argmax(cols.flip(0))

    def window_start(lo, hi, dim):
        center = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        return torch.clamp(center - box // 2, 0, dim - box)

    si = window_start(r0, r1, h)
    sj = window_start(c0, c1, w)

    def covers(lo, hi, start, dim):
        cov_lo = torch.where(start == 0, torch.zeros_like(start), start + reach)
        cov_hi = torch.where(start == dim - box, torch.full_like(start, dim),
                             start + box - reach)
        need_lo = torch.clamp(lo - reach, min=0)
        need_hi = torch.clamp(hi + reach + 1, max=dim)
        return (need_lo >= cov_lo) & (need_hi <= cov_hi)

    fits = covers(r0, r1, si, h) & covers(c0, c1, sj, w)
    return any_diff, fits, si, sj


def edt_refresh(
    edt_prev: torch.Tensor,
    blocked_old: torch.Tensor,
    blocked_new: torch.Tensor,
    *,
    max_dist: float,
    box: int,
) -> torch.Tensor:
    """Incrementally refresh a capped EDT after a localized map edit.

    A flipped-cell set can change `edt_capped` only within Chebyshev
    distance R = `edt_capped_reach(max_dist)` of it, and a windowed re-run
    whose margin to the window border is >= R reproduces the full-map run
    bit for bit inside that margin. So, given edt_prev ==
    edt_capped(blocked_old):

      1. no flipped cell: return `edt_prev` itself;
      2. the flipped bbox dilated by R fits a `box`-sized window's
         interior: re-run `edt_capped` on the window and composite its
         interior into a copy of `edt_prev`;
      3. otherwise: the full rebuild.

    All three equal `edt_capped(blocked_new, max_dist)` bit for bit. The
    plan, the window origin and the composite stay on the device (index
    arithmetic in place of the JAX package's dynamic slices), and the
    choice is the JAX package's nested `lax.cond` on `any_diff` and `fits`
    (`core/graph.py:cond`): in a captured step two levels of CUDA graph IF
    nodes, so the refresh reads nothing on the host; in an eager call on
    the card one read of each flag; on the CPU all three, selected. `box`
    must satisfy 4 * R < box <= min(H, W)."""
    h, w = blocked_new.shape
    if blocked_old.shape != (h, w) or edt_prev.shape != (h, w):
        raise ValueError("edt/mask shape mismatch")
    reach = edt_capped_reach(max_dist)
    if box > min(h, w):
        raise ValueError(
            f"edt refresh box {box} exceeds map dims {(h, w)} — use a "
            "smaller box or the full rebuild"
        )
    if box <= 4 * reach:
        raise ValueError(
            f"edt refresh box {box} must exceed 4*reach = {4 * reach} "
            f"(reach = ceil(max_dist)+1 for max_dist={max_dist}); "
            "smaller boxes would always fall back to the full rebuild"
        )
    any_diff, fits, si, sj = _refresh_plan(
        blocked_old, blocked_new, reach=reach, box=box
    )

    def local_fn(prev, mask, si, sj):
        li = torch.arange(box, device=mask.device)
        rows, cols = si + li, sj + li
        win_mask = mask.index_select(0, rows).index_select(1, cols)
        win_edt = edt_capped(win_mask, max_dist, sentinel=h + w)
        in_i = ((li >= reach) | (si == 0)) & ((li < box - reach) | (si == h - box))
        in_j = ((li >= reach) | (sj == 0)) & ((li < box - reach) | (sj == w - box))
        prev_win = prev.index_select(0, rows).index_select(1, cols)
        merged = torch.where(in_i[:, None] & in_j[None, :], win_edt, prev_win)
        flat = (rows[:, None] * w + cols[None, :]).reshape(-1)
        return prev.reshape(-1).index_copy(0, flat, merged.reshape(-1)).view(h, w)

    def full_fn(prev, mask, si, sj):
        return edt_capped(mask, max_dist)

    def changed_fn(prev, mask, si, sj):
        return cond(fits, local_fn, full_fn, prev, mask, si, sj, host_read=True)

    return cond(any_diff, changed_fn, lambda prev, mask, si, sj: prev,
                edt_prev, blocked_new, si, sj, host_read=True)


# JAX's older name of the refresh (it first ran over the capped JFA).
edt_jfa_refresh = edt_refresh
