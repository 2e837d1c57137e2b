"""slam_tpu_torch.ops.edt against slam_tpu.ops.edt: the capped and exact
transforms and the incremental refresh, bit for bit (every candidate of
the capped transform is an integer below 2^24, min is order-free and sqrt
is correctly rounded, so no tolerance is needed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import edt as jedt
from slam_tpu_torch.ops import edt as tedt

H, W = 96, 128


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32)


def _masks():
    rng = np.random.default_rng(5)
    edges = np.zeros((H, W), bool)
    edges[0, :7] = edges[:5, W - 1] = edges[H - 1, 40:44] = edges[50, 0] = True
    return {
        "sparse": rng.random((H, W)) < 0.01,
        "dense": rng.random((H, W)) < 0.2,
        "empty": np.zeros((H, W), bool),
        "full": np.ones((H, W), bool),
        "edges": edges,
        "narrow": rng.random((40, 9)) < 0.05,
    }


MASKS = _masks()


@pytest.mark.parametrize("cap", [7.0, 27.0])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_edt_capped_bitwise(name, cap):
    m = MASKS[name]
    want = jedt.edt_capped(jnp.asarray(m), cap)
    got = tedt.edt_capped(torch.from_numpy(m), cap)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    sent = jedt.edt_capped(jnp.asarray(m), cap, sentinel=500.0)
    np.testing.assert_array_equal(
        _bits(tedt.edt_capped(torch.from_numpy(m), cap, sentinel=500.0)), _bits(sent))


@pytest.mark.parametrize("name", ["sparse", "empty", "full", "edges"])
def test_edt_exact_bitwise(name):
    m = MASKS[name]
    want = jedt.edt_exact(jnp.asarray(m), block=32)
    np.testing.assert_array_equal(_bits(tedt.edt_exact(torch.from_numpy(m), block=32)),
                                  _bits(want))


def test_edt_capped_reach():
    for cap in (3.0, 7.0, 27.0, 26.5):
        assert tedt.edt_capped_reach(cap) == jedt.edt_capped_reach(cap)


CAP, BOX = 7.0, 48  # reach 8: the box must exceed 32


def _refresh_both(old, new, box=BOX, cap=CAP):
    """(port refresh, port full rebuild, JAX refresh, port prev, port plan,
    JAX plan) of one edit old -> new."""
    t_old, t_new = torch.from_numpy(old), torch.from_numpy(new)
    prev = tedt.edt_capped(t_old, cap)
    got = tedt.edt_refresh(prev, t_old, t_new, max_dist=cap, box=box)
    full = tedt.edt_capped(t_new, cap)
    jgot = jedt.edt_refresh(jedt.edt_capped(jnp.asarray(old), cap), jnp.asarray(old),
                            jnp.asarray(new), max_dist=cap, box=box)
    reach = tedt.edt_capped_reach(cap)
    tplan = [int(v) for v in tedt._refresh_plan(t_old, t_new, reach=reach, box=box)]
    jplan = [int(v) for v in jedt._refresh_plan(jnp.asarray(old), jnp.asarray(new),
                                                reach=reach, box=box)]
    np.testing.assert_array_equal(_bits(got), _bits(full))
    np.testing.assert_array_equal(_bits(got), _bits(jgot))
    assert tplan == jplan
    return got, prev, tplan


def _edit(rng, i, j, hh, ww):
    old = rng.random((H, W)) < 0.03
    new = old.copy()
    new[i : i + hh, j : j + ww] ^= True
    return old, new


def test_refresh_window(rng):
    old, new = _edit(rng, 50, 60, 4, 6)
    _, _, (any_diff, fits, _, _) = _refresh_both(old, new)
    assert any_diff and fits


@pytest.mark.parametrize("corner", [(0, 0), (0, W - 6), (H - 4, 0), (H - 4, W - 6)])
def test_refresh_window_flush_with_map_edges(rng, corner):
    old, new = _edit(rng, *corner, 4, 6)
    _, _, (any_diff, fits, si, sj) = _refresh_both(old, new)
    assert any_diff and fits
    assert si in (0, H - BOX) and sj in (0, W - BOX)


def test_refresh_full_fallback(rng):
    old, new = _edit(rng, 2, 2, 1, 1)
    new[90, 120] ^= True  # opposite corners fit no window
    _, _, (any_diff, fits, _, _) = _refresh_both(old, new)
    assert any_diff and not fits


def test_refresh_skip_returns_prev(rng):
    """No flipped cell: the refresh gives `edt_prev` bit for bit (the
    CPU's `cond` selects it; a graphed step copies it into the branch's
    output buffer)."""
    old = rng.random((H, W)) < 0.03
    got, prev, (any_diff, _, _, _) = _refresh_both(old, old.copy())
    assert not any_diff
    assert torch.equal(got.view(torch.int32), prev.view(torch.int32))


def test_refresh_seed_removal_resaturates():
    old = np.zeros((H, W), bool)
    old[48, 64] = old[10, 10] = True
    new = old.copy()
    new[48, 64] = False
    got, _, (any_diff, fits, _, _) = _refresh_both(old, new)
    assert any_diff and fits and float(got[48, 64]) > CAP


def test_refresh_randomized_chain(rng):
    """Random edits, fitting and not, chained (the refreshed field is the
    next step's prev): every step equals the full rebuild and JAX's."""
    old = rng.random((80, 96)) < 0.05
    prev = tedt.edt_capped(torch.from_numpy(old), CAP)
    seen = set()
    for _ in range(10):
        new = old.copy()
        ei, ej = int(rng.integers(0, 76)), int(rng.integers(0, 92))
        eh, ew = int(rng.integers(1, 24)), int(rng.integers(1, 24))
        new[ei : ei + eh, ej : ej + ew] ^= rng.random((min(eh, 80 - ei), min(ew, 96 - ej))) < 0.3
        got, _, (any_diff, fits, _, _) = _refresh_both(old, new, box=40)
        prev = tedt.edt_refresh(prev, torch.from_numpy(old), torch.from_numpy(new),
                                max_dist=CAP, box=40)
        np.testing.assert_array_equal(_bits(prev), _bits(got))
        seen.add((any_diff, fits))
        old = new
    assert (True, True) in seen


def test_refresh_validation():
    old = torch.zeros((64, 64), dtype=torch.bool)
    prev = tedt.edt_capped(old, 3.0)
    with pytest.raises(ValueError, match="4\\*reach"):
        tedt.edt_refresh(prev, old, old, max_dist=3.0, box=16)
    with pytest.raises(ValueError, match="exceeds map dims"):
        tedt.edt_refresh(prev, old, old, max_dist=3.0, box=80)
    with pytest.raises(ValueError, match="shape mismatch"):
        tedt.edt_refresh(prev[:32], old, old, max_dist=3.0, box=40)
