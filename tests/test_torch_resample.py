"""slam_tpu_torch resampling against the JAX package, with JAX's own
uniform draws injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.types import Particles as JParticles
from slam_tpu.core.types import Pose as JPose
from slam_tpu.ops import resample as jres
from slam_tpu_torch.core.types import Particles, Pose
from slam_tpu_torch.ops import resample as tres
from slam_tpu_torch.utils import convert
from torch_port import np_

N = 4096


def _log_weights(kind, rng):
    if kind == "uniform":
        return np.zeros(N, np.float32)
    if kind == "one_dominant":
        lw = np.full(N, -50.0, np.float32)
        lw[rng.integers(N)] = 0.0
        return lw
    scale = {"flat": 0.5, "spread": 5.0, "peaked": 60.0}[kind]
    return (rng.standard_normal(N) * scale - 400.0).astype(np.float32)


KINDS = ["uniform", "one_dominant", "flat", "spread", "peaked"]


def _index_diff(got, want):
    """Share of slots that differ, after checking each differs by one."""
    d = got.astype(np.int64) - want.astype(np.int64)
    assert np.abs(d).max(initial=0) <= 1, "an index differs by more than one slot"
    return (d != 0).mean()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_systematic_indices_match_jax(kind, seed):
    """Identical indices given JAX's u0. The cumulative sum is taken in
    another order (XLA:CPU in f32, torch's CPU cumsum in a wider
    accumulator), so a draw sitting on a bin edge can land one slot over:
    at most 0.1% of slots, each by one slot."""
    rng = np.random.default_rng(seed)
    lw = _log_weights(kind, rng)
    key = jax.random.key(seed)
    u0 = np.asarray(jax.random.uniform(key, ()))
    want = np.asarray(jres.systematic_indices(key, jnp.asarray(lw)))
    got = tres.systematic_indices(torch.from_numpy(lw), u0=torch.tensor(u0)).numpy()
    assert got.dtype == np.int32
    assert _index_diff(got, want) <= 0.001
    assert (np.diff(got) >= 0).all() and got.min() >= 0 and got.max() < N


@pytest.mark.parametrize("kind", ["uniform", "spread", "peaked"])
def test_multinomial_indices_match_jax(kind):
    """Same draws -> the same searchsorted slots (<= 0.1% one slot over,
    as for the systematic resampler)."""
    rng = np.random.default_rng(3)
    lw = _log_weights(kind, rng)
    key = jax.random.key(4)
    u = np.asarray(jax.random.uniform(key, (N,)))
    want = np.asarray(jres.multinomial_indices(key, jnp.asarray(lw)))
    got = tres.multinomial_indices(torch.from_numpy(lw), u=convert.tensor(u)).numpy()
    assert _index_diff(got, want) <= 0.001


def test_weights_and_ess_match(rng):
    """softmax and ESS to rtol 1e-5 (exp ulps and the sum's order)."""
    for kind in KINDS:
        lw = _log_weights(kind, rng)
        np.testing.assert_allclose(
            np_(tres.normalized_weights(torch.from_numpy(lw))),
            np_(jres.normalized_weights(jnp.asarray(lw))), rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(
            float(tres.effective_sample_size(torch.from_numpy(lw))),
            float(jres.effective_sample_size(jnp.asarray(lw))), rtol=1e-5)


def test_gather_and_resample_exact(rng):
    """Given the same selection, the packed pose gather and the resampled
    particle set (uniform log weights -log n, in f32) are exact."""
    x, y, th = (rng.uniform(-5, 5, N).astype(np.float32) for _ in range(3))
    lw = _log_weights("spread", rng)
    key = jax.random.key(9)
    u0 = np.asarray(jax.random.uniform(key, ()))
    jp = JParticles(pose=JPose.create(x, y, th), log_weight=jnp.asarray(lw))
    tp = convert.particles(x, y, th, lw)
    idx = np.asarray(jres.systematic_indices(key, jnp.asarray(lw)))
    jg = jres.gather_pose_packed(jp.pose, jnp.asarray(idx))
    tg = tres.gather_pose_packed(tp.pose, convert.tensor(idx))
    for a, b in ((tg.x, jg.x), (tg.y, jg.y), (tg.theta, jg.theta)):
        np.testing.assert_array_equal(np_(a), np_(b))

    jr = jres.resample(key, jp, "systematic")
    tr = tres.resample(tp, "systematic", u0=torch.tensor(u0))
    np.testing.assert_array_equal(np_(tr.log_weight), np_(jr.log_weight))
    same = np_(tr.pose.x) == np_(jr.pose.x)
    assert same.mean() >= 0.999  # the <= 0.1% one-slot allowance above


def test_resample_rejects_unknown_method():
    p = convert.particles(np.zeros(4), np.zeros(4), np.zeros(4), np.zeros(4))
    with pytest.raises(ValueError):
        tres.resample(p, "stratified")


# -- the weights formed once, and the kernel chain's rule -----------------------

@pytest.mark.parametrize("rows", [None, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_shared_weights_give_the_same_ess_and_indices(kind, rows):
    """The ESS gate's weights handed to the resampler (`w=`) give the ESS,
    the indices and the resampled particles of the calls that form their
    own, bit for bit, on one filter and on [R, N] rows."""
    rng = np.random.default_rng(11)
    lw = torch.from_numpy(np.stack([_log_weights(kind, rng) for _ in range(rows or 1)]))
    if rows is None:
        lw = lw[0]
    u0 = torch.rand(lw.shape[:-1], generator=torch.Generator().manual_seed(3))
    w = tres.normalized_weights(lw)
    assert torch.equal(tres.effective_sample_size(lw, w=w), tres.effective_sample_size(lw))
    assert torch.equal(tres.systematic_indices(lw, u0=u0, w=w),
                       tres.systematic_indices(lw, u0=u0))
    x = torch.from_numpy(rng.uniform(-5, 5, lw.shape).astype(np.float32))
    p = convert.particles(x, x * 2.0, x * 0.5, lw)
    a, b = tres.resample(p, u0=u0, w=w), tres.resample(p, u0=u0)
    for f, g in ((a.pose.x, b.pose.x), (a.pose.theta, b.pose.theta),
                 (a.log_weight, b.log_weight)):
        assert torch.equal(f, g)


def test_gate_keeps_the_rows_it_turns_off():
    """`resample(..., gate=)` on [R, N] rows: a row whose gate is False
    keeps its particles and log weights, the others equal the ungated
    resample (on the card the kernel chain reads the gate itself)."""
    rng = np.random.default_rng(5)
    lw = torch.from_numpy(np.stack([_log_weights(k, rng) for k in KINDS]))
    x = torch.from_numpy(rng.uniform(-5, 5, lw.shape).astype(np.float32))
    p = convert.particles(x, x + 1.0, x - 1.0, lw)
    u0 = torch.rand(len(KINDS), generator=torch.Generator().manual_seed(8))
    gate = torch.tensor([True, False, True, False, True])
    got, full = tres.resample(p, u0=u0, gate=gate), tres.resample(p, u0=u0)
    for g_, f_, o_ in ((got.pose.x, full.pose.x, p.pose.x), (got.pose.y, full.pose.y, p.pose.y),
                       (got.log_weight, full.log_weight, p.log_weight)):
        assert torch.equal(g_[gate], f_[gate]) and torch.equal(g_[~gate], o_[~gate])


def _ends_cases():
    """(name, log weights, u0): the edge cases of the kernel chain's rule."""
    rng = np.random.default_rng(21)
    n = 5003  # over one 4096-particle tile, not a multiple of it
    spread = (rng.standard_normal(n) * 5.0).astype(np.float32)
    one_hot = np.full(n, -np.inf, np.float32)
    cases = [("dispersed", spread, 0.37), ("dispersed_u0_0", spread, 0.0),
             ("dispersed_u0_max", spread, float(np.nextafter(np.float32(1), np.float32(0))))]
    for name, at in (("collapsed_first", 0), ("collapsed_last", n - 1),
                     ("collapsed_middle", n // 2)):
        lw = one_hot.copy()
        lw[at] = 0.0
        cases.append((name, lw, 0.5))
    runs = spread.copy()
    runs[100:3000] = -np.inf  # a long run of empty ranges inside one block's slots
    runs[3500:3510] = 40.0
    cases.append(("empty_runs", runs, 0.21))
    neg = spread.copy()
    neg[::7] = -np.inf
    cases.append(("minus_inf", neg, 0.66))
    cases.append(("one_particle", np.zeros(1, np.float32), 0.9))
    cases.append(("one_tile", spread[:1000], 0.13))
    return cases


def _merge_path(ends, n, diag):
    """The kernel's warp search (`csrc/resample.cu:merge_path`): particles
    taken after `diag` steps of the merge of `ends` with the slots, a
    particle before slot k when ends_i <= k; 32 candidates a round."""
    lo, hi = max(0, diag - n), min(diag, n)
    while lo < hi:
        step = -(-(hi - lo) // 32)
        m = lo + step * np.arange(32)
        c = int(np.sum([mm < hi and ends[mm] <= diag - 1 - mm for mm in m]))
        if c == 0:
            hi = lo
        else:
            lo, hi = lo + (c - 1) * step + 1, min(hi, lo + c * step)
    return lo


def _merge_path_select(ends, path):
    """The select kernel's partition, block by block: `path` merge steps a
    block, its cut particles i0 and i1, its slots [k0, k1), each slot's
    owner the first of the block's ends past it. Every slot is written by
    exactly one block."""
    n = len(ends)
    out = np.full(n, -1, np.int64)
    for d0 in range(0, 2 * n, path):
        d1 = min(d0 + path, 2 * n)
        i0, i1 = _merge_path(ends, n, d0), _merge_path(ends, n, d1)
        k0, k1 = d0 - i0, d1 - i1
        window = ends[i0:min(i1, n - 1) + 1]
        assert 0 < len(window) <= path + 1 and 0 <= k0 <= k1 <= n
        assert (out[k0:k1] == -1).all()
        j = np.searchsorted(window, np.arange(k0, k1), side="right")
        out[k0:k1] = i0 + np.minimum(j, len(window) - 1)
    assert (out >= 0).all()
    return out


@pytest.mark.parametrize("path", [16, 2048])
@pytest.mark.parametrize("case", [c[0] for c in _ends_cases()])
def test_merge_path_rule_equals_scatter_cummax(case, path):
    """The kernel chain's rule, "slot k takes the first particle i with
    ends_i > k", found by its merge-path partition (`path` steps a
    block: the kernel's 2048, and 16 for many block edges), equals the plain
    path's scatter-amax plus cummax on the edge cases: dispersed weights
    with u0 at 0 and just under 1, all mass on the first, the last or a
    middle particle, long runs of empty ranges, -inf log weights, one
    particle, one tile."""
    _, lw, u0 = next(c for c in _ends_cases() if c[0] == case)
    ends_t = tres.systematic_ends(tres.normalized_weights(torch.from_numpy(lw)),
                                  torch.tensor(u0, dtype=torch.float32))
    ends = ends_t.numpy()
    n = len(ends)
    assert (np.diff(ends) >= 0).all() and ends[0] >= 0 and ends[-1] == n
    want = tres.indices_from_ends(ends_t).numpy()
    first_past = np.searchsorted(ends, np.arange(n), side="right")
    np.testing.assert_array_equal(first_past, want)
    np.testing.assert_array_equal(_merge_path_select(ends, path), want)


def _wrapper_args(r=2, n=8):
    w = torch.full((r, n), 1.0 / n)
    pose = Pose(x=torch.zeros(r, n), y=torch.zeros(r, n), theta=torch.zeros(r, n))
    return dict(w=w, u0=torch.rand(r), gate=torch.ones(r, dtype=torch.bool), pose=pose,
                log_weight=torch.zeros(r, n))


def _bad(name):
    a = _wrapper_args()
    r, n = a["w"].shape
    if name == "w_dtype":
        a["w"] = a["w"].double()
    elif name == "w_3d":
        a["w"] = a["w"][None]
    elif name == "w_strided":
        a["w"] = torch.full((r, 2 * n), 0.5 / n)[:, ::2]
    elif name == "w_empty":
        a["w"] = torch.zeros(r, 0)
    elif name == "u0_count":
        a["u0"] = a["u0"][:1]
    elif name == "u0_dtype":
        a["u0"] = a["u0"].double()
    elif name == "gate_dtype":
        a["gate"] = a["gate"].to(torch.uint8)
    elif name == "gate_count":
        a["gate"] = torch.ones(r + 1, dtype=torch.bool)
    elif name == "pose_shape":
        a["pose"] = Pose(x=torch.zeros(r, n + 1), y=a["pose"].y, theta=a["pose"].theta)
    elif name == "pose_strided":
        a["pose"] = Pose(x=a["pose"].x, y=torch.zeros(n, r).t(), theta=a["pose"].theta)
    elif name == "log_weight_dtype":
        a["log_weight"] = a["log_weight"].double()
    elif name == "pose_alone":
        a["log_weight"] = None
    return a


@pytest.mark.parametrize("name", ["w_dtype", "w_3d", "w_strided", "w_empty", "u0_count",
                                  "u0_dtype", "gate_dtype", "gate_count", "pose_shape",
                                  "pose_strided", "log_weight_dtype", "pose_alone", "cpu"])
def test_resample_cuda_wrapper_rejects(name):
    """`resample_cuda.launch` raises ValueError, before any build, on a
    wrong dtype, shape, count or layout, and on tensors off the card (the
    last case: every argument right, on the CPU); no launch is counted. The
    plain route on CPU tensors never counts one either."""
    from slam_tpu_torch.ops import resample_cuda

    before = resample_cuda.launch.launches
    a = _bad(name)
    with pytest.raises(ValueError):
        resample_cuda.launch(a.pop("w"), a.pop("u0"), **a)
    a = _wrapper_args()
    tres.resample(Particles(pose=a["pose"], log_weight=a["log_weight"]), u0=a["u0"],
                  gate=a["gate"])
    tres.systematic_indices(a["log_weight"], u0=a["u0"])
    assert resample_cuda.launch.launches == before
