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
