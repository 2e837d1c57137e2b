"""slam_tpu_torch motion model and the plain versions of both kernels.

K1 (the fused motion kernel) cannot run off the card, and its Pallas
original cannot run off the TPU (tests/test_pallas.py), so its plain
version is held to `slam_tpu.ops.motion` with JAX's own draws injected.
K2's plain version is held to the Pallas row gather in interpret mode.
The kernels themselves are checked on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.types import Odometry as JOdometry
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import mcl as jmcl
from slam_tpu.ops import motion as jmotion
from slam_tpu.ops.pano_pallas import gather_rows as pallas_gather_rows
from slam_tpu_torch.core.types import Odometry
from slam_tpu_torch.models import mcl as tmcl
from slam_tpu_torch.ops import motion as tmotion
from slam_tpu_torch.ops import motion_cuda, pano_cuda
from slam_tpu_torch.utils import convert
from torch_port import assert_angles_close, jax_noise, np_

ALPHAS = (0.0005, 0.0005, 0.01, 0.01)


@pytest.mark.parametrize(
    "odom,alphas",
    [
        ((2.5, 0.02, 0.02), ALPHAS),
        ((0.1, 2.0, 0.2), (0.01, 0.01, 0.01, 0.01)),
        ((-0.7, 5.0, 3.0), (0.002, 0.001, 0.003, 0.004)),
        ((0.0, 0.0, 0.0), (0.01, 0.01, 0.01, 0.01)),
    ],
)
def test_sampler_matches_jax_with_its_draws(odom, alphas):
    """Same draws -> same poses: rtol 1e-6, atol 1e-4 px (cos/sin ulps
    times the translation); theta compared on the circle."""
    rng = np.random.default_rng(1)
    n = 4096
    x = rng.uniform(0, 200, n).astype(np.float32)
    y = rng.uniform(0, 200, n).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    key = jax.random.key(3)
    jout = jmotion.sample_motion_model_odometry(
        key, JOdometry.create(*odom), JPose.create(x, y, th), alphas
    )
    noise = jax_noise(key, (n,))
    tout = tmotion.sample_motion_model_odometry(
        Odometry.create(*odom), convert.pose(x, y, th), alphas, noise=noise
    )
    np.testing.assert_allclose(np_(tout.x), np_(jout.x), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(np_(tout.y), np_(jout.y), rtol=1e-6, atol=1e-4)
    assert_angles_close(np_(tout.theta), np_(jout.theta), atol=1e-5)
    assert np.abs(np_(tout.theta)).max() <= np.pi


def test_predict_matches_jax_with_its_draws():
    """mcl.predict on the CPU (the fused wrapper's plain path) with the
    draws JAX's predict takes from its key."""
    n = 2048
    jstate = jmcl.init(jax.random.key(5), n, JPose.create(40.0, 30.0, 0.3))
    tstate = tmcl.init(0, n, convert.pose(40.0, 30.0, 0.3))
    odom = (0.05, 1.5, -0.02)
    before = motion_cuda.sample_motion_model_odometry_fused.launches
    for _ in range(3):
        _, sub = jax.random.split(jstate.key)
        noise = jax_noise(sub, (n,))
        jstate = jmcl.predict(jstate, JOdometry.create(*odom), jnp.asarray(ALPHAS))
        tstate = tmcl.predict(tstate, Odometry.create(*odom), ALPHAS, noise=noise)
        jp, tp = jstate.particles.pose, tstate.particles.pose
        np.testing.assert_allclose(np_(tp.x), np_(jp.x), rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(np_(tp.y), np_(jp.y), rtol=1e-6, atol=1e-4)
        assert_angles_close(np_(tp.theta), np_(jp.theta), atol=1e-5)
    assert tstate.step == int(jstate.step) == 3
    # CPU tensors never reach the kernel, so the launch count stands still.
    assert motion_cuda.sample_motion_model_odometry_fused.launches == before


def test_generator_draws_are_reproducible():
    """Without injected noise the CPU path draws from the generator:
    same seed, same poses; another seed, other poses."""
    pose = convert.pose(np.full(512, 10.0), np.full(512, 20.0), np.full(512, 0.5))
    odom = Odometry.create(0.1, 2.0, 0.2)

    def run(seed):
        g = tmcl.make_generator(seed)
        return motion_cuda.sample_motion_model_odometry_fused(odom, pose, ALPHAS, generator=g)

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a.x, b.x) and torch.equal(a.theta, b.theta)
    assert not torch.allclose(a.x, c.x)


def test_kernel_host_params_match_pallas_formula():
    """The six kernel parameters are the ones `motion_pallas.py:82-97`
    computes, in float32."""
    odom = (2.5, 0.02, 0.02)
    a = jnp.asarray(ALPHAS, jnp.float32)
    r1, t, r2 = (jnp.float32(v) for v in odom)
    want = [r1, t, r2,
            jnp.sqrt(a[0] * r1 * r1 + a[1] * t * t),
            jnp.sqrt(a[2] * t * t + a[3] * (r1 * r1 + r2 * r2)),
            jnp.sqrt(a[0] * r2 * r2 + a[1] * t * t)]
    got = motion_cuda.host_params(Odometry.create(*odom), ALPHAS)
    np.testing.assert_allclose(np.float32(got), np.float32(want), rtol=1e-7, atol=0)


@pytest.mark.parametrize("robots", [None, 3])
def test_kernel_odometry_rows(robots):
    """The fused kernel's odometry: f32 [R, 3] rows (rot1, trans, rot2),
    one row for a single filter's scalar odometry, bit for bit the f32
    values `host_params` starts from (the kernel derives the stddevs from
    them as `host_params` does)."""
    odoms = [(2.5, 0.02, 0.02), (0.3, -1.25, 0.7), (-0.01, 0.0, 3.1)]
    if robots is None:
        odom, rows = Odometry.create(*odoms[0]), odoms[:1]
    else:
        rows = odoms[:robots]
        odom = Odometry.create(*(list(c) for c in zip(*rows)))
    got = motion_cuda.odometry_rows(odom, "cpu")
    assert got.dtype == torch.float32 and got.shape == (len(rows), 3) and got.is_contiguous()
    for q, o in enumerate(rows):
        want = np.float32(motion_cuda.host_params(Odometry.create(*o), ALPHAS)[:3])
        assert got[q].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "u8"])
def test_gather_rows_plain_matches_pallas_interpret(dtype):
    """K2's plain version == the Pallas row gather (interpret mode)
    exactly, on random, repeated and boundary indices."""
    rng = np.random.default_rng(2)
    r, c = 300, 360
    if dtype == "u8":
        host = rng.integers(0, 256, (r, c)).astype(np.uint8)
        jrows, trows = jnp.asarray(host), torch.from_numpy(host)
    else:
        host = rng.standard_normal((r, c)).astype(np.float32)
        jrows = jnp.asarray(host, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
        trows = (convert.lut_tensor(np.asarray(jrows).view(np.uint16)) if dtype == "bf16"
                 else torch.from_numpy(host))
    for idx in (rng.integers(0, r, 130).astype(np.int32),
                np.asarray([0, r - 1, r - 1, 0, 7, 7, 7, 1], np.int32)):
        want = pallas_gather_rows(jrows, jnp.asarray(idx), block=8, slots=4, interpret=True)
        got = pano_cuda.gather_rows(trows, torch.from_numpy(idx))
        assert got.dtype == trows.dtype
        np.testing.assert_array_equal(np_(got), np_(want))


def test_vector_width_choice():
    """The kernel copies with the widest width dividing pitch and bases."""
    assert pano_cuda.vector_bytes(720, 0, 256) == 16  # bf16 360-bin rows
    assert pano_cuda.vector_bytes(360, 0, 256) == 8  # u8 360-bin rows
    assert pano_cuda.vector_bytes(364, 0, 256) == 4
    assert pano_cuda.vector_bytes(361, 0, 256) == 1
    assert pano_cuda.vector_bytes(720, 8, 256) == 8  # misaligned base
