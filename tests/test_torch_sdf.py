"""slam_tpu_torch's sdf ray backend against slam_tpu's: the jump-flooding
EDT bit for bit (every candidate is an integer in f32, the JAX loop's
strict `<` keeps the first minimum and the square root is correctly
rounded), the sphere trace and the ray-field dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.core.config import LidarConfig as JLidar
from slam_tpu.core.config import RaycastConfig as JRaycast
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.ops import edt as jedt
from slam_tpu.ops import measurement as jmeas
from slam_tpu.ops import raycast as jray
from slam_tpu.ops import rayfield as jrf
from slam_tpu_torch.core.config import RaycastConfig
from slam_tpu_torch.ops import edt as tedt
from slam_tpu_torch.ops import measurement as tmeas
from slam_tpu_torch.ops import raycast as tray
from slam_tpu_torch.ops import rayfield as trf
from slam_tpu_torch.utils import convert
from torch_port import np_, random_poses, room, t_scan


def _bits(a) -> np.ndarray:
    return np_(a).view(np.uint32)


H, W = 48, 70


def _masks():
    rng = np.random.default_rng(11)
    edges = np.zeros((H, W), bool)
    edges[0, :5] = edges[:3, W - 1] = edges[H - 1, 30:33] = True
    single = np.zeros((H, W), bool)
    single[17, 41] = True
    return {
        "random": rng.random((H, W)) < 0.03,
        "dense": rng.random((H, W)) < 0.3,
        "room": room(H, W),
        "empty": np.zeros((H, W), bool),
        "single": single,
        "edges": edges,
    }


MASKS = _masks()
# One shape for every mask: each (max_dist, sentinel) compiles once.
_jfa = jax.jit(jedt.edt_jfa, static_argnames=("max_dist", "sentinel"))


@pytest.mark.parametrize("max_dist", [None, 7.0])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_edt_jfa_bitwise(name, max_dist):
    m = MASKS[name]
    want = _jfa(jnp.asarray(m), max_dist=max_dist)
    got = tedt.edt_jfa(torch.from_numpy(m), max_dist=max_dist)
    assert got.dtype == torch.float32 and got.shape == m.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if name == "random" and max_dist is not None:
        np.testing.assert_array_equal(
            _bits(tedt.edt_jfa(torch.from_numpy(m), max_dist, sentinel=300.0)),
            _bits(_jfa(jnp.asarray(m), max_dist=max_dist, sentinel=300.0)))


def test_jfa_steps_and_reach():
    for dim in (1, 2, 3, 63, 64, 65, 1297):
        for cap in (None, 0.5, 1.0, 7.0, 27.0, 100.0, 5000.0):
            assert tedt._jfa_steps(dim, cap) == jedt._jfa_steps(dim, cap)
    for cap in (1.0, 7.0, 27.0, 30.5, 300.0):
        assert tedt.jfa_reach(cap) == jedt.jfa_reach(cap)
    with pytest.raises(ValueError, match="JFA limit"):
        tedt.edt_jfa(torch.zeros((1 << 15, 1), dtype=torch.bool))


def _rays(blocked, n, seed):
    x, y, th = random_poses(np.random.default_rng(seed), n, blocked)
    return x, y, th


@pytest.mark.parametrize("edt_fn, margin", [(jedt.edt_exact, 1.0), (_jfa, 1.5)])
def test_raycast_sdf_matches_jax(edt_fn, margin):
    """Hits equal on every ray; distances equal, or within one step on a
    stated share of rays (cos / sin differ by an ulp between XLA:CPU and
    torch, which can move a sphere-trace sample across a cell edge)."""
    blocked = MASKS["room"]
    edt = np.array(edt_fn(jnp.asarray(blocked)))
    x, y, th = _rays(blocked, 3000, 3)
    kw = dict(step=0.5, max_dist=80.0, margin=margin)
    jd, jh = jray.raycast_sdf(jnp.asarray(edt), jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(th), **kw)
    td, thit = tray.raycast_sdf(torch.from_numpy(edt), torch.from_numpy(x),
                                torch.from_numpy(y), torch.from_numpy(th), **kw)
    jd, jh, td, thit = np_(jd), np_(jh), np_(td), np_(thit)
    assert np.mean(thit == jh) >= 0.999
    diff = np.abs(td - jd)
    assert np.mean(diff == 0) >= 0.99
    assert np.mean(diff <= kw["step"]) >= 0.998
    assert jh.mean() > 0.5
    hx, hy = tray.raycast_hit_points(*(torch.from_numpy(v) for v in (x, y, th)),
                                     torch.tensor(jd), torch.tensor(jh))
    jx, jy = jray.raycast_hit_points(jnp.asarray(x), jnp.asarray(y), jnp.asarray(th),
                                     jnp.asarray(jd), jnp.asarray(jh))
    np.testing.assert_allclose(np_(hx), np_(jx), atol=1e-4)
    np.testing.assert_allclose(np_(hy), np_(jy), atol=1e-4)


def test_raycast_sdf_shapes_and_max_iters():
    blocked = MASKS["room"]
    edt = torch.from_numpy(np.array(jedt.edt_exact(jnp.asarray(blocked))))
    x, y, th = _rays(blocked, 24, 5)
    shape = (4, 6)
    args = [torch.from_numpy(v).reshape(shape) for v in (x, y, th)]
    d, h = tray.raycast_sdf(edt, *args, step=1.0, max_dist=60.0, margin=1.0, max_iters=3)
    jd, jh = jray.raycast_sdf(jnp.asarray(edt.numpy()), *(jnp.asarray(v.numpy()) for v in args),
                              step=1.0, max_dist=60.0, margin=1.0, max_iters=3)
    assert d.shape == shape and h.shape == shape
    np.testing.assert_array_equal(np_(h), np_(jh))
    np.testing.assert_allclose(np_(d), np_(jd), atol=1.0)


def test_ray_field_sdf_matches_jax():
    blocked = MASKS["room"]
    jrc = JRaycast(step=1.0, max_dist=60.0, backend="sdf")
    trc = RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    jf = jrf.make_ray_field(jnp.asarray(blocked), jrc)
    tf = trf.make_ray_field(torch.from_numpy(blocked), trc)
    np.testing.assert_array_equal(_bits(tf.edt), _bits(jf.edt))
    jdyn = jrf.RayField(blocked=jnp.asarray(blocked), edt=_jfa(jnp.asarray(blocked)))
    tdyn = trf.as_ray_field(torch.from_numpy(blocked), trc)
    np.testing.assert_array_equal(_bits(tdyn.edt), _bits(jdyn.edt))
    np.testing.assert_array_equal(
        _bits(trf.dynamic_ray_field(torch.from_numpy(blocked), trc).edt), _bits(jdyn.edt))
    x, y, th = _rays(blocked, 2000, 9)
    for jfield, tfield in ((jf, tf), (jdyn, tdyn)):
        jd, jh = jrf.raycast_field(jfield, jnp.asarray(x), jnp.asarray(y), jnp.asarray(th), jrc)
        td, th_ = trf.raycast_field(tfield, torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(th), trc)
        assert np.mean(np_(th_) == np_(jh)) >= 0.999
        assert np.mean(np.abs(np_(td) - np_(jd)) <= trc.step) >= 0.998
    assert trf.as_ray_field(tf, trc) is tf
    for backend in ("lut", "cddt"):
        with pytest.raises(ValueError, match="per-step"):
            trf.dynamic_ray_field(torch.from_numpy(blocked), RaycastConfig(backend=backend))
    with pytest.raises(ValueError, match="field.edt"):
        trf.raycast_field(trf.RayField(blocked=torch.from_numpy(blocked)),
                          torch.zeros(1), torch.zeros(1), torch.zeros(1), trc)


def test_beam_weights_on_raw_mask_match_jax():
    """The beam measurement given a raw blocked mask and the sdf backend:
    the port rebuilds the field with `edt_jfa` (as JAX's
    `dynamic_ray_field` does) and sphere-traces every beam. rtol 1e-5,
    atol 1e-3 on at least 99% of the poses (a trig ulp may move one beam
    by a step)."""
    blocked = MASKS["room"]
    jrc = JRaycast(step=0.5, max_dist=60.0, backend="sdf")
    trc = RaycastConfig(step=0.5, max_dist=60.0, backend="sdf")
    lidar = JLidar(start=0.0, stop=3.14159, max_dist=60.0, n_rays=30)
    scan = jfake.scan(jnp.asarray(blocked), JPose.create(30.0, 20.0, 0.3), lidar,
                      JRaycast(max_dist=60.0))
    x, y, th = random_poses(np.random.default_rng(4), 256, blocked)
    jfield = jrf.RayField(blocked=jnp.asarray(blocked), edt=_jfa(jnp.asarray(blocked)))
    want = np_(jmeas.particle_log_weights(jfield, JPose.create(x, y, th), scan, rc=jrc))
    got = np_(tmeas.particle_log_weights(torch.from_numpy(blocked), convert.pose(x, y, th),
                                         t_scan(scan), rc=trc))
    close = np.isclose(got, want, rtol=1e-5, atol=1e-3)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} poses differ"
    assert np.ptp(want) > 1.0
