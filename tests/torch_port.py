"""Helpers for the slam_tpu_torch parity tests.

Inputs are made with numpy from a seed, go through the JAX function (on
the CPU) and its port, and the results come back as numpy arrays for the
comparison. State crosses from JAX to torch as numpy arrays through
`slam_tpu_torch.utils.convert`.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from slam_tpu.models.simulate import synthetic_room
from slam_tpu_torch.parallel import distributed
from slam_tpu_torch.utils import convert

# The tier-1 run shares 8 cores among 6 workers.
torch.set_num_threads(2)


class HostSync(RuntimeError):
    pass


def _raise(*_a, **_k):
    raise HostSync("a host read of a tensor inside a graphed block")


def _host_index(idx) -> bool:
    """An index the C++ side reads on the host: a 0-d integer tensor (made
    a Python int) or a bool mask (`nonzero`)."""
    items = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(i, torch.Tensor) and (i.dtype == torch.bool or i.dim() == 0)
               for i in items)


@contextlib.contextmanager
def no_host_reads():
    """Every host read of a tensor raises inside: `__bool__`, `item`,
    `tolist`, `cpu`, `numpy`, `nonzero`, int / float / index conversion,
    and indexing by a 0-d tensor or a bool mask."""
    get, put = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def checked_get(self, idx):
        if _host_index(idx):
            _raise()
        return get(self, idx)

    def checked_put(self, idx, v):
        if _host_index(idx):
            _raise()
        return put(self, idx, v)

    patches = {name: _raise for name in ("__bool__", "item", "tolist", "cpu", "numpy",
                                         "nonzero", "__int__", "__float__", "__index__")}
    patches.update(__getitem__=checked_get, __setitem__=checked_put)
    saved = {name: torch.Tensor.__dict__.get(name) for name in patches}
    saved_nonzero = torch.nonzero
    try:
        for name, fn in patches.items():
            setattr(torch.Tensor, name, fn)
        torch.nonzero = _raise
        yield
    finally:
        for name, fn in saved.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)
        torch.nonzero = saved_nonzero


def np_(a) -> np.ndarray:
    """A JAX or torch array as numpy (bf16 as float32)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def table_bits(lut) -> np.ndarray:
    """A JAX LUT as numpy: bf16 as its uint16 bits, u8 as is."""
    a = np.asarray(lut)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def torch_table_bits(lut: torch.Tensor) -> np.ndarray:
    """A port LUT as numpy, in the encoding of `table_bits`."""
    if lut.dtype == torch.bfloat16:
        return lut.view(torch.int16).numpy().view(np.uint16)
    return lut.numpy()


def t_pose(p):
    """A JAX Pose as a port Pose."""
    return convert.pose(np.asarray(p.x), np.asarray(p.y), np.asarray(p.theta))


def t_scan(s):
    return convert.scan(np.asarray(s.angles), np.asarray(s.dists))


def t_field(f):
    """A JAX RayField (march or lut) as a port RayField."""
    lut = None if f.lut is None else table_bits(f.lut)
    return convert.ray_field(np.asarray(f.blocked), lut, f.lut_bins)


def room(h: int = 96, w: int = 128) -> np.ndarray:
    return synthetic_room(h, w)


def random_poses(rng, n: int, blocked: np.ndarray, margin: float = 3.0):
    """f32 (x, y, theta) of n poses in the map's interior."""
    h, w = blocked.shape
    x = rng.uniform(margin, w - margin, n).astype(np.float32)
    y = rng.uniform(margin, h - margin, n).astype(np.float32)
    th = rng.uniform(-math.pi, math.pi, n).astype(np.float32)
    return x, y, th


def jax_noise(key, shape):
    """The three normal draws `slam_tpu.ops.motion` takes from `key`, as
    torch tensors."""
    k1, k2, k3 = jax.random.split(key, 3)
    return tuple(convert.tensor(jax.random.normal(k, shape)) for k in (k1, k2, k3))


class _OneRankMesh:
    """A ('p', 'b') mesh of one rank, without a process group: its axes
    have size 1, so no collective is ever called."""

    shape = {"p": 1, "b": 1}

    def axis(self, name):
        from slam_tpu_torch.parallel._collectives import Axis

        return Axis(name, None, 1, 0, "gloo")


def one_rank_sharding():
    """A ray sharding over a one-rank mesh: the sharded code paths of the
    model functions with nothing to exchange."""
    from slam_tpu_torch.parallel.mesh import Sharding

    return Sharding(_OneRankMesh(), ("p", "b"))


# --------------------------------------------------------------------------
# Worlds of ranks for the parallel/ tests (tests/test_torch_{parallel,
# mapshard,distributed}.py): each module writes its inputs, starts one world
# of each size over gloo, computes the JAX side while they run, and waits.
# --------------------------------------------------------------------------

D = [2, 4]
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
# Wall clock of one world (all its scenarios); ranks left then are killed.
WORLD_LIMIT_S = 300.0


def start_worlds(suite: str, inputs: dict, sizes=(2, 4)):
    """Write `inputs` and start one world of each size in `sizes`; returns
    a function that waits for them and returns {D: [rank outputs]}."""
    base = tempfile.mkdtemp(prefix=f"torch_{suite}_")
    path = os.path.join(base, "inputs.npz")
    np.savez(path, **inputs)
    env = dict(os.environ, PYTHONWARNINGS="ignore", OMP_NUM_THREADS="1")
    handles = {}
    for d in sizes:
        out = os.path.join(base, f"d{d}")
        os.makedirs(out)
        handles[d] = (out, distributed.start_world(
            [sys.executable, WORKER, suite, path, out], d, timeout_s=WORLD_LIMIT_S, env=env))

    def wait():
        try:
            res = {}
            for d, (out, h) in handles.items():
                rcs, _, errs, _ = h.wait()
                if rcs != [0] * d:
                    tails = "\n".join(f"rank {r} rc {rc}:\n{e[-3000:]}" for r, (rc, e)
                                      in enumerate(zip(rcs, errs)) if rc != 0)
                    raise AssertionError(f"world of {d} ranks failed: {rcs}\n{tails}")
                res[d] = [dict(np.load(os.path.join(out, f"out_r{r}.npz")))
                          for r in range(d)]
            return res
        finally:
            for _, h in handles.values():
                h.wait()  # every rank ended or killed before the files go
            shutil.rmtree(base, ignore_errors=True)

    return wait


def draws(key, n):
    """JAX's predict noise and resampler uniform of one predict -> update
    from state key `key`, and the key after it."""
    key, sub = jax.random.split(key)
    nxt, k_rs, _ = jax.random.split(key, 3)
    noise = np.stack([v.numpy() for v in jax_noise(sub, (n,))])
    return noise, np.asarray(jax.random.uniform(k_rs, ())), nxt


def assert_angles_close(a, b, atol):
    d = np.abs((np.asarray(a, np.float64) - np.asarray(b, np.float64) + np.pi)
               % (2 * np.pi) - np.pi)
    assert d.max() <= atol, f"angle diff {d.max()} > {atol}"


# --------------------------------------------------------------------------
# The closed loops that tests/test_torch_globalloc.py holds to the JAX
# tests' bounds, in either package, and seed sweeps of them: how often each
# package meets the bounds, on the CPU. From the repo root:
#
#     PYTHONPATH=. python tests/torch_port.py kidnap 0 40
#     PYTHONPATH=. python tests/torch_port.py globalloc 0 40
# --------------------------------------------------------------------------


def kidnap_errors(package: str, seed: int):
    """Mode-pose errors of tests/test_mcl.py:347-392's loop (kidnap before
    step 11), filter seed `seed`, truth seed `seed + 100`."""
    blocked_np = synthetic_room(128, 128)
    if package == "jax":
        from slam_tpu.core import config as jc
        from slam_tpu.core.types import Odometry as JOdometry, Pose as JPose
        from slam_tpu.models import fake_lidar, mcl
        from slam_tpu.ops import edt, motion
        from slam_tpu.ops.rayfield import RayField

        blocked = jnp.asarray(blocked_np)
        rc = jc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
        field = RayField(blocked=blocked, edt=edt.edt_jfa(blocked))
        cfg = jc.MCLConfig(n_particles=1024, meas_stddev=3.0, measurement="likelihood_field",
                           adaptive=jc.AdaptiveConfig(max_ratio=0.1))
        lidar = jc.LidarConfig(max_dist=60.0, n_rays=36)
        upd = jax.jit(lambda s, z: mcl.update(s, z, field, cfg, rc))
        scan = jax.jit(lambda p: fake_lidar.scan(blocked, p, lidar, rc))
        gt = JPose.create(40.0, 40.0, 0.3)
        st = mcl.init(jax.random.key(seed), 1024, gt)
        odom, key, errs = JOdometry.create(0.03, 1.2, 0.03), jax.random.key(seed + 100), []
        for t in range(50):
            if t == 10:
                gt = JPose.create(90.0, 90.0, -0.8)
            k, _ = jax.random.split(jax.random.fold_in(key, t))
            gt = motion.sample_motion_model_odometry(k, odom, gt, (0.002,) * 4)
            st = upd(mcl.predict(st, odom, (0.002,) * 4), scan(gt))
            errs.append(float(jnp.hypot(st.mode_pose.x - gt.x, st.mode_pose.y - gt.y)))
        return errs
    from slam_tpu_torch.core import config as tc
    from slam_tpu_torch.core.types import Odometry, Pose
    from slam_tpu_torch.models import fake_lidar, mcl
    from slam_tpu_torch.ops import edt, motion
    from slam_tpu_torch.ops.rayfield import RayField

    blocked = torch.from_numpy(blocked_np)
    rc = tc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    field = RayField(blocked=blocked, edt=edt.edt_jfa(blocked))
    cfg = tc.MCLConfig(n_particles=1024, meas_stddev=3.0, measurement="likelihood_field",
                       adaptive=tc.AdaptiveConfig(max_ratio=0.1))
    lidar = tc.LidarConfig(max_dist=60.0, n_rays=36)
    gt = Pose.create(40.0, 40.0, 0.3)
    st = mcl.init(seed, 1024, gt)
    odom, g, errs = Odometry.create(0.03, 1.2, 0.03), mcl.make_generator(seed + 100), []
    for t in range(50):
        if t == 10:
            gt = Pose.create(90.0, 90.0, -0.8)
        gt = motion.sample_motion_model_odometry(odom, gt, (0.002,) * 4, generator=g)
        st = mcl.update(mcl.predict(st, odom, (0.002,) * 4), fake_lidar.scan(blocked, gt, lidar, rc),
                        field, cfg, rc)
        errs.append(math.hypot(float(st.mode_pose.x - gt.x), float(st.mode_pose.y - gt.y)))
    return errs


def globalloc_run(package: str, seed: int):
    """tests/test_mcl.py:501-545's loop (2048 particles from init_uniform,
    the auto tier, 12 steps), init seed `seed`, truth seed `seed + 1`:
    (its MCLConfig, the init_uniform state, the final state, the final
    mean-pose error)."""
    blocked_np = synthetic_room(128, 128)
    if package == "jax":
        from slam_tpu.core import config as jc
        from slam_tpu.core.types import Odometry as JOdometry, Pose as JPose
        from slam_tpu.models import fake_lidar, mcl
        from slam_tpu.ops import edt, motion
        from slam_tpu.ops.rayfield import RayField

        blocked = jnp.asarray(blocked_np)
        rc = jc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
        field = RayField(blocked=blocked, edt=edt.edt_jfa(blocked))
        cfg = jc.MCLConfig(n_particles=2048, meas_stddev=3.0,
                           measurement="likelihood_field_auto", lf_table_box=32)
        lidar = jc.LidarConfig(max_dist=60.0, n_rays=36)
        upd = jax.jit(lambda s, z: mcl.update(s, z, field, cfg, rc))
        scan = jax.jit(lambda p: fake_lidar.scan(blocked, p, lidar, rc))
        st0 = st = mcl.init_uniform(jax.random.key(seed), 2048, blocked)
        gt, odom, key = JPose.create(40.0, 40.0, 0.3), JOdometry.create(0.05, 1.5, 0.05), \
            jax.random.key(seed + 1)
        for _ in range(12):
            key, kgt = jax.random.split(key)
            gt = motion.sample_motion_model_odometry(kgt, odom, gt, (0.002,) * 4)
            st = upd(mcl.predict(st, odom, (0.002,) * 4), scan(gt))
        mp = mcl.mean_pose(st)
        return cfg, st0, st, float(jnp.hypot(mp.x - gt.x, mp.y - gt.y))
    from slam_tpu_torch.core import config as tc
    from slam_tpu_torch.core.types import Odometry, Pose
    from slam_tpu_torch.models import fake_lidar, mcl
    from slam_tpu_torch.ops import edt, motion
    from slam_tpu_torch.ops.rayfield import RayField

    blocked = torch.from_numpy(blocked_np)
    rc = tc.RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    field = RayField(blocked=blocked, edt=edt.edt_jfa(blocked))
    cfg = tc.MCLConfig(n_particles=2048, meas_stddev=3.0, measurement="likelihood_field_auto",
                       lf_table_box=32)
    lidar = tc.LidarConfig(max_dist=60.0, n_rays=36)
    st0 = st = mcl.init_uniform(seed, 2048, blocked)
    gt, odom, g = Pose.create(40.0, 40.0, 0.3), Odometry.create(0.05, 1.5, 0.05), \
        mcl.make_generator(seed + 1)
    for _ in range(12):
        gt = motion.sample_motion_model_odometry(odom, gt, (0.002,) * 4, generator=g)
        st = mcl.update(mcl.predict(st, odom, (0.002,) * 4), fake_lidar.scan(blocked, gt, lidar, rc),
                        field, cfg, rc)
    mp = mcl.mean_pose(st)
    return cfg, st0, st, math.hypot(float(mp.x - gt.x), float(mp.y - gt.y))


def glbench_run(package: str, seed: int, n: int, plant: int = 0, steps: int = 60) -> dict:
    """tools/global_loc_bench.py's loop (the synthetic floor plan, the
    360-bin bf16 LUT, 90 beams) at `n` particles, init seed `seed`, with
    `plant` particles moved next to the truth's start pose by the same
    numpy draws (seed + 200) in both packages: the port tool's summary of
    the run and its `near_start` counts."""
    from slam_tpu_torch.tools import global_loc_bench as glb
    from slam_tpu_torch.utils.maps import synthetic_floor_plan

    blocked_np = synthetic_floor_plan()
    noise = np.random.default_rng(seed + 200).standard_normal((3, plant)).astype(np.float32)
    if package == "jax":
        from slam_tpu.core import config as jc
        from slam_tpu.core.types import Pose as JPose
        from slam_tpu.models import fake_lidar, mcl, simulate
        from slam_tpu.ops import motion, rayfield
        from slam_tpu.ops.measurement import sensor_pose

        blocked = jnp.asarray(blocked_np)
        lidar = jc.LidarConfig(start=0.0, stop=np.pi, max_dist=500.0, n_rays=90)
        rc = jc.RaycastConfig(step=0.5, max_dist=500.0, backend="lut")
        cfg = jc.MCLConfig(n_particles=n, meas_stddev=5.0,
                           lut_beam_stride=jc.beam_bin_stride(lidar, rc))
        field = rayfield.make_ray_field(blocked, rc)
        m = mcl.MCL(cfg, rc)
        scan = jax.jit(lambda p: fake_lidar.scan(
            blocked, p, lidar, jc.RaycastConfig(step=0.5, max_dist=500.0)))
        st = mcl.init_uniform(jax.random.key(seed), n, blocked)
        if plant:
            pp = st.particles.pose
            planted = [jnp.asarray(c + s_ * noise[i]) for i, (c, s_) in enumerate(zip(
                glb.START, (glb.PLANT_PX, glb.PLANT_PX, glb.PLANT_RAD)))]
            pp = JPose(x=pp.x.at[:plant].set(planted[0]), y=pp.y.at[:plant].set(planted[1]),
                       theta=pp.theta.at[:plant].set(planted[2]))
            st = st.replace(particles=st.particles.replace(pose=pp))
        near = glb.near_start(t_pose(st.particles.pose))
        gt, key = JPose.create(*glb.START), jax.random.key(seed + 100)
        stats, truths = [], []
        for t, odom in enumerate(simulate.forward_arc_commands(steps, trans=2.5, rot=0.04)):
            kg, _ = jax.random.split(jax.random.fold_in(key, t))
            gt = motion.sample_motion_model_odometry(kg, odom, gt, glb.ALPHAS)
            st = m.update(m.predict(st, odom, glb.ALPHAS), scan(sensor_pose(gt, cfg.scanner_offset)),
                          field)
            mp = mcl.mean_pose(st)
            stats.append([float(mp.x), float(mp.y), float(jnp.std(st.particles.pose.x)),
                          float(jnp.std(st.particles.pose.y))])
            truths.append([float(gt.x), float(gt.y), float(gt.theta)])
        return {**glb.summarize(torch.tensor(stats), np.array(truths)), "near_start": near}
    from slam_tpu_torch.models import mcl
    from slam_tpu_torch.models.simulate import forward_arc_commands
    from slam_tpu_torch.ops import rayfield

    blocked = torch.from_numpy(blocked_np)
    lidar, rc, scan_rc, cfg = glb.configs(n)
    cmds = forward_arc_commands(steps, trans=2.5, rot=0.04)
    truths, scans = glb.truth_and_scans(blocked, lidar, scan_rc, cfg, seed, cmds)
    st = mcl.init_uniform(seed, n, blocked)
    if plant:
        st = glb.plant(st, torch.from_numpy(noise))
    near = glb.near_start(st.particles.pose)
    _, stats, _ = glb.run(st, rayfield.make_ray_field(blocked, rc), cmds, scans, cfg, rc)
    return {**glb.summarize(stats, truths), "near_start": near}


def _sweep(which: str, lo: int, hi: int, *extra: int) -> None:
    import json

    jax.config.update("jax_platforms", "cpu")
    for package in ("port", "jax"):
        ok = 0
        for seed in range(lo, hi):
            if which == "kidnap":
                e = kidnap_errors(package, seed)
                met = e[9] < 2.0 and min(e[10:]) < 3.0 and float(np.mean(e[-10:])) < 4.0
                res = {"before": e[9], "min_after": min(e[10:]), "mean_last_10": float(np.mean(e[-10:]))}
            elif which == "glbench":
                res = glbench_run(package, seed, *extra)
                met = res["converged_at_step"] is not None
            else:
                err = globalloc_run(package, seed)[3]
                met, res = err < 10.0, {"final_error": err}
            ok += met
            print(json.dumps({"loop": which, "package": package, "seed": seed, "met": bool(met), **res}),
                  flush=True)
        print(json.dumps({"loop": which, "package": package, "seeds": [lo, hi],
                          "met_bounds": ok}), flush=True)


if __name__ == "__main__":
    import sys

    torch.set_num_threads(4)
    # kidnap LO HI | globalloc LO HI | glbench LO HI PARTICLES [PLANT]
    _sweep(*sys.argv[1:2], *(int(v) for v in sys.argv[2:]))
