"""slam_tpu_torch.planners.rrtstar against slam_tpu.planners.rrtstar with
JAX's own draws injected (`samples=`): one round from carried JAX state,
and whole searches. Edge checks go through atan2 and the sphere trace's
cos / sin, which differ by an ulp between XLA:CPU and torch, so costs
are held to a tolerance."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.apps.common import inflate as jinflate
from slam_tpu.core.config import RaycastConfig as JRaycast
from slam_tpu.core.config import RRTStarConfig as JCfg
from slam_tpu.ops import rayfield as jrayfield
from slam_tpu.planners import rrtstar as jrrt
from slam_tpu_torch.core.config import RaycastConfig, RRTStarConfig
from slam_tpu_torch.ops import rayfield
from slam_tpu_torch.ops.raycast import raycast_march
from slam_tpu_torch.planners import RRTStar
from slam_tpu_torch.planners import rrtstar as trrt
from slam_tpu_torch.utils import convert
from slam_tpu_torch.utils.maps import inflate, synthetic_floor_plan
from test_planners import wall_map
from torch_port import np_

KW = dict(reach=6.0, radius=12.0, max_nodes=1024, batch=64)


def jax_draws(key, rounds: int, batch: int, shape):
    """The (sx, sy) f32[rounds, batch] that `_rrt_round` draws from `key`
    over `rounds` rounds (one 3-way split per round)."""
    h, w = shape
    sx, sy = [], []
    for _ in range(rounds):
        key, k_x, k_y = jax.random.split(key, 3)
        sx.append(np.asarray(jax.random.uniform(k_x, (batch,), minval=0.0, maxval=float(w))))
        sy.append(np.asarray(jax.random.uniform(k_y, (batch,), minval=0.0, maxval=float(h))))
    return np.stack(sx), np.stack(sy)


def _carry(st):
    return convert.rrt_state(**{f: np.asarray(getattr(st, f)) for f in (
        "x", "y", "cost", "parent", "valid", "size", "best_goal_node", "best_goal_cost")})


@pytest.mark.parametrize("n_rounds", [0, 3])
def test_round_from_carried_state(n_rounds):
    free = wall_map(64, 64, gap=(26, 40))
    a, b = (12.0, 32.0), (52.0, 32.0)
    jp = jrrt.RRTStar(jnp.asarray(free), a, b, JCfg(**KW), seed=3)
    for _ in range(n_rounds):
        jp.pathfind()
    jp._ensure_query_state()
    st = jp.state
    sx, sy = jax_draws(st.key, 1, KW["batch"], free.shape)
    jnext = jrrt._rrt_round_jit(st, jp.field, jp._goal, jp.cfg, jp.rc, jp.neighbor_cap)
    tp = RRTStar(free, a, b, RRTStarConfig(**KW), device="cpu")
    tnext = trrt._rrt_round(_carry(st), tp.field, tp._goal, tp.cfg, tp.rc, tp.neighbor_cap,
                            torch.from_numpy(sx[0]), torch.from_numpy(sy[0]))
    assert int(tnext.size) == int(jnext.size) > int(st.size)
    assert int(tnext.best_goal_node) == int(jnext.best_goal_node)
    for f in ("parent", "valid"):
        np.testing.assert_array_equal(np_(getattr(tnext, f)), np_(getattr(jnext, f)), f)
    for f in ("x", "y"):
        np.testing.assert_allclose(np_(getattr(tnext, f)), np_(getattr(jnext, f)), atol=1e-5)
    np.testing.assert_allclose(np_(tnext.cost), np_(jnext.cost), rtol=1e-5)


@pytest.mark.parametrize("case", ["open", "wall"])
def test_solve_with_injected_draws(case):
    """Same success, tree size and round count; path cost within 1e-4."""
    if case == "open":
        free, a, b, seed, rounds = np.ones((64, 64), bool), (10.0, 10.0), (52.0, 50.0), 7, 60
    else:
        free, a, b, seed, rounds = wall_map(64, 64, gap=(26, 40)), (12.0, 32.0), (52.0, 32.0), 3, 120
    jp = jrrt.RRTStar(jnp.asarray(free), a, b, JCfg(**KW), seed=seed)
    j_rounds = 0
    while not jp.pathfind():
        j_rounds += 1
    j_rounds += 1
    assert jp.success
    sx, sy = jax_draws(jax.random.key(seed), rounds, KW["batch"], free.shape)
    tp = RRTStar(free, a, b, RRTStarConfig(**KW), device="cpu")
    assert tp.solve(max_rounds=rounds, samples=(sx, sy))
    assert tp.rounds == j_rounds and tp.size == int(jp.state.size)
    assert abs(tp.path_cost() - jp.path_cost()) <= 1e-4 * jp.path_cost()
    path = tp.recover_path()
    assert path[0] == b and math.hypot(path[-1][0] - a[0], path[-1][1] - a[1]) < 1e-3
    jpath = jp.recover_path()
    assert len(path) == len(jpath)
    np.testing.assert_allclose(np.asarray(path), np.asarray(jpath), atol=1e-4)


def test_generator_reproduces_and_latches():
    free = wall_map(64, 64, gap=(26, 40))
    cfg = RRTStarConfig(**KW)
    runs = []
    for _ in range(2):
        p = RRTStar(free, (12.0, 32.0), (52.0, 32.0), cfg, seed=5, device="cpu")
        assert p.solve(max_rounds=120)
        runs.append((p.rounds, p.size, p.path_cost(), p.recover_path()))
    assert runs[0] == runs[1]
    p.reset_query((12.0, 32.0), (52.0, 32.0), seed=6)
    assert p.size == 1 and not p.success
    n = 0
    while not p.pathfind():
        n += 1
        assert n < 120
    assert p.success
    # A fully blocked map never grows: the node budget latch, no success.
    blocked = np.zeros((32, 32), bool)
    blocked[10:13, 10:13] = True
    q = RRTStar(blocked, (11.0, 20.0), (30.0, 30.0),
                RRTStarConfig(reach=4.0, radius=8.0, max_nodes=128, batch=32), seed=0,
                device="cpu")
    assert not q.solve(max_rounds=30) and q.recover_path() == []
    with pytest.raises(ValueError, match="radius"):
        RRTStar(free, (1.0, 1.0), (2.0, 2.0), RRTStarConfig(reach=10.0, radius=5.0),
                device="cpu")


# An edge of the path that `chip_smoke.py` phase 14's RRT* (seed 1235, on an
# H100) found on the synthetic floor plan inflated by 7: (x0, y0) is the
# parent node, (x1, y1) the child. It clips 0.50 px of a blocked corner.
CLIP_EDGE = (826.7601928710938, 308.2594909667969, 834.4961547851562, 289.81622314453125)


def test_corner_clip_edge_is_clear_in_both_packages():
    """The fixed-step march flags CLIP_EDGE; the planners' own collision
    check (the sdf sphere trace, RRTStar's ray config) accepts it, in the
    JAX package as in the port."""
    plan = synthetic_floor_plan()
    kw = dict(backend="sdf", step=1.0, max_dist=52.0)  # RRTStar clamps rays to radius + 2
    jrc, rc = JRaycast(**kw), RaycastConfig(**kw)
    jfield = jrayfield.make_ray_field(jnp.asarray(jinflate(plan, 7)), jrc)
    blocked = torch.from_numpy(inflate(plan, 7))
    field = rayfield.make_ray_field(blocked, rc)
    x0, y0, x1, y1 = (np.float32(v) for v in CLIP_EDGE)
    j_ok = jrrt._edges_clear(jfield, jrc, *(jnp.asarray([v]) for v in (x0, y0, x1, y1)))
    t_ok = trrt._edges_clear(field, rc, *(torch.tensor([v]) for v in (x0, y0, x1, y1)))
    assert bool(j_ok[0]) and bool(t_ok[0])
    d = math.hypot(x1 - x0, y1 - y0)
    dist, hit = raycast_march(blocked, torch.tensor([x0]), torch.tensor([y0]),
                              torch.tensor([math.atan2(y1 - y0, x1 - x0)]), step=1.0,
                              max_dist=d + 2.0)
    assert bool(hit[0]) and float(dist[0]) < d
