"""slam_tpu_torch.planners.astar against slam_tpu.planners.astar: the
distance field bit for bit (min is exact and every sum is one f32 add, so
the synchronous relaxation runs the same sequence), path recovery, the
planner facade; and the vehicle inflation against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.apps.common import inflate as jinflate
from slam_tpu.planners import astar as jastar
from slam_tpu_torch.planners import astar as tastar
from slam_tpu_torch.utils.maps import erode, inflate
from test_planners import dijkstra_oracle, wall_map
from torch_port import np_, room


def _bits(a):
    return np_(a).view(np.uint32)


def _maps():
    rng = np.random.default_rng(7)
    free = rng.random((40, 40)) > 0.25
    free[5, 5] = True
    return {"random": (free, (5, 5)), "wall": (wall_map(), (10, 10)),
            "room": (~room(40, 56), (20, 20))}


@pytest.mark.parametrize("name", ["random", "wall", "room"])
def test_distance_field_bitwise_and_oracle(name):
    free, start = _maps()[name]
    want = jastar.distance_field(jnp.asarray(free), jnp.asarray(start, jnp.int32))
    got = tastar.distance_field(torch.from_numpy(free), start)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    oracle = dijkstra_oracle(free, start)
    finite = np.isfinite(oracle)
    np.testing.assert_allclose(np_(got)[finite], oracle[finite], rtol=1e-5)
    assert np.all(np_(got)[~finite] >= 1e29)


def test_relax_round_bitwise():
    free, start = _maps()["random"]
    d0 = np.full(free.shape, 1e30, np.float32)
    d0[start] = 0.0
    for rounds in (1, 5):
        want = jastar.relax_round(jnp.asarray(d0), jnp.asarray(free), rounds)
        got = tastar.relax_round(torch.from_numpy(d0), torch.from_numpy(free), rounds)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_recover_path_and_facade():
    free = wall_map()
    jp = jastar.AStar(jnp.asarray(free), (10, 10), (10, 40))
    tp = tastar.AStar(free, (10, 10), (10, 40), device="cpu")
    assert jp.solve() and tp.solve()
    assert tp.recover_path() == jp.recover_path()
    assert tp.path_cost() == jp.path_cost()
    dist = np_(tp.dist)
    for goal in ((30, 40), (2, 47), (47, 0)):
        assert tastar.recover_path(dist, (10, 10), goal) == \
            jastar.recover_path(dist, (10, 10), goal)


def test_unreachable_and_incremental():
    free = np.ones((32, 32), bool)
    free[:, 16] = False
    p = tastar.AStar(free, (5, 5), (5, 25), device="cpu")
    assert not p.solve()
    assert p.recover_path() == []
    assert tastar.recover_path(np_(p.dist), (5, 5), (5, 25)) == []

    free = wall_map()
    jp = jastar.AStar(jnp.asarray(free), (10, 10), (10, 40))
    tp = tastar.AStar(free, (10, 10), (10, 40), device="cpu")
    n = 0
    while not tp.pathfind(rounds=8):
        assert not jp.pathfind(rounds=8)
        n += 1
        assert n < 100
    assert jp.pathfind(rounds=8) and tp.success and jp.success
    np.testing.assert_array_equal(_bits(tp.dist), _bits(jp.dist))
    assert tp.recover_path() == jp.recover_path()


@pytest.mark.parametrize("seed", [0, 1])
def test_inflate_matches_jax(seed):
    rng = np.random.default_rng(seed)
    blocked = rng.random((37, 51)) < 0.04
    for radius in range(8):
        np.testing.assert_array_equal(inflate(blocked, radius), jinflate(blocked, radius))
    u8 = (~blocked).astype(np.uint8)
    assert erode(u8, 3).dtype == np.uint8
