"""slam_tpu_torch.parallel.distributed: a world of processes over gloo
(the counterpart of tests/test_distributed.py): `initialize` with an
explicit `file://` store, `host_local_slice`, `replicate_to_all_hosts`
(a broadcast from rank 0), the mesh's divisibility refusal, lattice HA*
queries spread over the ranks, and a
ShardedMCL predict -> update across the processes held, on every rank,
to one process running the unsharded filter on all particles with the
same seed (the shards draw by global particle index, so the clouds agree
to the beam sums' rounding; the resampled cloud is compared whole)."""

import numpy as np
import pytest

import jax.numpy as jnp
from slam_tpu.core.config import LidarConfig, RaycastConfig
from slam_tpu.core.types import Pose as JPose
from slam_tpu.models import fake_lidar as jfake
from slam_tpu.models.simulate import synthetic_room
from slam_tpu_torch.parallel import distributed
from test_planners import wall_map
from torch_port import D, start_worlds

H = W = 64


@pytest.fixture(scope="module")
def run():
    blocked = synthetic_room(H, W)
    scan = jfake.scan(jnp.asarray(blocked), JPose.create(W / 2.0, H / 2.0, np.pi / 2),
                      LidarConfig(n_rays=16, max_dist=100.0),
                      RaycastConfig(max_dist=100.0, chunk=32))
    queries = np.array([[(10.0, 32.0, 0.0), (54.0, 32.0, 0.0)],
                        [(10.0, 10.0, 0.0), (50.0, 50.0, 0.0)],
                        [(54.0, 10.0, 0.0), (10.0, 50.0, 0.0)],
                        [(50.0, 50.0, 0.0), (10.0, 12.0, 0.0)]], np.float32)
    return start_worlds("distributed", {"blocked": blocked,
                                        "scan.angles": np.asarray(scan.angles),
                                        "scan.dists": np.asarray(scan.dists),
                                        "ha.free": wall_map(64, 64, gap=(28, 38)),
                                        "ha.queries": queries})()


@pytest.mark.parametrize("d", D)
def test_initialize_slices_and_broadcast(run, d):
    for r, o in enumerate(run[d]):
        assert bool(o["dist.multihost"])
        per = 64 // d
        np.testing.assert_array_equal(o["dist.slice"], [r * per, (r + 1) * per])
        # Rank 0's values everywhere.
        np.testing.assert_array_equal(o["dist.a"], [0, 1, 2])
        assert float(o["dist.b"]) == 1.5 and int(o["dist.c0"]) == 0
        assert "not divisible by beam_axis=3" in str(o["dist.refuse_mesh"])


@pytest.mark.parametrize("d", D)
def test_multi_process_mcl_step_matches_one_process(run, d):
    for o in run[d]:
        assert float(o["dist.step_max_diff"]) < 1e-3
        assert float(o["dist.multinomial_max_diff"]) < 1e-3
        assert float(o["dist.best_diff"]) < 1e-4
        assert int(o["dist.n_local"]) == 64 // d


@pytest.mark.parametrize("d", D)
def test_solve_many_query_sharding_matches_unsharded(run, d):
    """Lattice HA* queries spread over the ranks (`solve_many(
    query_sharding=...)`): every rank gets every query's result and path,
    equal to one process solving them all."""
    for o in run[d]:
        assert bool(o["ha.same"]) and int(o["ha.solved"]) >= 2


def test_single_process_helpers():
    """Outside a world: one process owns every particle, and broadcast is
    the identity."""
    assert not distributed.is_multihost()
    assert distributed.host_local_slice(64) == slice(0, 64)
    tree = {"a": np.arange(3), "b": 1.5}
    assert distributed.replicate_to_all_hosts(tree) is tree


def test_initialize_defaults_to_the_card(tmp_path):
    """With no device, `initialize` puts the rank on the card, as the
    port's entry points do: without a CUDA device it raises before it
    joins a world and names `device="cpu"`; with one, a world of one rank
    over NCCL on cuda:0."""
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            distributed.initialize(f"file://{tmp_path}/store", 1, 0)
        assert not torch.distributed.is_initialized()
        return
    try:
        dev = distributed.initialize(f"file://{tmp_path}/store", 1, 0)
        assert dev == torch.device("cuda", 0)
        assert torch.distributed.get_backend() == "nccl"
    finally:
        distributed.shutdown()
