"""slam_tpu_torch's apps through `main([..., "--cpu"])` at tests/test_apps.py's
sizes, held to the JAX apps' bounds on the same seeds; the checkpoint
resume of grid_slam bit for bit; and every app refusing to run without a
card unless given `--cpu`."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from slam_tpu.apps import fleet_localization as jfleet_app
from slam_tpu.apps.slam_replan import pick_waypoint as jpick_waypoint
from slam_tpu_torch.apps import (
    astar_planner,
    fleet_localization,
    grid_slam,
    hastar_planner,
    nearest_neighbor,
    regions,
    rrt_planner,
    slam_replan,
)

GRID_SLAM = ["--particles", "64", "--steps", "20", "--n-rays", "12", "--max-dist", "60",
             "--frame-every", "5"]
HASTAR = ["--velocity", "5", "--batch", "64", "--inflate", "2", "--start", "40", "64",
          "--goal", "200", "64"]
# tests/test_apps.py's RRT* arguments with 2048 nodes, not 1024: the JAX
# app finds its path at the 1024th node on seed 1234's draws (and none on
# seeds 0, 1, 1235 or 1236); the port's draws find one at 1086 nodes.
RRT = ["--n-points", "100", "--reach", "8", "--radius", "16", "--max-nodes", "2048",
       "--batch", "64", "--inflate", "2"]


def _quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        return fn(argv), buf.getvalue()


@pytest.mark.parametrize("mode, bound", [("slam", 30.0), ("loc", 20.0)])
def test_grid_slam_app_within_the_jax_apps_bound(tmp_path, mode, bound):
    """tests/test_apps.py's grid_slam runs on seed 0, held to that test's
    bounds (ATE < 30 px in SLAM mode, < 20 in localization mode), which
    the JAX app meets on the same arguments (2.61 and 0.50 px on the CPU;
    the port 2.97 and 0.69: the two draw their own noise)."""
    extra = ["--steps", "15"] if mode == "loc" else []
    ate, text = _quiet(grid_slam.main, [*GRID_SLAM, "--mode", mode, *extra, "--cpu",
                                        "--out", str(tmp_path / "t.gif")])
    assert ate < bound, ate
    assert (tmp_path / "t.gif").exists() and f"ATE={ate:.2f}px" in text


def test_grid_slam_checkpoint_resume_is_bit_exact(tmp_path):
    """A --checkpoint-dir run cut in two ends with the same checkpoint as
    an uninterrupted run, bit for bit: the filter, the ground truth and
    the loop's generators all ride along."""
    common = ["--particles", "64", "--n-rays", "12", "--max-dist", "60", "--frame-every",
              "100", "--checkpoint-every", "5", "--out", str(tmp_path / "c.gif"), "--cpu"]
    _quiet(grid_slam.main, [*common, "--steps", "20", "--checkpoint-dir", str(tmp_path / "a")])
    _quiet(grid_slam.main, [*common, "--steps", "10", "--checkpoint-dir", str(tmp_path / "b")])
    _, text = _quiet(grid_slam.main, [*common, "--steps", "20",
                                      "--checkpoint-dir", str(tmp_path / "b")])
    assert "resumed from step 9" in text
    a = torch.load(tmp_path / "a" / "19" / "state.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "19" / "state.pt", weights_only=True)

    def flat(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, path + (k,))
        else:
            yield path, tree.numpy().tobytes() if isinstance(tree, torch.Tensor) else tree

    assert dict(flat(a)) == dict(flat(b))
    assert int(a["state"]["mcl"]["updates"]) == 20


def test_planner_apps_and_animations(tmp_path):
    """The A*, HA* and RRT* apps find their paths, free of the inflated
    map, and write the search animations."""
    for name, fn, argv in (("a", astar_planner.main, []),
                           ("h", hastar_planner.main, [*HASTAR, "--animate-every", "8"]),
                           ("r", rrt_planner.main, RRT)):
        res = {}
        with contextlib.redirect_stdout(io.StringIO()):
            ok = fn([*argv, "--out", str(tmp_path / f"{name}.png"),
                     "--animate", str(tmp_path / f"{name}.gif"), "--cpu"], result=res)
        assert ok and res["path"], name
        if name == "r":
            h = res["free"].shape[0]
            cells = [(int(np.floor(h - y - 1.0)), int(np.floor(x))) for x, y in res["path"]]
        else:
            cells = res["path"]
        assert all(res["free"][i, j] for i, j in cells), name
        assert (tmp_path / f"{name}.gif").exists()


def test_interactive_replanning(tmp_path, monkeypatch):
    """Warm repeated-query replanning from stdin, as tests/test_apps.py."""
    monkeypatch.setattr("sys.stdin", io.StringIO("40 40 100 100\nquit\n"))
    ok, _ = _quiet(rrt_planner.main, [
        "--out", str(tmp_path / "r.png"), "--n-points", "50", "--reach", "16", "--radius",
        "32", "--max-nodes", "1024", "--batch", "64", "--inflate", "2", "--interactive",
        "--cpu"])
    assert ok and (tmp_path / "r_1.png").exists()
    monkeypatch.setattr("sys.stdin", io.StringIO("start 40 40\ngoal 100 100\nq\n"))
    ok, _ = _quiet(hastar_planner.main, [*HASTAR, "--out", str(tmp_path / "h.png"),
                                         "--interactive", "--cpu"])
    assert ok and (tmp_path / "h_1.png").exists()


def test_nn_and_regions_apps(tmp_path):
    """The brute-force cross-checks pass, with the index visualizations."""
    _, text = _quiet(nearest_neighbor.main, ["--n", "200", "--queries", "3", "--check",
                                             "--draw-partition", "--size", "64",
                                             "--out", str(tmp_path / "n.png"), "--cpu"])
    assert "brute-force check OK" in text
    _, text = _quiet(regions.main, ["--n", "300", "--boxes", "2", "--check", "--draw-tree",
                                    "--out", str(tmp_path / "g.png"), "--cpu"])
    assert "brute-force check OK" in text and (tmp_path / "g.png").exists()


def test_fleet_localization_app_within_the_jax_apps_bound(tmp_path):
    """tests/test_apps.py's fleet run (mean ATE < 10 px) in both packages
    on seed 0; the port's fleet steps go through `models/fleet.py`."""
    argv = ["--map", "", "--robots", "2", "--particles", "256", "--steps", "8", "--beams",
            "16", "--backend", "sdf", "--cpu"]
    ate, text = _quiet(fleet_localization.main, [*argv, "--out", str(tmp_path / "t.png")])
    jate, _ = _quiet(jfleet_app.main, [*argv, "--out", str(tmp_path / "j.png")])
    assert ate < 10.0 and jate < 10.0, (ate, jate)
    assert text.count("ATE") == 3 and (tmp_path / "t.png").exists()


def test_slam_replan_app(tmp_path):
    """tests/test_apps.py's closed navigation loop: it plans at least
    twice and reaches the goal or closes most of the gap."""
    rc, text = _quiet(slam_replan.main, [
        "--size", "96", "--particles", "128", "--steps", "220", "--n-rays", "16",
        "--max-dist", "50", "--table-box", "32", "--replan-every", "25", "--speed", "2.0",
        "--planner-batch", "64", "--max-rounds", "600", "--tol", "8",
        "--out", str(tmp_path / "nav.png"), "--cpu"])
    rec = json.loads(text.strip().splitlines()[-1])
    assert rec["n_replans"] >= 2 and rec["steps"] > 10
    assert rec["reached"] or rec["final_gt_err"] < 40.0, rec
    assert rc == (0 if rec["reached"] else 1)


@pytest.mark.parametrize("robot_x", [30.0, 45.5])
def test_pick_waypoint_equals_jax(robot_x):
    from slam_tpu_torch.apps.slam_replan import cell_to_world

    path = [(32, j) for j in range(2, 60)]
    for lookahead in (4.0, 8.0, 100.0):
        assert (slam_replan.pick_waypoint(path, 64, robot_x, 31.5, lookahead)
                == jpick_waypoint(path, 64, robot_x, 31.5, lookahead))
    ex, ey = cell_to_world(64, *path[-1])
    assert slam_replan.pick_waypoint(path, 64, ex + 3.0, ey, 8.0) == (ex, ey)


APPS = {
    "grid_slam": (grid_slam, []),
    "fleet_localization": (fleet_localization, ["--map", ""]),
    "slam_replan": (slam_replan, ["--size", "32"]),
    "astar_planner": (astar_planner, []),
    "hastar_planner": (hastar_planner, []),
    "rrt_planner": (rrt_planner, []),
    "nearest_neighbor": (nearest_neighbor, []),
    "regions": (regions, []),
}


@pytest.mark.parametrize("name", list(APPS))
def test_apps_need_cuda_unless_asked_for_cpu(monkeypatch, name):
    """Without --cpu an app runs on the CUDA card, and without one it
    raises before doing any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, argv = APPS[name]
    with pytest.raises(RuntimeError, match="CUDA device"):
        mod.main(argv)
