"""The traffic generator: the same seed gives the same requests, and every
lap keeps its clearance and stays on the map the filter holds."""

import math

import numpy as np
import pytest
import torch

from portbench import run
from portbench.maps import floor_plan
from portbench.traffic import lap, world

MIXES = ("lap_track", "lap_explore", "lap_relocalize")


def _traffic(mix, seed, config="mcl_floorplan", seconds=0.5, over=None):
    cfg = run.load("configs", config)
    spec = run.merged(run.load("traffic", mix), over or {})
    plan = run.build_map(cfg["plan"])
    return lap.Traffic(spec, cfg, plan, seed, seconds), plan, cfg


@pytest.mark.parametrize("mix", MIXES)
def test_a_seed_repeats_exactly(mix):
    a, _, _ = _traffic(mix, 2**31 + 17)
    b, _, _ = _traffic(mix, 2**31 + 17)
    c, _, _ = _traffic(mix, 2**31 + 18)
    ra = [a.request(k) for k in range(300)]
    assert ra == [b.request(k) for k in range(300)]
    assert torch.equal(a.dists, b.dists)
    assert ra != [c.request(k) for k in range(300)]
    # Every seed drives the same lap and scans: only the noise differs.
    assert torch.equal(a.dists, c.dists) and np.array_equal(a.poses, c.poses)


@pytest.mark.parametrize("mix,config", [(m, "mcl_floorplan") for m in MIXES]
                         + [("lap_explore", "slam_floorplan_1m")])
def test_the_lap_keeps_clearance_and_stays_on_the_map(mix, config):
    t, plan, cfg = _traffic(mix, 1, config)
    spec = run.load("traffic", mix)
    p = torch.from_numpy(t.poses)
    sx, sy, _ = world.sensor_pose(p[:, 0], p[:, 1], p[:, 2], cfg["scanner_offset"])
    assert lap.clearance(plan, t.poses[:, :2]).min() >= spec["clearance_px"]
    assert lap.clearance(plan, torch.stack([sx, sy], 1).numpy()).min() >= spec["clearance_px"]
    gh, gw = cfg.get("grid", plan.shape)
    assert 0 < t.poses[:, 0].min() and t.poses[:, 0].max() < min(gw, plan.shape[1])
    assert 0 < t.poses[:, 1].min() and t.poses[:, 1].max() < min(gh, plan.shape[0])
    # The lap is closed: the truth moves frame_px a frame all the way round.
    step = np.hypot(*(np.roll(t.poses[:, :2], -1, 0) - t.poses[:, :2]).T)
    assert np.allclose(step, spec["frame_px"], rtol=1e-3)
    turn = np.abs(lap.wrap(np.roll(t.poses[:, 2], -1) - t.poses[:, 2]))
    assert turn.max() <= spec["max_turn_rad"] + 1e-9
    # It passes a door: it crosses the wall between two rooms.
    assert t.poses[:, 1].min() < 296 < t.poses[:, 1].max()


def test_a_lap_through_a_wall_is_refused():
    with pytest.raises(ValueError, match="clearance"):
        _traffic("lap_track", 1, over={"lap": {"cx": 820.0}})


def test_the_odometry_is_the_increment_plus_the_models_noise():
    t, _, cfg = _traffic("lap_track", 5, seconds=20)
    k = np.arange(1, 20001)
    odom = np.array([t.request(int(i)).odom for i in k])
    prev = k % t.frames  # request k moves the truth from frame k to k + 1
    z = (odom - t.steps[prev]) / t.std[prev]
    assert abs(z.mean()) < 0.05 and abs(z.std() - 1.0) < 0.05


def test_episodes_wake_up_then_step_along_the_lap():
    t, _, _ = _traffic("lap_relocalize", 9)
    reqs = [t.request(k) for k in range(3 * 61)]
    assert [r.kind for r in reqs[::61]] == ["init"] * 3
    assert all(r.kind == "step" for i, r in enumerate(reqs) if i % 61)
    starts = [r.truth for r in reqs[::61]]
    assert len(set(starts)) > 1
    for e in range(3):
        frames = [r.truth for r in reqs[61 * e:61 * (e + 1)]]
        assert all((b - a) % t.frames == 1 for a, b in zip(frames, frames[1:]))


def test_the_floor_plan_is_the_stand_in():
    plan = floor_plan.build()
    assert plan.shape == (599, 1297) and plan.dtype == bool
    assert plan[0].all() and plan[:, -1].all()
    assert not plan[299, 200:204].any()  # a door in a vertical wall
    assert plan[100, 200:204].all()


def test_scans_hit_walls_and_miss_at_max_range():
    plan = torch.from_numpy(floor_plan.build())
    lidar = run.load("configs", "mcl_floorplan")["lidar"]
    d = world.scans(plan, np.array([[863.5 + 25, 250.0, math.pi / 2]]), lidar, (0, 30, 0))
    assert d.shape == (1, 90)
    assert (d <= lidar["max_dist"]).all() and (d < lidar["max_dist"]).any()


def test_a_window_faster_than_max_rate_draws_more_of_the_stream():
    a, _, _ = _traffic("lap_relocalize", 77, seconds=0.01)  # 21 requests drawn ahead
    b, _, _ = _traffic("lap_relocalize", 77, seconds=0.01)
    reqs = [a.request(k) for k in range(500)]
    assert reqs == [b.request(k) for k in range(500)] and len(a.noise) >= 500
