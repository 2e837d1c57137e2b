"""slam_tpu_torch.models.rbpf.RBPF against the plain per-particle-map
reference of the benchmark's RBPF judge (`portbench/reference/rbpf.py`),
on the CPU, and the step's spans and counters.

The configuration is the RBPF cell's (u8 maps of P(free) at 128, sigma 5,
eps 0.1, ray step 0.5, systematic resampling every step) at 12 particles
in a 64 x 96 room, 16 beams over 2 pi to 40 px and a mount 3 px ahead.
Every second beam of a frame reads short (2 px, posts beside the robot),
so beams of one particle write one cell with the free and the occupied
update: the frames where the last lane must win. From seeded states the
program's maps equal the reference's bit for bit, its log weights are
within 1e-5 relative, its resampled particles are the reference's
systematic choice and its mean pose the reference's; the judge passes a
sound drive and refuses each fault of `portbench/faults_rbpf.py`.
"""

import ast
import copy
import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import faults_rbpf, roofline, run, spans
from portbench.layers import (
    rbpf_map_copy_device_ms, rbpf_map_copy_roofline, rbpf_map_write_device_ms,
    rbpf_march_device_ms,
)
from portbench.reference import filter as flt, judge_rbpf, motion, rbpf as ref
from portbench.requests import rbpf as req_rbpf
from portbench.traffic import lap, world
from slam_tpu_torch.core import graph
from slam_tpu_torch.core.types import Pose, Scan
from slam_tpu_torch.ops import mapping
from slam_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = json.loads((ROOT / "portbench/workloads/rbpf_floorplan_1k.explore.json").read_text())
H, W, N, BEAMS, MAX_DIST = 64, 96, 12, 16, 40.0
CFG = run.merged(run.load("configs", CELL["config"]), {
    "lidar": {"n_rays": BEAMS, "max_dist": MAX_DIST}, "raycast": {"max_dist": MAX_DIST},
    "scanner_offset": [0.0, 3.0, 0.0], "particles": N})
FRAMES = 7


def room():
    b = np.zeros((H, W), bool)
    b[:2], b[-2:], b[:, :2], b[:, -2:] = True, True, True, True
    b[20:30, 60:66] = True
    b[44:50, 20:40] = True
    return b


def drive():
    """(truth poses f64 [FRAMES + 1, 3], odometry [FRAMES, 3], scans f32
    [FRAMES, BEAMS], beam angles f32 [BEAMS]): a slow arc through the
    room, every second beam cut to 2 px."""
    t = np.arange(FRAMES + 1, dtype=np.float64)
    poses = np.stack([30.0 + 2.5 * t, 30.0 + 0.4 * t, 0.3 + 0.05 * t], axis=1)
    odom = lap.increments(poses)[:-1]
    dists = world.scans(torch.from_numpy(room()), poses[1:], CFG["lidar"], CFG["scanner_offset"])
    dists[:, 1::2] = torch.clamp(dists[:, 1::2], max=2.0)
    angles = torch.tensor(world.beam_angles(0.0, 2 * math.pi, BEAMS), dtype=torch.float32)
    return poses, odom, dists, angles


def records(seed: int, frames: int = FRAMES, cfg: dict = CFG):
    """The drive served through the request module on the CPU (the
    program's configuration `cfg`), every request kept as the benchmark's
    run keeps a sampled one."""
    poses, odom, dists, angles = drive()
    traffic = SimpleNamespace(angles=angles, dists=dists, start_pose=lambda: tuple(poses[0]))
    eng = req_rbpf.Engine(cfg, CELL, room(), traffic, seed, torch.device("cpu"))
    eng.reset()
    out = []
    for k in range(frames):
        req = SimpleNamespace(kind="rbpf", odom=tuple(float(v) for v in odom[k]), scan=k)
        keep = []
        pose = eng.serve(req, keep)
        kind, before, gen, after, r = keep[0]
        out.append({"kind": kind, "before": before, "gen": gen, "after": after, "req": r,
                    "scan": dists[k], "pose": pose})
    return out, angles


def _judge(recs, angles):
    return judge_rbpf.judge(recs, CFG, room(), angles, torch.device("cpu"))


def _refused(got: dict) -> list:
    return [k for k, lim in CELL["limits"].items() if not got.get(k, 0.0) <= lim]


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_each_step_holds_to_the_plain_reference(seed, monkeypatch):
    """Seeded states of the drive, chunked in three: the step's weights
    and maps against the reference's from the same moved poses, and the
    resampled particles, maps and mean pose against the reference's
    systematic choice with the step's own draws replayed."""
    monkeypatch.setattr(mapping, "_FIDELITY_CHUNK_LANES", 5 * BEAMS * 80)
    recs, angles = records(seed)
    moved_hits = 0
    for rec in recs:
        before, after = rec["before"], rec["after"]
        p = before.particles.pose
        gen = motion.clone(rec["gen"], "cpu")
        x, y, th = motion.sample(gen, rec["req"].odom, CFG["alphas"], p.x, p.y, p.theta)
        scan = Scan(angles=angles, dists=rec["scan"])
        lw, maps = ref.weigh_and_map(before.maps, x, y, th, rec["scan"], angles, CFG)
        plw, pmaps = mapping.fidelity_measurement_and_mapping(
            before.maps, Pose(x=x, y=y, theta=th), scan, scanner_offset=CFG["scanner_offset"],
            stddev=CFG["meas_stddev"], eps=CFG["meas_epsilon"], max_dist=MAX_DIST, step=0.5)
        assert torch.equal(pmaps, maps)
        assert float(((plw - lw).abs() / lw.abs()).max()) <= 1e-5
        moved_hits += int((maps != before.maps).sum())
        logw = before.particles.log_weight + lw
        idx = flt.systematic(logw, torch.rand((), generator=gen))
        q = after.particles.pose
        assert torch.equal(q.x, x[idx]) and torch.equal(q.y, y[idx]) and torch.equal(q.theta, th[idx])
        assert torch.equal(after.maps, maps[idx])
        mx, my, mth = ref.mean_pose(x[idx], y[idx], th[idx])
        assert rec["pose"] == pytest.approx([mx, my, mth], abs=1e-4)
    assert moved_hits > 0


def test_the_state_before_a_step_is_left_as_it_was():
    """A step returns a copy of its buffers: the state a kept request
    started from still holds its maps after the steps that follow."""
    recs, _ = records(5, frames=3)
    first = recs[0]["after"].maps.clone()
    assert not torch.equal(recs[0]["before"].maps, first)
    assert torch.equal(recs[1]["before"].maps, first)
    assert torch.equal(recs[0]["before"].maps, torch.full_like(first, 128))


def test_the_last_lane_wins_where_the_lanes_disagree():
    """The posts' frames write one cell of a particle with both updates:
    the reference keeps the last writer's value, and the first writer's
    would differ."""
    recs, angles = records(3, frames=2)
    rec = recs[1]
    p = rec["before"].particles.pose
    _, maps = ref.weigh_and_map(rec["before"].maps, p.x, p.y, p.theta, rec["scan"], angles, CFG)
    with faults_rbpf.planted("first_lane"):
        _, first = mapping.fidelity_measurement_and_mapping(
            rec["before"].maps, p, Scan(angles=angles, dists=rec["scan"]),
            scanner_offset=CFG["scanner_offset"], max_dist=MAX_DIST)
    assert int((first != maps).sum()) > 0


@pytest.mark.parametrize("fault", ["sound", *faults_rbpf.FAULTS])
def test_the_judge_passes_a_sound_drive_and_refuses_each_fault(fault):
    if fault == "sound":
        recs, angles = records(7)
    else:
        with faults_rbpf.planted(fault):
            recs, angles = records(7)
    got = _judge(recs, angles)
    assert set(got) == set(CELL["limits"])
    if fault == "sound":
        assert _refused(got) == [], got
        assert got["map_mismatch_cells"] == 0 and got["particle_mismatch_share"] == 0
        assert got["weight_rel_gap"] <= 1e-6 and got["pose_gap_px"] <= 1e-3
    else:
        assert _refused(got), (fault, got)
    # Slots that hold a particle the step did not make: the share reads
    # their part, over a limit of 0.
    if fault in ("unchanged", "half"):
        assert got["particle_mismatch_share"] == {"unchanged": 1.0, "half": 0.5}[fault]
        assert CELL["limits"]["particle_mismatch_share"] == 0


def test_the_control_is_refused():
    """The workload file's control: the program marches at a ray step of
    1.0, the reference keeps 0.5."""
    recs, angles = records(7, cfg=run.merged(CFG, CELL["control"]["program"]))
    assert _refused(_judge(recs, angles))


def test_spans_and_counters_under_a_session_only(monkeypatch):
    monkeypatch.setattr(mapping, "_FIDELITY_CHUNK_LANES", 5 * BEAMS * 80)
    profiling.reset()
    plain, _ = records(9, frames=2)
    assert profiling.recorded()["records"] == [] and profiling.recorded()["counts"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        traced, _ = records(9, frames=2)
    r = profiling.recorded()
    profiling.reset()
    for a, b in zip(plain, traced):
        assert torch.equal(a["after"].maps, b["after"].maps) and a["pose"] == b["pose"]
    assert r["root_names"] == {"RBPF.step": 2} and r["roots"] == 2
    names = [x.name for x in r["records"] if x.request == 0 and x.parent == "graph.replay"]
    assert names == ["motion"] + ["rbpf.march", "rbpf.map_write"] * 3 + ["resample",
                                                                         "rbpf.map_copy"]
    assert r["counts"] == {"rbpf.chunks": 2 * 3, "rbpf.lanes": 2 * N * BEAMS * 80,
                           "rbpf.map_copy_bytes": 2 * N * H * W}
    assert r["device_ms"] == {}  # the CPU has no device time
    assert all(r["host_ms"][n] > 0.0 for n in ("rbpf.march", "rbpf.map_write", "rbpf.map_copy"))


def test_a_warm_up_counts_the_stamps_its_capture_asks_for(monkeypatch):
    """A block's clock is sized by its warm-up: two slots for each span
    that times a CUDA device, none for a span that times nothing."""
    monkeypatch.setattr(graph, "_WARMING", True)
    monkeypatch.setattr(graph, "_WARM_STAMPS", 0)
    for dev in (torch.device("cuda", 0), None, torch.device("cpu"), torch.device("cuda", 0)):
        with profiling.span("rbpf.march", dev):
            pass
    assert graph._WARM_STAMPS == 4
    monkeypatch.setattr(graph, "_WARMING", False)
    with profiling.span("rbpf.march", torch.device("cuda", 0)):
        pass
    assert graph._WARM_STAMPS == 4


def test_the_readers_divide_by_the_requests(monkeypatch):
    readers = {"rbpf.march": rbpf_march_device_ms, "rbpf.map_write": rbpf_map_write_device_ms,
               "rbpf.map_copy": rbpf_map_copy_device_ms}
    profiling.reset()
    assert all(m.read(None) is None for m in readers.values())  # nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        records(9, frames=2)
    assert all(m.read(None) is None for m in readers.values())  # no device time on the CPU
    profiling.reset()
    fake = {"roots": 4, "host_ms": {}, "counts": {},
            "device_ms": {"rbpf.march": 40.0, "rbpf.map_write": 20.0, "rbpf.map_copy": 8.0}}
    monkeypatch.setattr(profiling, "recorded", lambda: copy.deepcopy(fake))
    assert {n: m.read(None) for n, m in readers.items()} == {
        "rbpf.march": 10.0, "rbpf.map_write": 5.0, "rbpf.map_copy": 2.0}
    assert spans.device_ms("motion") is None


def test_the_map_copy_roofline_counts_each_map_read_and_written_once():
    b, o = rbpf_map_copy_roofline.map_copy_work(1000, 599, 1297)
    assert (b, o) == (2.0 * 1000 * 599 * 1297, 0.0)
    # 1.5538 GB at 3.35 TB/s.
    assert roofline.least_ms(b, o) == pytest.approx(1.553806e9 / 3.35e12 * 1e3)


def test_the_reference_and_judge_import_nothing_of_the_program():
    for name in ("rbpf", "judge_rbpf"):
        tree = ast.parse((ROOT / f"portbench/reference/{name}.py").read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in ("slam_tpu_torch", "slam_tpu", "jax", "jaxlib")
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {{"jax", "jaxlib", "flax", "slam_tpu", "slam_tpu_torch"}}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(ROOT)!r})
import portbench.reference.rbpf, portbench.reference.judge_rbpf
print("ok")
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr[-2000:]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n,chunk_lanes", [(N, None), (72, 1)])
def test_the_step_graph_times_its_spans_on_the_card(card, monkeypatch, n, chunk_lanes):
    """The step's graph stamps its spans: under a session each reader
    gives device ms, and the roofline reader a share within 100%. At one
    particle a chunk the step stamps 4 a chunk, past the clock's least
    slots (72 chunks, 292 stamps)."""
    if chunk_lanes is not None:
        monkeypatch.setattr(mapping, "_FIDELITY_CHUNK_LANES", chunk_lanes)
        assert 4 * n > graph._CLOCK_SLOTS
    poses, odom, dists, angles = drive()
    traffic = SimpleNamespace(angles=angles, dists=dists, start_pose=lambda: tuple(poses[0]))
    eng = req_rbpf.Engine(run.merged(CFG, {"particles": n}), CELL, room(), traffic, 3, card)
    eng.reset()
    reqs = [SimpleNamespace(kind="rbpf", odom=tuple(float(v) for v in odom[k]), scan=k)
            for k in range(FRAMES)]
    eng.serve(reqs[0])  # the capture, outside the session
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for q in reqs[1:]:
            eng.serve(q)
    chunks = profiling.recorded()["counts"]["rbpf.chunks"]
    got = [m.read(None) for m in (rbpf_march_device_ms, rbpf_map_write_device_ms,
                                  rbpf_map_copy_device_ms)]
    profiling.reset()
    assert all(v is not None and v > 0.0 for v in got), got
    if chunk_lanes is not None:
        assert chunks == (FRAMES - 1) * n
    share = rbpf_map_copy_roofline.read(SimpleNamespace(point_state=eng.state))
    assert 0.0 < share <= 100.0


@pytest.mark.card
def test_the_last_lane_wins_at_the_cell_shapes_on_the_card(card):
    """The cell's own configuration (1000 maps of the floor plan, 90 beams
    to 500 px, the mount 30 px ahead), with every second beam cut to 2 px
    so that beams of one particle write one cell with both updates: the
    program's maps equal the reference's bit for bit, and the first
    writer's would differ. The cell's lap keeps the walls farther than
    such beams need, so its traffic does not show this rule. The card's
    kernels call no `last_lanes`, so the first writer's maps come from the
    planted plain path on CPU copies of a few of the particles."""
    cfg = run.load("configs", CELL["config"])
    blocked = run.build_map(cfg["plan"])
    n, beams, max_dist = cfg["particles"], cfg["lidar"]["n_rays"], cfg["raycast"]["max_dist"]
    g = torch.Generator(device=card).manual_seed(5)
    x = 863.5 + 2.0 * torch.randn(n, generator=g, device=card)
    y = 190.0 + 2.0 * torch.randn(n, generator=g, device=card)
    th = 0.3 + 0.05 * torch.randn(n, generator=g, device=card)
    angles = torch.tensor(world.beam_angles(0.0, 2 * math.pi, beams), dtype=torch.float32,
                          device=card)
    dists = torch.full((beams,), 60.0, device=card)
    dists[1::2] = 2.0
    maps = torch.full((n,) + tuple(blocked.shape), 128, dtype=torch.uint8, device=card)
    pose, scan = Pose(x=x, y=y, theta=th), Scan(angles=angles, dists=dists)
    kw = dict(scanner_offset=cfg["scanner_offset"], stddev=cfg["meas_stddev"],
              eps=cfg["meas_epsilon"], max_dist=max_dist, step=cfg["raycast"]["step"])
    plw, pmaps = mapping.fidelity_measurement_and_mapping(maps, pose, scan, **kw)
    lw, rmaps = ref.weigh_and_map(maps, x, y, th, dists, angles, cfg)
    assert torch.equal(pmaps, rmaps)
    assert float(((plw - lw).abs() / lw.abs()).max()) <= 1e-5
    del pmaps
    few = slice(0, 8)
    with faults_rbpf.planted("first_lane"):
        _, first = mapping.fidelity_measurement_and_mapping(
            maps[few].cpu(), Pose(x=x[few].cpu(), y=y[few].cpu(), theta=th[few].cpu()),
            Scan(angles=angles.cpu(), dists=dists.cpu()), **kw)
    assert int((first != rmaps[few].cpu()).sum()) > 0
