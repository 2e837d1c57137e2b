"""The port's spans (`slam_tpu_torch/utils/profiling.py`): the step graphs'
host phases and each filter layer's device time, recorded only while a
torch.profiler session records.

  * With no session a span is the shared no-op and nothing is recorded.
  * Under `profiling.trace` the records carry their names, parents and
    request ids, and a span outside every root carries none; a span's
    start lies on the profiler's clock; the ring keeps its newest records
    while the totals count every span.
  * `MCL.step` and `GridSLAM.step` on the CPU record the `graph.*` spans
    with their layer spans inside the block's run, and step to the same
    states bit for bit with a session and without.
  * The benchmark's span readers give None on an empty recorder, the host
    reader the per-request value on the CPU, the device readers None.
  * On the card (marked `card`, skipped here): a graphed `MCL.step` at
    4096 particles gives each layer span device time, no more in sum than
    the step's own CUDA-event time, and the graph with its clock nodes
    equals the eager step bit for bit. Run there with
    `python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py`.
"""

import math
from contextlib import nullcontext

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import spans
from portbench.layers import estimate_device_ms, graph_host_ms
from slam_tpu_torch.core import config as tc
from slam_tpu_torch.core.types import Odometry, Pose
from slam_tpu_torch.models import fake_lidar
from slam_tpu_torch.models import mcl as tmcl
from slam_tpu_torch.models import slam as tslam
from slam_tpu_torch.utils import profiling

H, W = 64, 96
ALPHAS = (5e-4, 5e-4, 1e-2, 1e-2)
LIDAR = tc.LidarConfig(start=0.0, stop=math.pi, max_dist=60.0, n_rays=30)
RC = tc.RaycastConfig(step=0.5, max_dist=60.0)
MCL_LAYERS = ("motion", "measurement", "estimate", "resample")


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _room(h=H, w=W, device="cpu"):
    b = torch.zeros(h, w, dtype=torch.bool, device=device)
    b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = True
    b[h // 2, w // 3:w // 2] = True
    return b


def _scan(blocked, k, lidar=LIDAR):
    pose = Pose.create(30.0 + k, 20.0 + 0.5 * k, 0.3 + 0.02 * k, device=blocked.device)
    return fake_lidar.scan(blocked, pose, lidar, RC)


def _odom(k):
    return Odometry.create(0.01 * math.sin(k), 1.0 + 0.1 * k, 0.01)


def _bits(state) -> dict:
    from slam_tpu_torch.models import _graph

    leaves, host = {}, {}
    _graph._flatten(state, "", leaves, host)
    out = {k: v.detach().cpu().contiguous().numpy().tobytes() for k, v in leaves.items()}
    out.update({k: v for k, v in host.items() if isinstance(v, int)})
    return out


def test_no_session_records_nothing():
    assert profiling.span("graph.run") is profiling.span("estimate", torch.device("cpu"))
    assert profiling.root("MCL.step") is profiling.span("x")
    eng = tmcl.MCL(tc.MCLConfig(n_particles=64, meas_stddev=5.0), RC, device="cpu")
    blocked = _room()
    eng.step(eng.init(H, W), _odom(0), ALPHAS, _scan(blocked, 0), blocked)
    r = profiling.recorded()
    assert r == {"records": [], "host_ms": {}, "device_ms": {}, "roots": 0}


def test_records_names_parents_and_requests(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("outside"):
            pass
        for _ in range(2):
            with profiling.root("MCL.step"):
                with profiling.span("graph.run"):
                    with profiling.span("graph.prepare"):
                        pass
                    with profiling.root("mcl.init_uniform"):  # nested: no new request
                        pass
    r = profiling.recorded()
    got = [(x.name, x.parent, x.request) for x in r["records"]]
    assert got == [("outside", None, None)] + [
        t for k in (0, 1) for t in (("graph.prepare", "graph.run", k),
                                     ("mcl.init_uniform", "graph.run", k),
                                     ("graph.run", "MCL.step", k), ("MCL.step", None, k))]
    assert r["roots"] == 2 and "outside" not in r["host_ms"] and r["device_ms"] == {}
    assert all(x.end_ns >= x.start_ns for x in r["records"])
    assert r["host_ms"]["MCL.step"] >= r["host_ms"]["graph.run"] >= r["host_ms"]["graph.prepare"]
    assert "graph.prepare" in (tmp_path / "trace.json").read_text()


def test_span_start_is_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]):  # the first record_function's set-up
        with profiling.span("warm"):
            pass
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(5):
            with profiling.span(f"clock.{k}"):
                torch.ones(8).add_(1)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    starts = {e.name: t0 + e.time_range.start * 1e3 for e in prof.events()
              if e.name.startswith("clock.")}
    recs = profiling.recorded()["records"]
    assert len(recs) == 5 and set(starts) == {r.name for r in recs}
    for r in recs:
        assert abs(r.start_ns - starts[r.name]) < 50e3, (r.name, r.start_ns - starts[r.name])


def test_the_ring_keeps_its_newest_records(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 4)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.root("MCL.step"):
            for k in range(10):
                with profiling.span("graph.load"):
                    pass
    r = profiling.recorded()
    assert [x.name for x in r["records"]] == ["graph.load"] * 3 + ["MCL.step"]
    assert r["roots"] == 1 and r["host_ms"]["graph.load"] > 0.0


def _mcl_steps(session: bool, steps: int = 3):
    cfg = tc.MCLConfig(n_particles=128, meas_stddev=5.0)
    eng = tmcl.MCL(cfg, RC, seed=3, device="cpu")
    blocked = _room()
    st = eng.init(H, W)
    with profile(activities=[ProfilerActivity.CPU]) if session else nullcontext():
        for k in range(steps):
            st = eng.step(st, _odom(k), ALPHAS, _scan(blocked, k), blocked)
    return st


def _slam_steps(session: bool, steps: int = 3):
    cfg = tc.SLAMConfig(
        mcl=tc.MCLConfig(n_particles=128, meas_stddev=5.0, measurement="likelihood_field_table",
                         lf_table_box=32, resample_every=2),
        map=tc.MapConfig(height=H, width=W), lidar=LIDAR, raycast=RC, map_pose="mode")
    eng = tslam.GridSLAM(cfg, seed=4, device="cpu")
    blocked = _room()
    st = eng.init(Pose.create(30.0, 20.0, 0.3))
    with profile(activities=[ProfilerActivity.CPU]) if session else nullcontext():
        for k in range(steps):
            st = eng.step(st, _odom(k), _scan(blocked, k))
    return st


@pytest.mark.parametrize("entry", ["MCL.step", "GridSLAM.step"])
def test_steps_record_graph_and_layer_spans_bit_for_bit(entry):
    run = _mcl_steps if entry == "MCL.step" else _slam_steps
    plain = _bits(run(False))
    assert profiling.recorded()["roots"] == 0
    traced = _bits(run(True))
    assert traced == plain
    r = profiling.recorded()
    recs = r["records"]
    assert r["roots"] == 3 and [x.request for x in recs if x.name == entry] == [0, 1, 2]
    for k in range(3):
        mine = [x for x in recs if x.request == k]
        assert [x.name for x in mine if x.parent == entry] == ["graph.run"]
        assert [x.name for x in mine if x.parent == "graph.run"] == [
            "graph.prepare", "graph.load", "graph.replay", "graph.output"]
        layers = [x.name for x in mine if x.parent == "graph.replay"]
        if entry == "MCL.step":
            assert layers == list(MCL_LAYERS)
        else:  # resample_every=2: updates 0 and 2 resample
            want = ["motion", "edt", "measurement", "estimate"]
            assert layers == want + ["resample"] * (k % 2 == 0) + ["mapping"]
        # Siblings: each layer ends before the next starts.
        lay = sorted((x for x in mine if x.parent == "graph.replay"), key=lambda x: x.start_ns)
        assert all(a.end_ns <= b.start_ns for a, b in zip(lay, lay[1:]))
    assert r["device_ms"] == {}


def test_readers_on_an_empty_and_a_cpu_recorder():
    assert spans.recorded() is None
    assert graph_host_ms.read(None) is None and estimate_device_ms.read(None) is None
    _mcl_steps(True)
    r = profiling.recorded()
    want = (r["host_ms"]["graph.run"] - r["host_ms"].get("graph.wait", 0.0)) / r["roots"]
    assert graph_host_ms.read(None) == pytest.approx(want) and want > 0.0
    assert estimate_device_ms.read(None) is None  # the CPU has no device time


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_graphed_step_times_each_layer_on_the_card(card):
    import dataclasses

    from slam_tpu_torch.ops import rayfield

    lidar = dataclasses.replace(LIDAR, n_rays=90)
    rc = dataclasses.replace(RC, backend="lut")
    cfg = tc.MCLConfig(n_particles=4096, meas_stddev=5.0,
                       lut_beam_stride=tc.beam_bin_stride(lidar, rc))
    blocked = _room(160, 200, card)
    field = rayfield.make_ray_field(blocked, rc)
    scans = [_scan(blocked, k, lidar) for k in range(6)]
    eng = tmcl.MCL(cfg, rc, seed=5, device=card)
    graphed = eng.init(160, 200)
    eager = dataclasses.replace(graphed, generator=tmcl.make_generator(5, card))
    for k in range(2):  # capture, outside any session
        graphed = eng.step(graphed, _odom(k), ALPHAS, scans[k], field)
        eager = tmcl.step(eager, _odom(k), ALPHAS, scans[k], field, cfg, rc)
    assert _bits(graphed) == _bits(eager)
    profiling.reset()
    step_ms = 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for k in range(2, 6):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            graphed = eng.step(graphed, _odom(k), ALPHAS, scans[k], field)
            b.record()
            b.synchronize()
            step_ms += a.elapsed_time(b)
            eager = tmcl.step(eager, _odom(k), ALPHAS, scans[k], field, cfg, rc)
    r = profiling.recorded()
    assert _bits(graphed) == _bits(eager)
    assert r["roots"] == 4
    dev = r["device_ms"]
    assert set(dev) == {"lut_weights", "estimate", "resample"}, dev
    assert all(v > 0.0 for v in dev.values()), dev
    assert sum(dev.values()) <= step_ms, (dev, step_ms)
    assert "graph.replay" in r["host_ms"] and "graph.capture" not in r["host_ms"]
