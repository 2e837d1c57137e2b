"""The RBPF's march and map write on the card (`ops/rbpf_fidelity_cuda.py`,
`csrc/rbpf_fidelity.cu`) against the plain path that the CPU runs
(`ops/mapping.py:_fidelity_chunk` with `planners/_scatter.py:last_lanes`).

On the CPU: the wrappers refuse a wrong dtype, shape, layout or a CPU
tensor before any build; the kernels' rule, modelled in numpy
(`kernel_rule`: each beam marched to its hit, the occupied cell found from
z / step, the free writes skipped where a later beam occupies the cell),
equals the plain path in every case, also through the card's route in
`fidelity_measurement_and_mapping` in place of the kernels; the CPU route
launches no kernel.

On the card (`card` marker; `python -m pytest --noconftest -p
no:cacheprovider -m card tests/test_torch_rbpf_fidelity_cuda.py`): the
kernels equal the plain path run on the card bit for bit (hits, their
distances, the log weights and the u8 maps), in each case and along the
RBPF cell's lap at its own shapes, with one launch of each kernel a chunk
(`chip_smoke.hold_rbpf_fidelity`, which the script's phase 30 runs too).

The cases, in a 64 x 96 room with 12 particles, 16 beams to 40 px, step
0.5 and the mount 3 px ahead: `spread` (particles around one pose),
`sensor_off_map`, `beams_leave` (sensors by the walls, long ranges),
`max_range` (misses read exactly max_dist), `z_on_step` (ranges on a ray
step), `z_below_first` (ranges under the first step, one negative: both
updates' predicates hold and the occupied one wins), `one_particle`,
`ragged` (7 particles in chunks of 3) and `posts` (64 beams, every second
read 2 px: beams of one particle write one cell with both updates).
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from portbench import faults_rbpf, run
from portbench.traffic import lap, world
from slam_tpu_torch.core.types import Pose, Scan
from slam_tpu_torch.ops import _build, mapping, rbpf_fidelity_cuda
from slam_tpu_torch.ops.measurement import beam_log_weights

H, W, N, BEAMS, MAX_DIST, STEP = 64, 96, 12, 16, 40.0, 0.5
K = int(math.ceil(MAX_DIST / STEP))
KW = dict(scanner_offset=(0.0, 3.0, 0.0), stddev=5.0, eps=0.1, max_dist=MAX_DIST, step=STEP)
CASES = ("spread", "sensor_off_map", "beams_leave", "max_range", "z_on_step", "z_below_first",
         "one_particle", "ragged", "posts")
OCC = mapping._u8_scale(mapping._LOCC / mapping._L0)
FREE = mapping._u8_scale(mapping._LFREE / mapping._L0)


def room():
    b = np.zeros((H, W), bool)
    b[:2], b[-2:], b[:, :2], b[:, -2:] = True, True, True, True
    b[20:30, 60:66] = True
    b[44:50, 20:40] = True
    b[28:31, 33:35] = True  # a post beside the spread's sensors
    return b


def case(name: str, dev) -> dict:
    """The maps, robot poses, scan and chunk cap (lanes, or None) of case
    `name`, made on the CPU from its own seed and moved to `dev`."""
    g = torch.Generator().manual_seed(1000 + CASES.index(name))
    n = {"one_particle": 1, "ragged": 7}.get(name, N)
    beams = 64 if name == "posts" else BEAMS

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (n,), generator=g)

    x, y = 30.0 + 3.0 * torch.randn(n, generator=g), 30.0 + 3.0 * torch.randn(n, generator=g)
    if name == "sensor_off_map":
        x, y = u(-15.0, W + 15.0), u(-15.0, H + 15.0)
    elif name == "beams_leave":
        x = torch.where(torch.arange(n) % 2 == 0, u(3.0, 6.0), u(W - 6.0, W - 3.0))
        y = u(4.0, H - 4.0)
    theta = u(-math.pi, math.pi)
    angles = torch.tensor(world.beam_angles(0.0, 2 * math.pi, beams), dtype=torch.float32)
    dists = u(1.0, 30.0, beams)
    if name == "beams_leave":
        dists = torch.where(torch.arange(beams) % 2 == 0, MAX_DIST, 39.25)
    elif name == "max_range":
        dists[::2] = MAX_DIST
    elif name == "z_on_step":
        dists = torch.randint(1, K, (beams,), generator=g).to(torch.float32) * STEP
        dists[-1] = MAX_DIST - STEP
    elif name == "z_below_first":
        dists[:6] = torch.tensor([0.0, 0.1, 0.3, 0.49, -0.75, 1e-6])
    elif name == "posts":
        dists[1::2] = 2.0
    blocked = torch.from_numpy(room()).expand(n, H, W)
    maps = torch.where(blocked, torch.randint(1, 128, (n, H, W), generator=g),
                       torch.randint(128, 256, (n, H, W), generator=g)).to(torch.uint8)
    maps[:, ::7, ::5] = 127  # codes on either side of the threshold
    maps[:, 3::7, 2::5] = 128
    pose = Pose(x=x.to(dev), y=y.to(dev), theta=theta.to(dev))
    scan = Scan(angles=angles.to(dev), dists=dists.to(torch.float32).to(dev))
    return {"maps": maps.to(dev), "pose": pose, "scan": scan,
            "chunk_lanes": 3 * beams * K if name == "ragged" else None}


def rays(maps, pose, scan, n0, n1):
    """The kernels' chunk inputs (maps, x, y, c, s) as the update forms them."""
    return mapping._fidelity_rays(maps, mapping._fidelity_sensors(pose, KW["scanner_offset"]),
                                  scan, n0, n1)


def kernel_rule(maps, x, y, c, s, dists, *, step, k_total, max_dist, occ_scale, free_scale):
    """numpy model of `csrc/rbpf_fidelity.cu` for one chunk: (hit_dist,
    hit_any [C, B], the new maps [C, H, W], the steps each beam marched).
    Every product and sum in f32, one rounding each; a beam marched to its
    hit (or out of the map, or K); the occupied cell found from a margin
    below z / step; free writes skipped where the beam itself or a later
    one occupies the cell."""
    f = np.float32
    maps, dists = maps.numpy(), dists.numpy()
    x, y, c, s = (v.numpy() for v in (x, y, c, s))
    cn, h, w = maps.shape
    beams = c.shape[1]
    step = f(step)
    out = maps.copy()
    hit_dist = np.empty((cn, beams), np.float32)
    hit_any = np.zeros((cn, beams), bool)
    marched = np.empty((cn, beams), np.int64)

    def update(v, scale):
        p = min(f(f(v) * f(scale)), f(1.0))
        return np.uint8(max(np.floor(f(p * f(255.0))), f(1.0)))

    for n in range(cn):
        def cell(b, k):
            if k < 0:
                px, py = x[n], y[n]
            else:
                cs, ss = f(c[n, b] * step), f(s[n, b] * step)
                px, py = f(x[n] + f(f(k + 1) * cs)), f(y[n] + f(f(k + 1) * ss))
            i, j = int(np.floor(f(f(f(h) - py) - f(1.0)))), int(np.floor(px))
            return i * w + j, 0 <= i < h and 0 <= j < w

        cell0, _ = cell(0, -1)
        grid = maps[n].reshape(-1)
        owner = {}
        for b in range(beams):  # the march
            prev, hit, marched[n, b] = cell0, -1, k_total
            for k in range(k_total):
                cur, inb = cell(b, k)
                if not inb:
                    marched[n, b] = k
                    break
                if cur != prev and cur != cell0 and grid[cur] < 128:
                    hit, marched[n, b] = k, k + 1
                    break
                prev = cur
            hit_dist[n, b] = f(f(max(hit, 0)) + f(1.0)) * step
            hit_any[n, b] = hit >= 0
        for b in range(beams):  # the occupied cells
            z = f(dists[b])
            if not z < max_dist:
                continue
            k = 0
            if not f(f(1.0) * step) >= z:
                g = np.floor(f(z / step)) - f(3.0)
                k = 0 if g < 0 else min(int(g), k_total)
                while k < k_total and not f(f(k + 1) * step) >= z:
                    k += 1
            if k >= k_total or not cell(b, 0)[1]:
                continue
            prev = cell(b, k - 1)[0]
            for k in range(k, k_total):
                cur, inb = cell(b, k)
                if not inb:
                    break
                if cur != prev:
                    out[n].reshape(-1)[cur] = update(grid[cur], occ_scale)
                    owner[cur] = b
                    break
                prev = cur
        for b in range(beams):  # the free cells
            zz, prev = f(f(dists[b]) * f(dists[b])), cell0
            for k in range(k_total):
                cur, inb = cell(b, k)
                d = f(f(k + 1) * step)
                if not inb or not f(d * d) < zz:
                    break
                if cur != prev and owner.get(cur, -1) < b:
                    out[n].reshape(-1)[cur] = update(grid[cur], free_scale)
                prev = cur
    return torch.from_numpy(hit_dist), torch.from_numpy(hit_any), torch.from_numpy(out), marched


@pytest.mark.parametrize("name", CASES)
def test_the_kernels_rule_equals_the_plain_path(name, monkeypatch):
    cpu = torch.device("cpu")
    cs = case(name, cpu)
    if cs["chunk_lanes"] is not None:
        monkeypatch.setattr(mapping, "_FIDELITY_CHUNK_LANES", cs["chunk_lanes"])
    maps, pose, scan = cs["maps"], cs["pose"], cs["scan"]
    n = maps.shape[0]
    lw, new = mapping.fidelity_measurement_and_mapping(maps, pose, scan, **KW)
    sp = mapping._fidelity_sensors(pose, KW["scanner_offset"])
    hd, ha = mapping._fidelity_chunk(maps.reshape(-1), 0, n, (H, W), sp, scan, step=STEP,
                                     max_dist=MAX_DIST)[:2]
    mhd, mha, mnew, marched = kernel_rule(*rays(maps, pose, scan, 0, n), scan.dists, step=STEP,
                                          k_total=K, max_dist=MAX_DIST, occ_scale=OCC,
                                          free_scale=FREE)
    assert torch.equal(mhd, hd) and torch.equal(mha, ha)
    assert torch.equal(mnew, new)
    mlw = beam_log_weights(mhd, mha, scan.dists[None, :], stddev=KW["stddev"],
                           max_dist=MAX_DIST, eps=KW["eps"]).sum(-1)
    assert torch.equal(mlw, lw)
    assert bool((new != maps).any())
    if name == "posts":
        # The case writes cells of a particle with both updates: the first
        # writer's maps differ from the last writer's.
        with faults_rbpf.planted("first_lane"):
            _, first = mapping.fidelity_measurement_and_mapping(maps, pose, scan, **KW)
        assert int((first != new).sum()) > 0
    if name == "spread":
        assert bool(mha.any()) and marched.mean() < K


@pytest.mark.parametrize("name", ["ragged", "posts"])
def test_the_card_route_with_modelled_kernels_equals_the_plain_path(name, monkeypatch):
    """The card's route through `fidelity_measurement_and_mapping` (each
    chunk's inputs, the wrappers' arguments, the new maps' slices), run on
    the CPU with `kernel_rule` in place of the two kernels, equals the
    plain path; one call of each a chunk."""
    cs = case(name, torch.device("cpu"))
    if cs["chunk_lanes"] is not None:
        monkeypatch.setattr(mapping, "_FIDELITY_CHUNK_LANES", cs["chunk_lanes"])
    maps, pose, scan = cs["maps"], cs["pose"], cs["scan"]
    want = mapping.fidelity_measurement_and_mapping(maps, pose, scan, **KW)
    calls = []

    def march(maps, x, y, c, s, *, step, k_total):
        calls.append("march")
        return kernel_rule(maps, x, y, c, s, scan.dists, step=step, k_total=k_total,
                           max_dist=MAX_DIST, occ_scale=OCC, free_scale=FREE)[:2]

    def write(maps, x, y, c, s, dists, out, *, step, k_total, max_dist, occ_scale, free_scale):
        calls.append("write")
        out.copy_(kernel_rule(maps, x, y, c, s, dists, step=step, k_total=k_total,
                              max_dist=max_dist, occ_scale=occ_scale,
                              free_scale=free_scale)[2])

    monkeypatch.setattr(mapping, "_kernels", lambda dev: True)
    monkeypatch.setattr(rbpf_fidelity_cuda, "march", march)
    monkeypatch.setattr(rbpf_fidelity_cuda, "write", write)
    got = mapping.fidelity_measurement_and_mapping(maps, pose, scan, **KW)
    chunks = 3 if name == "ragged" else 1
    assert calls == ["march", "write"] * chunks
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_cpu_route_launches_no_kernel(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a kernel on the CPU route")

    monkeypatch.setattr(rbpf_fidelity_cuda, "march", refuse)
    monkeypatch.setattr(rbpf_fidelity_cuda, "write", refuse)
    cs = case("spread", torch.device("cpu"))
    lw, new = mapping.fidelity_measurement_and_mapping(cs["maps"], cs["pose"], cs["scan"], **KW)
    assert lw.shape == (N,) and new.shape == (N, H, W)


def _inputs():
    cs = case("spread", torch.device("cpu"))
    maps, x, y, c, s = rays(cs["maps"], cs["pose"], cs["scan"], 0, N)
    return dict(maps=maps, x=x, y=y, c=c, s=s, out=maps.clone(), dists=cs["scan"].dists)


FAULTS = {
    "cpu": (lambda a: a, "CUDA device"),
    "maps_dtype": (lambda a: {**a, "maps": a["maps"].to(torch.int16)}, "maps must be"),
    "x_dtype": (lambda a: {**a, "x": a["x"].double()}, "x must be"),
    "maps_layout": (lambda a: {**a, "maps": a["maps"].transpose(1, 2).contiguous()
                               .transpose(1, 2)}, "not contiguous"),
    "c_layout": (lambda a: {**a, "c": a["c"].t().contiguous().t()}, "not contiguous"),
    "c_shape": (lambda a: {**a, "c": a["c"][:, :-1].contiguous()}, "s must be"),
    "y_shape": (lambda a: {**a, "y": a["y"][:-1]}, "y must be"),
    "maps_rank": (lambda a: {**a, "maps": a["maps"][0]}, r"maps must be non-empty \[C, H, W\]"),
    "beams": (lambda a: {**a, "c": torch.zeros((N, rbpf_fidelity_cuda.MAX_BEAMS + 1)),
                         "s": torch.zeros((N, rbpf_fidelity_cuda.MAX_BEAMS + 1))}, "beams"),
    "out_shape": (lambda a: {**a, "out": a["out"][:-1]}, "out must be"),
    "dists_shape": (lambda a: {**a, "dists": a["dists"][:-1]}, "dists must be"),
}


@pytest.mark.parametrize("kernel,fault", [
    (k, f) for k in ("march", "write") for f in FAULTS
    if k == "write" or f not in ("out_shape", "dists_shape")])  # the march takes neither
def test_the_wrappers_refuse_wrong_inputs_before_any_build(kernel, fault, monkeypatch):
    def no_build():
        raise AssertionError("built before the inputs were checked")

    monkeypatch.setattr(_build, "library", no_build)
    broken, match = FAULTS[fault]
    a = broken(_inputs())
    with pytest.raises(ValueError, match=match):
        if kernel == "march":
            rbpf_fidelity_cuda.march(a["maps"], a["x"], a["y"], a["c"], a["s"], step=STEP,
                                     k_total=K)
        else:
            rbpf_fidelity_cuda.write(a["maps"], a["x"], a["y"], a["c"], a["s"], a["dists"],
                                     a["out"], step=STEP, k_total=K, max_dist=MAX_DIST,
                                     occ_scale=OCC, free_scale=FREE)


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("name", CASES)
def test_the_kernels_equal_the_plain_path_on_the_card(card, name, monkeypatch):
    cs = case(name, card)
    if cs["chunk_lanes"] is not None:
        monkeypatch.setattr(mapping, "_FIDELITY_CHUNK_LANES", cs["chunk_lanes"])
    got = chip_smoke.hold_rbpf_fidelity(cs["maps"], cs["pose"], cs["scan"], KW)
    assert bool((got["maps"] != cs["maps"]).any())
    # The card's maps equal the CPU's too.
    cpu = case(name, torch.device("cpu"))
    _, cmaps = mapping.fidelity_measurement_and_mapping(cpu["maps"], cpu["pose"], cpu["scan"],
                                                        **KW)
    assert torch.equal(got["maps"].cpu(), cmaps)


@pytest.mark.card
def test_the_kernels_equal_the_plain_path_along_the_lap_on_the_card(card):
    """The RBPF cell's own shapes (1000 maps of the 599 x 1297 plan, 90
    beams over 2 pi to 500 px, step 0.5, the mount 30 px ahead) along four
    frames of its lap from maps at 128, each frame's maps the last one's:
    the walls written in the first frames give the later ones hits."""
    cell = run.load("workloads", "rbpf_floorplan_1k.explore")
    cfg = run.load("configs", cell["config"])
    blocked = run.build_map(cfg["plan"])
    traffic = lap.Traffic(run.load("traffic", cell["traffic"]), cfg, blocked, 5, 1.0)
    n = cfg["particles"]
    kw = dict(scanner_offset=tuple(cfg["scanner_offset"]), stddev=cfg["meas_stddev"],
              eps=cfg["meas_epsilon"], max_dist=cfg["raycast"]["max_dist"],
              step=cfg["raycast"]["step"])
    angles = traffic.angles.to(card)
    g = torch.Generator(device=card).manual_seed(17)
    maps = torch.full((n,) + tuple(blocked.shape), 128, dtype=torch.uint8, device=card)
    hits = []
    for f in (1, 2, 3, 4):
        px, py, pth = (float(v) for v in traffic.poses[f])
        pose = Pose(x=px + 1.5 * torch.randn(n, generator=g, device=card),
                    y=py + 1.5 * torch.randn(n, generator=g, device=card),
                    theta=pth + 0.02 * torch.randn(n, generator=g, device=card))
        got = chip_smoke.hold_rbpf_fidelity(
            maps, pose, Scan(angles=angles, dists=traffic.dists[f].to(card)), kw)
        hits.append(float(got["hit_any"].float().mean()))
        maps = got["maps"]
    assert hits[0] == 0.0 and hits[-1] > 0.0, hits
