"""The harness on the CPU: every file BENCHMARK.json names is found, the
roofline arithmetic matches counts worked by hand, a run without a card
exits nonzero, nothing imports JAX or the JAX package, the reference
imports nothing of the program, and a run at a small size is correct
while a run whose timed path is broken underneath is not."""

import ast
import contextlib
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import faults, roofline, run
from portbench.tests.pb_small import small

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
META = json.loads((ROOT / "BENCHMARK.json").read_text())

# A meta path finder that refuses the top-level names, compared whole.
BLOCK = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {names!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
"""


def _blocked_python(names, body: str, timeout=600):
    code = BLOCK.format(names=set(names), root=str(ROOT)) + body
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, cwd=str(ROOT))


def test_every_file_named_is_found():
    assert META["command"] == ["python3", "portbench/run.py"] and META["paths"] == ["portbench"]
    for c in META["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert callable(importlib.import_module(f"portbench.maps.{cfg['plan']['builder']}").build)
    for w in META["workloads"]:
        cell = run.load("workloads", w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        gen = run.load("traffic", w["traffic"])["generator"]
        assert hasattr(importlib.import_module(f"portbench.traffic.{gen}"), "Traffic")
        req = importlib.import_module(f"portbench.requests.{cell['request']}")
        assert hasattr(req, "Engine") and callable(req.ENTRY.step)
        assert callable(importlib.import_module(f"portbench.reference.judge_{cell['request']}").judge)
        assert set(cell["limits"]) and "program" in cell["control"]
    for m in META["per_layer"]:
        assert callable(importlib.import_module(f"portbench.layers.{m['name']}").read)
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in META["workloads"]}
    assert {m["name"] for m in META["end_to_end"]} == {"request_ms", "request_ms_p95", "setup_s"}


def test_roofline_counts_worked_by_hand():
    # 100k particles resampled: 3.2 MB at 3.35 TB/s is 0.955 us.
    assert roofline.least_ms(*roofline.resample_work(100_000)) == pytest.approx(3.2e6 / 3.35e12 * 1e3)
    # The fused weigh at 100k, 1000 distinct cells, 90 beams: 2.8 MB of
    # poses and weights, 180 kB of rows, 728 B of scan; 1.23e8 operations
    # at 67 TFLOP/s (1.836 us) bound it over the bytes (0.89 us).
    b, o = roofline.lut_weights_work(100_000, 1000, 90)
    assert b == 100_000 * 28 + 1000 * 90 * 2 + 90 * 8 + 8
    assert o == 100_000 * (130 + 20 + 90 * 12)
    assert roofline.least_ms(b, o) == pytest.approx(o / 67e12 * 1e3)
    # The capped EDT of 1000 x 1000 at cap 27: 5 MB, 1.14e8 operations.
    b, o = roofline.edt_capped_work(1000, 1000, 27.0)
    assert (b, o) == (5e6, 1e6 * (4 + 2 * 55))
    assert roofline.share(b, o, 0.1) == pytest.approx(100 * max(b / 3.35e12, o / 67e12) * 1e3 / 0.1)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    for trace in ("0", "1"):
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                            "mcl_floorplan.track_100k", "--seed", str(2**31 + 5), "--seconds", "1",
                            "--trace", trace], capture_output=True, text=True, cwd=str(ROOT),
                           timeout=300)
        assert p.returncode != 0
        assert "metrics" not in p.stdout and "{" not in p.stdout


def test_nothing_loads_jax_or_the_jax_package():
    mods = sorted("portbench." + ".".join(p.relative_to(BENCH).with_suffix("").parts)
                  for p in BENCH.rglob("*.py") if "tests" not in p.parts)
    body = f"""
import importlib, torch
for m in {mods!r}:
    importlib.import_module(m)
from portbench import run
from portbench.tests.pb_small import small
out = run.run_cell("mcl_floorplan.track_100k", 11, 0.3, False, torch.device("cpu"), 0.0,
                   overrides=small("mcl_floorplan.track_100k", 256))
assert out["correct"], out
print("ok", run.forbidden_modules())
"""
    p = _blocked_python(("jax", "jaxlib", "flax", "slam_tpu"), body)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.split()[-2:] == ["ok", "[]"]


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("slam_tpu_torch", "slam_tpu", "jax", "jaxlib", "flax")
                if n.startswith("portbench"):
                    assert n.startswith("portbench.reference"), (f.name, n)
    p = _blocked_python(("jax", "jaxlib", "flax", "slam_tpu", "slam_tpu_torch"), """
import importlib
for m in ("beam", "filter", "motion", "slam", "judge", "judge_mcl", "judge_slam"):
    importlib.import_module("portbench.reference." + m)
print("ok")
""")
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr[-3000:]


CELLS = {"mcl_floorplan.track_100k": 1000, "slam_floorplan_1m.explore": 256}


@pytest.mark.parametrize("fault", ["sound", *sorted(faults.FAULTS)])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    """The rest of a run on the CPU at a small size, with the port's step
    broken underneath: only the sound run is correct."""
    plant = (contextlib.nullcontext() if fault == "sound"
             else faults.planted(fault, run.load("workloads", cell)["request"]))
    with plant:
        out = run.run_cell(cell, 2**31 + 99, 0.5, False, torch.device("cpu"), 0.0,
                           overrides=small(cell, CELLS[cell]))
    assert out["correct"] == (fault == "sound"), out["checks"]
    assert out["checks"]["kinds_unjudged"]["value"] == 0
    assert all(math.isfinite(c["value"]) or fault != "sound" for c in out["checks"].values())
