"""The port's last two tools and last public names against the JAX
package's: `slam_tpu_torch/tools/rbpf_fidelity.py` (from
`tools/rbpf_fidelity.py`) and `slam_tpu_torch/tools/maze_slam_bench.py`
(from `benchmarks/maze_slam_bench.py`) at a small size on the CPU, each
emitting the JAX tool's JSON keys (read from the JAX tool's source) with
finite values; `utils/logging.py`'s TRACE level, `trace`, `set_level` and
`add_file_sink`; `utils/maps.load_prob_map`; the package version."""

import ast
import json
import logging
import math
import os

import numpy as np
import pytest

import slam_tpu
from slam_tpu.utils import logging as jlog
from slam_tpu.utils import maps as jmaps
import slam_tpu_torch
from slam_tpu_torch.tools import maze_slam_bench, rbpf_fidelity
from slam_tpu_torch.utils import logging as tlog
from slam_tpu_torch.utils import maps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_json_keys(relpath: str) -> list:
    """The keys of the dict the JAX tool passes to `json.dumps`."""
    with open(os.path.join(ROOT, relpath)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError(f"no json.dumps of a dict literal in {relpath}")


def _json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _finite(rec: dict) -> bool:
    return all(math.isfinite(v) for v in rec.values() if isinstance(v, (int, float)))


def test_rbpf_fidelity_tool(capsys):
    rec = rbpf_fidelity.main(["--particles", "16", "--steps", "5", "--device", "cpu", "--json"])
    (line,) = _json_lines(capsys.readouterr().out)
    assert list(line) == jax_json_keys("tools/rbpf_fidelity.py")
    assert _finite(line) and line["particles"] == 16 and line["steps"] == 5
    assert line["device"] == "cpu" and rec["map"] == [599, 1297]
    # The start: the synthetic plan's canvas center is free.
    assert rbpf_fidelity.start_xy(maps.synthetic_floor_plan()) == (1297 / 2.0, 599 / 2.0)
    blocked = np.zeros((20, 20), bool)
    blocked[9, 10] = True
    x, y = rbpf_fidelity.start_xy(blocked)
    i, j = int(math.floor(20 - y - 1.0)), int(math.floor(x))
    assert not blocked[i, j] and abs(i - 9) + abs(j - 10) == 1


def test_maze_slam_bench_tool(capsys):
    recs = maze_slam_bench.main(["--particles", "64", "--steps", "4", "--device", "cpu",
                                 "--measurement", "likelihood_field,likelihood_field_table:8:e128"])
    lines = _json_lines(capsys.readouterr().out)
    keys = jax_json_keys("benchmarks/maze_slam_bench.py")
    assert [list(r) for r in lines] == [keys, keys]
    assert [r["measurement"] for r in lines] == ["likelihood_field",
                                                  "likelihood_field_table:8:e128"]
    assert all(_finite(r) and r["metric"] == "maze_slam_step_ms_64" for r in lines)
    assert recs[0]["map"] == [1024, 1024]
    assert maze_slam_bench.parse_tier("likelihood_field_table:128:e1024") == (
        "likelihood_field_table", 128, 1024)
    assert maze_slam_bench.parse_tier("likelihood_field") == ("likelihood_field", None, None)
    fb = maze_slam_bench.fallback_maze()
    rng = np.random.default_rng(0)
    want = np.ones((1024, 1024), bool)
    want[8:-8, 8:-8] = rng.random((1008, 1008)) > 0.97
    np.testing.assert_array_equal(fb, want)


def test_logging_names_match_jax(tmp_path):
    assert tlog.TRACE == jlog.TRACE == 5 and logging.getLevelName(tlog.TRACE) == "TRACE"
    name = "slam_tpu_torch.test_tools"
    path = tmp_path / "log.txt"
    tlog.set_level(tlog.TRACE, name=name)
    tlog.add_file_sink(str(path), name=name)
    try:
        tlog.trace("traced %d", 7, name=name)
        logging.getLogger(name).debug("below info")
        tlog.set_level(logging.INFO, name=name)
        tlog.trace("filtered", name=name)
    finally:
        for h in logging.getLogger(name).handlers:
            h.close()
        logging.getLogger(name).handlers.clear()
    text = path.read_text()
    assert "TRACE" in text and "traced 7" in text and "test_torch_tools.py" in text
    assert "below info" in text and "filtered" not in text
    for fn in ("set_level", "add_file_sink", "trace", "get_logger"):
        assert callable(getattr(tlog, fn)) and callable(getattr(jlog, fn))


@pytest.mark.parametrize("threshold", [128, 30])
def test_load_prob_map_matches_jax(tmp_path, threshold):
    from PIL import Image

    g = np.random.default_rng(2).integers(0, 256, (20, 30)).astype(np.uint8)
    path = str(tmp_path / "m.png")
    Image.fromarray(g).save(path)
    got = maps.load_prob_map(path, threshold)
    want = jmaps.load_prob_map(path, threshold)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_version_matches_jax():
    assert slam_tpu_torch.__version__ == slam_tpu.__version__
