#!/usr/bin/env python3
"""The benchmark of `slam_tpu_torch` on one NVIDIA card: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything of one configuration, traffic mix, request kind or metric is
found by its name. A cell (`portbench/workloads/<cell>.json`) names a
configuration (`configs/<config>.json`, whose `plan` names its map
builder, `maps/<builder>.py`), a traffic mix (`traffic/<mix>.json`,
whose `generator` names its generator module, `traffic/<generator>.py`)
and the request module that maps a request onto the port's calls
(`requests/<request>.py`), whose judge is `reference/judge_<request>.py`.
One robot drives in a closed loop: a request hands the port the frame's
odometry and scan, and ends when the pose estimate is on the host; the
next is sent only then.

Set-up (timed from process start as `setup_s`) builds the map, the
traffic from the seed and the engine, and warms every shape the window
uses; then the window serves requests for `--seconds`. With `--trace 0`
the result carries the end-to-end metrics of `BENCHMARK.json`; with
`--trace 1` a bracketed profiler slice of the window and the per-layer
readers (`layers/<metric>.py`) give the per-layer metrics instead. After
the window the plain reference (`reference/`) works out again a sample
of the requests, drawn from the seed, and decides `correct`; each number
it compared is printed beside its limit, last on standard error and last
in the result line.

Without a CUDA card the run exits nonzero and prints no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Caches at fixed paths inside the checkout, so only a checkout's first run
# builds (the port builds its kernels into slam_tpu_torch/_build itself).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".portbench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".portbench_cache" / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "slam_tpu")


def load(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def build_map(plan: dict):
    """The configuration's map: `maps/<builder>.py:build(**the rest)`."""
    args = {k: v for k, v in plan.items() if k != "builder"}
    return importlib.import_module(f"portbench.maps.{plan['builder']}").build(**args)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Sampler:
    """A reservoir of the window's requests per kind, drawn from the seed:
    up to `quota[kind]` of them, each request of a kind equally likely to
    be kept whatever the window's length."""

    def __init__(self, quota: dict, seed: int):
        self.quota = quota
        self.rng = random.Random(seed)
        self.seen = {k: 0 for k in quota}
        self.kept = {k: [] for k in quota}

    def slot(self, kind: str):
        """The slot the next request of `kind` goes to, or None."""
        if kind not in self.quota:
            return None
        n = self.seen[kind]
        self.seen[kind] = n + 1
        if n < self.quota[kind]:
            return n
        j = self.rng.randrange(n + 1)
        return j if j < self.quota[kind] else None

    def put(self, kind: str, slot: int, recs: list) -> None:
        pool = self.kept[kind]
        if slot == len(pool):
            pool.append(recs)
        else:
            pool[slot] = recs

    def records(self):
        return [r for pool in self.kept.values() for recs in pool for r in recs]


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, dev, t0: float,
             overrides: dict | None = None, meta: dict | None = None) -> dict:
    """One run of a cell on `dev`: the result line's fields. `overrides`
    ({"cell": .., "config": .., "traffic": ..}) replace entries of the
    cell's files (the tests' small sizes); "program" replaces entries of
    the configuration the program runs, and not the reference's (the
    control's precision)."""
    import numpy as np
    import torch

    from portbench import trace

    overrides = overrides or {}
    cell = merged(load("workloads", workload), overrides.get("cell", {}))
    cfg = merged(load("configs", cell["config"]), overrides.get("config", {}))
    tspec = merged(load("traffic", cell["traffic"]), overrides.get("traffic", {}))
    meta = meta if meta is not None else json.loads((ROOT / "BENCHMARK.json").read_text())

    plan = build_map(cfg["plan"])
    traffic = importlib.import_module(f"portbench.traffic.{tspec['generator']}").Traffic(
        tspec, cfg, plan, seed, seconds, scan_device=dev)
    eng = importlib.import_module(f"portbench.requests.{cell['request']}").Engine(
        merged(cfg, overrides.get("program", {})), cell, plan, traffic, seed, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Warm-up: every block of the cell's traffic (the gates' phases, the
    # request kinds), with the sampling path; then back to the start.
    eng.reset()
    for k in range(int(cell["warmup"])):
        eng.serve(traffic.request(k), [])
    eng.reset()
    if trace_on:  # the profiler's first session initializes its tracer
        with trace.Session():
            torch.zeros(1, device=dev).add_(1)
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    gc_before = [g["collections"] for g in gc.get_stats()]
    sync()
    setup_s = time.perf_counter() - t0

    sampler = Sampler(cell["sample"], seed)
    t_at, t_n = int(cell["trace"]["start"]), int(cell["trace"]["requests"])
    point_at = int(cell["point_at"])
    lat, failed, k = [], 0, 0
    session, analysis, point, traced, tries = None, None, None, 0, 0
    t_w = time.perf_counter()
    while True:
        req = traffic.request(k)
        slot = sampler.slot(req.kind)
        recs = [] if slot is not None else None
        if trace_on and analysis is None and session is None and k >= t_at:
            session, traced = trace.Session().__enter__(), 0
        t = time.perf_counter()
        pose = eng.serve(req, recs)
        lat.append(time.perf_counter() - t)
        if session is not None:
            traced += 1
            if traced == t_n:
                session.__exit__(None, None, None)
                # A session whose trace lost its bracket is taken again on
                # the next requests (chip_smoke.py's traced_kernels too).
                try:
                    analysis = session.analyse()
                except RuntimeError as e:
                    tries += 1
                    print(f"portbench: traced slice {tries}: {e}", file=sys.stderr)
                    if tries == 3:
                        raise
                session = None
        if not all(math.isfinite(v) for v in pose):
            failed += 1
        if recs is not None:
            recs = [{"kind": r[0], "before": r[1], "gen": r[2], "after": r[3], "req": r[4],
                     "scan": None if r[4].scan is None else traffic.dists[r[4].scan],
                     "pose": None} for r in recs]
            recs[-1]["pose"] = pose
            sampler.put(req.kind, slot, recs)
        if k == point_at:
            point = (eng.state, traffic.request(k + 1))
        k += 1
        # A traced run also finishes its slice and its fixed point.
        if time.perf_counter() - t_w >= seconds and not (
                trace_on and (analysis is None or point is None)):
            break
    window_s = time.perf_counter() - t_w
    sync()
    tenth = max(1, k // 10)
    print("portbench: window tenths, mean ms: " + " ".join(
        f"{1e3 * float(np.mean(lat[i:i + tenth])):.4f}" for i in range(0, tenth * 10, tenth)),
        file=sys.stderr)
    print("portbench: collections in the window by generation: "
          f"{[g['collections'] - b for g, b in zip(gc.get_stats(), gc_before)]}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics, device = {}, {}
    breakdown = None
    if trace_on:
        t = analysis
        device = {"busy_s": t["busy_s"], "window_s": t["window_s"]}
        breakdown = {"device_ops": [[n, s] for n, s in t["device_ops"]],
                     "idle_gaps": [[n, s] for n, s in t["idle_gaps"]]}
        # What a per-layer reader reads: the traced slice's analysis, the
        # engine, and the state and next request at the window's fixed point.
        ctx = SimpleNamespace(trace=t, traced_requests=traced, engine=eng, point_state=point[0],
                  point_request=point[1], cfg=cfg, blocked=plan, dev=dev)
        for m in meta["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            v = importlib.import_module(f"portbench.layers.{m['name']}").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        del ctx
    else:
        e2e = {"request_ms": window_s * 1e3 / k,
               "request_ms_p95": float(np.percentile(np.asarray(lat), 95)) * 1e3,
               "setup_s": setup_s}
        for m in meta["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # The reference, once the program's structures are freed.
    point = None
    eng.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    records = sampler.records()
    judge = importlib.import_module(f"portbench.reference.judge_{cell['request']}")
    widest = judge.judge(records, cfg, plan, traffic.angles, dev)
    checks = {}
    for name, limit in cell["limits"].items():
        checks[name] = {"value": widest.get(name, 0.0), "limit": limit}
    # Every kind of request the cell samples has been judged.
    judged = {r["req"].kind for r in records}
    checks["kinds_unjudged"] = {"value": len(set(cell["sample"]) - judged), "limit": 0}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": k, "failed": failed, "metrics": metrics,
           "device": {"memory_peak_bytes": int(peak), **device}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    meta = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in meta["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.set_num_threads(2)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), dev, _T0, meta=meta)
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                     "count": cell["chips"], **out["device"]}
    checks = out.pop("checks")
    out["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
