#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, on the card, in one
process: a cell's run (its traffic, sizes and sampled requests, over a
short window) on each of several seeds, as the program states it, and
with `--control` as the cell's control states it (the workload file's
`control` entry: the program's own path one precision below the one the
configuration states), or with `--fault` with the program's step broken
by a planted fault. Prints one JSON line a seed with every number the
comparison computes, beside the cell's limits.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 --seconds 3 [--control]

Not run by the benchmark's own runs; `tests/test_portbench_card.py` runs
it at a size a test can hold.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults, run  # noqa: E402


def readings(workload, seeds, seconds, control, dev, overrides=None, fault=None):
    """Yield (seed, the run's result) for each seed; with `fault` the
    program's step is broken by that planted fault (`faults.py`)."""
    cell = run.load("workloads", workload)
    over = dict(overrides or {})
    if control:
        for k, v in cell["control"].items():
            over[k] = run.merged(over.get(k, {}), v)
    for seed in seeds:
        with (contextlib.nullcontext() if fault is None
              else faults.planted(fault, cell["request"])):
            out = run.run_cell(workload, seed, seconds, False, dev, time.perf_counter(),
                               overrides=over)
        yield seed, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed, out in readings(args.workload, args.seeds, args.seconds, args.control, dev,
                                fault=args.fault):
        print(json.dumps({"workload": args.workload, "control": args.control,
                          "fault": args.fault, "seed": seed,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
