"""What the kernel A/B probes share (`tools/lut_weights_ab.py`,
`tools/motion_ab.py`): other builds of a kernel's source beside the
package's own, a launch's device time from a CUDA graph, timing builds in
turns, and the line naming the card."""

from __future__ import annotations

import contextlib
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from slam_tpu_torch.core.graph import Block
from slam_tpu_torch.ops import _build

ITERS = 20
REPLAYS = 10


def parse_builds(specs) -> dict:
    """{name: (source path, extra nvcc flags)} of `NAME=PATH[::FLAGS]`
    specs: PATH another source with the same C entry point (e.g. an
    earlier commit's, `git show REV:FILE > PATH`), FLAGS (space-separated,
    e.g. `-DK1_PER=2`) added to its nvcc line."""
    out = {}
    for spec in specs:
        name, rest = spec.split("=", 1)
        path, _, flags = rest.partition("::")
        out[name] = (Path(path).resolve(), flags.split())
    return out


def build(builds: dict, entry: str, argtypes=None) -> dict:
    """{name: (ctypes library, ptxas report, so path)} of `builds` {name:
    (source path, extra flags)}, one nvcc each, all at once, into
    `slam_tpu_torch/_build/ab/`; `entry` gets `argtypes` (a function of
    the source text, or the package's signature when None)."""
    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, (src, flags) in builds.items():
        so = out / f"{Path(src).stem}_{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-I", str(Path(src).parent), "-I",
               str(_build.CSRC), "-shared", "-o", str(so), str(src)]
        procs[name] = (src, so, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (src, so, cmd, p) in procs.items():
        report = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{report}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.argtypes = (_build._SIGNATURES[entry] if argtypes is None
                       else argtypes(Path(src).read_text()))
        fn.restype = ctypes.c_int
        libs[name] = (lib, report, so)
    return libs


def own_build() -> tuple:
    """The package's library as a `build` entry."""
    lib, info = _build.library()
    return lib, info["ptxas"], Path(info["path"])


@contextlib.contextmanager
def launching(lib):
    """The package's wrappers call `lib` (a library from `build`, or the
    package's own) inside the block."""
    own = _build.library
    _build.library = lambda: (lib, {})
    try:
        yield
    finally:
        _build.library = own


def graph_ms(fn, anchor: torch.Tensor) -> float:
    """Device ms of one call of `fn`: CUDA events around REPLAYS replays of
    a CUDA graph of ITERS calls (`core/graph.py:Block`, which warms up
    eagerly first; `anchor` is a tensor on the card that the block
    holds)."""
    def body(static):
        for _ in range(ITERS):
            fn()
        return {}

    block = Block(body, {"anchor": anchor})
    block.run()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPLAYS):
        block.run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (ITERS * REPLAYS)


def in_turns(names, fn_of, anchor: torch.Tensor, rounds: int) -> dict:
    """{name: {median, min, max, all}} device ms of `fn_of(name)`, each
    round timing every name once, the order reversed every other round
    (A, B, B, A)."""
    times = {name: [] for name in names}
    for k in range(rounds):
        for name in (names if k % 2 == 0 else names[::-1]):
            times[name].append(graph_ms(fn_of(name), anchor))
    return {name: {"median": statistics.median(t), "min": min(t), "max": max(t), "all": t}
            for name, t in times.items()}


def device_line(**extra) -> None:
    """Print the card's name and power limit (nvidia-smi) as a JSON line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "iters": ITERS, "replays": REPLAYS, **extra}), flush=True)
