"""Build and load the hand-written CUDA kernels under `slam_tpu_torch/csrc/`,
the conditional-node binding of the graphs (`csrc/graph_cond.cu`) and the
clock of the spans timed inside them (`csrc/span_clock.cu`).

Each `csrc/*.cu` file compiles with its own `nvcc` for `sm_90a`, all
started at once, and the objects link into ONE shared library with a
plain C interface (`extern "C"` launchers), loaded with `ctypes`. The
library lands in `slam_tpu_torch/_build/` under a name derived from the
hash of the sources, the headers they share (`csrc/*.cuh`) and the flags,
so an edited source or header rebuilds on its next use and an unchanged
tree loads at once. Nothing here runs at import time: the first kernel
launch builds.

Every launcher returns its `cudaGetLastError()` code; `check` turns a
nonzero code into an exception. A failed build raises too: there is no
fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_SIGNATURES = {
    # (seed*, odo*, a0, a1, a2, a3, x*, y*, th*, ox*, oy*, oth*, n, i0,
    #  n_robots, stream)
    "motion_odometry_launch": (
        [_P] * 2 + [ctypes.c_float] * 4 + [_P] * 6 + [ctypes.c_longlong] * 2
        + [ctypes.c_int, _P]
    ),
    # (mismatches*, stream)
    "motion_odometry_math_check": [_P, _P],
    # (rows*, idx*, out*, n, row_bytes, vec_bytes, stream)
    "gather_rows_launch": (
        [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _P]
    ),
    # (predict, table_u8, seed*, odo*, a0, a1, a2, a3, x*, y*, th*, ox*,
    #  oy*, oth*, lut*, row_stride, h, w, n_bins, g, angles*, dists*,
    #  n_beams, sensor_d, sensor_th, sensor_rot, binw, max_dist, inv_stddev,
    #  clamp, inv_norm, eps, quant, lw*, n, i0, n_robots, stream)
    "lut_weights_launch": (
        [ctypes.c_int] * 2 + [_P] * 2 + [ctypes.c_float] * 4 + [_P] * 7
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [_P] * 2 + [ctypes.c_int]
        + [ctypes.c_float] * 10 + [_P] + [ctypes.c_longlong] * 2 + [ctypes.c_int, _P]
    ),
    # (w*, u0*, gate*, x*, y*, th*, lw*, ox*, oy*, oth*, olw*, oidx*, lw_new,
    #  sums*, ends*, n, n_rows, stream)
    "resample_launch": [_P] * 12 + [ctypes.c_float] + [_P] * 2 + [ctypes.c_longlong,
                                                                   ctypes.c_int, _P],
    # (x*, y*, th*, v*, l*, tau, mean_factor, out*, idx*, scratch*, scratch_words,
    #  n, n_rows, stream)
    "estimate_launch": (
        [_P] * 5 + [ctypes.c_float] * 2 + [_P] * 3 + [ctypes.c_longlong] * 2
        + [ctypes.c_int, _P]
    ),
    # (gp*, s, inv_off*, edge_cost*, k, e, idx*, idx_wide, start*, start_wide,
    #  max_len, out*, stream)
    "lattice_chain_launch": (
        [_P, ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P,
         ctypes.c_int, ctypes.c_longlong, _P, _P]
    ),
    # (parent stream, pred*, invert, loop, child stream, body**, handle*)
    "graph_cond_begin": [_P, _P, ctypes.c_int, ctypes.c_int, _P, ctypes.POINTER(_P),
                         ctypes.POINTER(ctypes.c_ulonglong)],
    # (child stream)
    "graph_cond_end": [_P],
    # (stream*)
    "graph_cond_stream": [ctypes.POINTER(_P)],
    # (handle, pred*, stream)
    "graph_cond_set": [ctypes.c_ulonglong, _P, _P],
    # (pinned slot*, stream)
    "span_clock_launch": [_P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "slam_tpu_torch cannot be built"
        )
    return str(path)


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(srcs, so: Path) -> str:
    """nvcc each source to an object, all at once, then link `so`.
    Returns the compilers' output (the `-Xptxas -v` report)."""
    nvcc = _nvcc()
    objs = [so.with_name(f"{so.name}.{p.stem}.o") for p in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(p)]
            for p, o in zip(srcs, objs)]
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        runs = list(zip(cmds, (p.returncode for p in procs), outs))
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(so), *map(str, objs)]
        if all(rc == 0 for _, rc, _ in runs):
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            runs.append((link, proc.returncode, proc.stdout))
        for cmd, rc, out in runs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return "".join(outs)


@functools.cache
def library():
    """The loaded kernel library, built first when its sources changed.

    Returns (ctypes.CDLL, info) where info holds the library path, whether
    this call built it, the build seconds and the compiler's `-Xptxas -v`
    report (registers, shared memory, spills per kernel)."""
    srcs = sorted(CSRC.glob("*.cu"))
    so = BUILD_DIR / f"libslam_tpu_torch_{_digest(srcs + sorted(CSRC.glob('*.cuh')))}.so"
    log = so.with_suffix(".log")
    built, secs = False, 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            report = _compile(srcs, tmp)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        secs = time.perf_counter() - t0
        log.write_text(report)
        os.replace(tmp, so)
        built = True
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.slam_cuda_error_string.argtypes = [ctypes.c_int]
    lib.slam_cuda_error_string.restype = ctypes.c_char_p
    info = {
        "path": str(so),
        "built": built,
        "build_s": secs,
        "ptxas": log.read_text() if log.exists() else "",
    }
    return lib, info


def check(code: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if code != 0:
        msg = library()[0].slam_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg}) at launch")
