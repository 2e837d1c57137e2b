"""Build and load the hand-written CUDA kernels under `slam_tpu_torch/csrc/`.

All `csrc/*.cu` files compile with `nvcc` for `sm_90a` into ONE shared
library with a plain C interface (`extern "C"` launchers), loaded with
`ctypes`. The library lands in `slam_tpu_torch/_build/` under a name
derived from the hash of the sources and flags, so an edited source
rebuilds on its next use and an unchanged one loads at once. Nothing here
runs at import time: the first kernel launch builds.

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
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_SIGNATURES = {
    # (seed*, r1, t, r2, std_r1, std_t, std_r2, x*, y*, th*, ox*, oy*, oth*,
    #  n, stream)
    "motion_odometry_launch": (
        [_P] + [ctypes.c_float] * 6 + [_P] * 6 + [ctypes.c_longlong, _P]
    ),
    # (rows*, idx*, out*, n, row_bytes, vec_bytes, stream)
    "gather_rows_launch": (
        [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _P]
    ),
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


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library():
    """The loaded kernel library, built first when its sources changed.

    Returns (ctypes.CDLL, info) where info holds the library path, whether
    this call built it, the build seconds and the compiler's `-Xptxas -v`
    report (registers, shared memory, spills per kernel)."""
    srcs = sorted(CSRC.glob("*.cu"))
    so = BUILD_DIR / f"libslam_tpu_torch_{_digest(srcs)}.so"
    log = so.with_suffix(".log")
    built, secs = False, 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        log.write_text(proc.stdout + proc.stderr)
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
