"""ctypes bindings for the native host runtime (native/slam_native.cpp): a
copy of `slam_tpu/native/__init__.py` for the port.

The reference's runtime is C++ (pthread fan-outs, scalar DDA raycast,
OpenCV preambles); here the card owns the compute path and these native
pieces serve the host side: exact-semantics raycast oracle / sensor
simulation off-device, disc erosion for vehicle inflation, and a threaded
scan prefetcher. They load the same `.build/libslam_native.so` that
`native/build.sh` builds. Without it they fall back to the port's CPU code:
the march of `ops/raycast.py` on CPU tensors and `utils/maps.erode`. All of
it is host-side and never stands in for the card.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".build", "libslam_native.so"),
]

_lib = None
for _p in _LIB_PATHS:
    if os.path.exists(_p):
        try:
            _lib = ctypes.CDLL(_p)
            break
        except OSError:
            pass

if _lib is not None:
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    _f32p = ctypes.POINTER(ctypes.c_float)
    _lib.rc_raycast_batch.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, _f32p, _f32p, _f32p,
        ctypes.c_long, ctypes.c_float, ctypes.c_float, _f32p, _u8p,
    ]
    _lib.rc_scan_poses.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, _f32p, _f32p, _f32p,
        ctypes.c_long, _f32p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        _f32p, _u8p,
    ]
    _lib.em_erode_disc.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p,
    ]
    _lib.rc_hardware_threads.restype = ctypes.c_int


def available() -> bool:
    return _lib is not None


def _as_c(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _march(blocked, x, y, theta, step, max_dist):
    """The fallback raycast: the port's fixed-step march on the CPU."""
    import torch

    from slam_tpu_torch.ops.raycast import raycast_march

    d, hit = raycast_march(
        torch.from_numpy(np.asarray(blocked, bool)), torch.from_numpy(x),
        torch.from_numpy(y), torch.from_numpy(theta), step=step, max_dist=max_dist)
    return d.numpy(), hit.numpy()


def raycast_batch(blocked, x, y, theta, step=0.5, max_dist=500.0):
    """Exact reference-semantics DDA raycast (`slam/raycast.cpp:8-51`) on
    host threads. Returns (dist f32[n], hit bool[n])."""
    blocked = np.ascontiguousarray(blocked, np.uint8)
    h, w = blocked.shape
    x = np.ascontiguousarray(x, np.float32).ravel()
    y = np.ascontiguousarray(y, np.float32).ravel()
    theta = np.ascontiguousarray(theta, np.float32).ravel()
    n = x.size
    if _lib is None:
        return _march(blocked, x, y, theta, step, max_dist)
    dist = np.empty(n, np.float32)
    hit = np.empty(n, np.uint8)
    _lib.rc_raycast_batch(
        _as_c(blocked, ctypes.c_uint8), h, w,
        _as_c(x, ctypes.c_float), _as_c(y, ctypes.c_float),
        _as_c(theta, ctypes.c_float), n, step, max_dist,
        _as_c(dist, ctypes.c_float), _as_c(hit, ctypes.c_uint8),
    )
    return dist, hit.astype(bool)


def scan_poses(blocked, px, py, ptheta, beam_angles, step=0.5, max_dist=500.0):
    """Simulate a lidar over a trajectory: returns (dist f32[T, B],
    hit bool[T, B])."""
    blocked = np.ascontiguousarray(blocked, np.uint8)
    h, w = blocked.shape
    px = np.ascontiguousarray(px, np.float32).ravel()
    py = np.ascontiguousarray(py, np.float32).ravel()
    pt = np.ascontiguousarray(ptheta, np.float32).ravel()
    ba = np.ascontiguousarray(beam_angles, np.float32).ravel()
    t, b = px.size, ba.size
    if _lib is None:
        # The same f32 ray headings the native loop forms: pose + beam.
        dist, hit = _march(blocked, np.repeat(px, b), np.repeat(py, b),
                           (pt[:, None] + ba[None, :]).ravel(), step, max_dist)
        return dist.reshape(t, b), hit.reshape(t, b)
    dist = np.empty(t * b, np.float32)
    hit = np.empty(t * b, np.uint8)
    _lib.rc_scan_poses(
        _as_c(blocked, ctypes.c_uint8), h, w,
        _as_c(px, ctypes.c_float), _as_c(py, ctypes.c_float),
        _as_c(pt, ctypes.c_float), t, _as_c(ba, ctypes.c_float), b,
        step, max_dist,
        _as_c(dist, ctypes.c_float), _as_c(hit, ctypes.c_uint8),
    )
    return dist.reshape(t, b), hit.reshape(t, b).astype(bool)


def erode_disc(binary, radius: int):
    """Binary disc erosion (vehicle inflation). binary: any int/bool [H, W];
    returns same dtype."""
    if _lib is None:
        from slam_tpu_torch.utils.maps import erode

        return erode(binary, radius)
    arr = np.ascontiguousarray(binary.astype(np.uint8))
    h, w = arr.shape
    out = np.empty_like(arr)
    _lib.em_erode_disc(
        _as_c(arr, ctypes.c_uint8), h, w, radius, _as_c(out, ctypes.c_uint8)
    )
    return out.astype(binary.dtype)


class ScanPrefetcher:
    """Threaded sensor-feed: simulates scans for upcoming poses on host
    threads while the device crunches the current step (the reference's
    runtime role of feeding MCL from FakeLidar, made asynchronous)."""

    def __init__(self, blocked, beam_angles, step=0.5, max_dist=500.0, depth=4):
        self._blocked = np.ascontiguousarray(blocked, np.uint8)
        self._angles = np.asarray(beam_angles, np.float32)
        self._step = step
        self._max_dist = max_dist
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._in: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, x: float, y: float, theta: float) -> None:
        self._in.put((x, y, theta))

    def get(self):
        """(dist f32[B], hit bool[B]) for the oldest submitted pose."""
        return self._q.get()

    def _run(self):
        while True:
            item = self._in.get()
            if item is None:
                break
            x, y, theta = item
            d, hh = scan_poses(
                self._blocked, [x], [y], [theta], self._angles,
                self._step, self._max_dist,
            )
            self._q.put((d[0], hh[0]))

    def close(self):
        self._in.put(None)
