"""Reading the device from torch.profiler traces.

A profiler session can lose device events at its edges, so every session
here runs short spin kernels before the profiled work and long ones after
it (the bracket of `chip_smoke.py:traced_kernels`), and only the device
events between the last short spin and the first long one count. That
span of the device's timeline is the traced window.
"""

from __future__ import annotations

import sys

import torch

PAD_SPINS = 64
LEAD_SPIN_CYCLES = 2_000
TRAIL_SPIN_CYCLES = 100_000
SPIN_SPLIT_US = 20.0
GAP_US = 5.0
# Host-side runtime calls that issue work to the card or wait for it.
HOST_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cudaMemcpyAsync",
              "cudaMemsetAsync", "cudaMemcpy", "cudaStreamSynchronize", "cudaEventSynchronize")


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


class Session:
    """A bracketed profiler session: `with Session() as s:` runs the lead
    spins on entry and the trail spins and a sync on exit; then
    `s.analyse()`."""

    def __init__(self, host: bool = True):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
        self.prof = profile(activities=acts)

    def __enter__(self):
        torch.cuda.synchronize()
        self.prof.__enter__()
        for _ in range(PAD_SPINS):
            torch.cuda._sleep(LEAD_SPIN_CYCLES)
        return self

    def __exit__(self, *exc):
        for _ in range(PAD_SPINS):
            torch.cuda._sleep(TRAIL_SPIN_CYCLES)
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def analyse(self) -> dict:
        """The traced window: its length and the device's busy time in it
        (the union of kernel and copy intervals), in seconds; the device
        operations by total seconds; the idle gaps by the host activity
        under them, by total seconds; and the host's runtime calls."""
        events = list(self.prof.events())
        dev = [e for e in events if _is_device(e) and e.device_time > 0]
        spins = [e for e in dev if "spin_kernel" in e.name]
        lead = [e.time_range.end for e in spins if e.device_time < SPIN_SPLIT_US]
        trail = [e.time_range.start for e in spins if e.device_time >= SPIN_SPLIT_US]
        if not lead or not trail:
            raise RuntimeError(
                f"the profiler's trace kept no spin kernel before or after the work: "
                f"{len(dev)} device events, {len(lead)} short and {len(trail)} long spins, "
                f"spin us {sorted(e.device_time for e in spins)[:3]} .. "
                f"{sorted(e.device_time for e in spins)[-3:]}, first / last events "
                f"{[e.name[:40] for e in dev[:2]]} / {[e.name[:40] for e in dev[-2:]]}")
        lo, hi = max(lead), min(trail)
        inside = [e for e in dev if lo <= e.time_range.start < hi and "spin_kernel" not in e.name]
        ivs = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in inside)
        union, busy = [], 0.0
        for a, b in ivs:
            if union and a <= union[-1][1]:
                union[-1][1] = max(union[-1][1], b)
            else:
                union.append([a, b])
        busy = sum(b - a for a, b in union)
        ops = {}
        for e in inside:
            ops[e.name] = ops.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) * 1e-6
        # Idle gaps, each named by the innermost host activity under its
        # middle; the gaps between the kernels of one replay (under
        # GAP_US) are the device's own and go under one name.
        edges = [lo] + [v for iv in union for v in iv] + [hi]
        gaps = sorted((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a)
        host = sorted(((e.time_range.start, e.time_range.end, e.name)
                       for e in events if not _is_device(e)))
        idle, active, k = {}, [], 0
        for a, b in gaps:
            if b - a < GAP_US:
                idle["between kernels (< 5 us)"] = idle.get("between kernels (< 5 us)", 0.0) + (b - a) * 1e-6
                continue
            mid = 0.5 * (a + b)
            while k < len(host) and host[k][0] <= mid:
                active.append(host[k])
                k += 1
            active = [h for h in active if h[1] > mid]
            name = max(active)[2] if active else "host idle"
            idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
        calls = sum(1 for e in events if not _is_device(e) and e.name in HOST_CALLS)
        return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
                "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
                "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
                "host_calls": calls - 2 * PAD_SPINS}


def device_ms(fn, iters: int = 20, warmup: int = 3, tries: int = 3) -> float:
    """Device ms a call of `fn` keeps the card busy: the union of its
    device intervals over `iters` calls in a bracketed session, per call.
    A session whose trace lost its bracket is taken again, up to `tries`
    sessions in all."""
    for _ in range(warmup):
        fn()
    for t in range(1, tries + 1):
        with Session(host=False) as s:
            for _ in range(iters):
                fn()
        try:
            return s.analyse()["busy_s"] * 1e3 / iters
        except RuntimeError as e:
            if t == tries:
                raise
            print(f"portbench: device_ms session {t}: {e}", file=sys.stderr)
