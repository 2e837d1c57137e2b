"""Process-group start-up and the host helpers of a multi-process world
(port of `slam_tpu/parallel/distributed.py`).

JAX runs one process per host and sees every chip of the slice; the port
runs one process per rank, each holding its own shard, and the ranks meet
through a `torch.distributed` process group: NCCL where each rank has a
GPU of its own, gloo on the CPU (the tests) or for ranks that share one
card (NCCL refuses two ranks on one GPU). Nothing here reads a cluster's
environment: the caller gives the init method (`file://` or
`tcp://host:port`), the world size and the rank.

`launch_world` starts such a world as subprocesses under a wall-clock
limit and kills what is left at the limit; the tests, `chip_smoke.py` and
`tools/shard_bench.py` start their worlds through it.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist

from slam_tpu_torch.core.device import entry_device

_DEVICE = None


def initialize(
    init_method: str,
    world_size: int,
    rank: int,
    *,
    backend: str | None = None,
    device=None,
    timeout_s: float = 120.0,
) -> torch.device:
    """Join the world: `init_process_group` with `backend` and remember
    `device` as the device the mesh's shards live on. Returns that device.

    `device` defaults to the card, CUDA device rank % count, as the port's
    entry points do (`core/device.py:entry_device`): `device="cpu"` is the
    only way onto the CPU, and with no CUDA device the call raises before
    it joins. `backend` defaults to NCCL when each rank has a card of its
    own (world_size <= the device count), to gloo when ranks share a card
    or run on the CPU."""
    global _DEVICE
    if device is None:
        entry_device("cuda")  # raises where there is no card
        device = f"cuda:{rank % torch.cuda.device_count()}"
    device = entry_device(device)
    if backend is None:
        own_card = device.type == "cuda" and world_size <= torch.cuda.device_count()
        backend = "nccl" if own_card else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw,
    )
    _DEVICE = device
    return device


def device() -> torch.device:
    """The device `initialize` chose for this rank's shards."""
    if _DEVICE is None:
        raise RuntimeError("call parallel.distributed.initialize first")
    return _DEVICE


def shutdown() -> None:
    """Leave the world (every rank calls it once its work is done)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def is_multihost() -> bool:
    """More than one process in the world."""
    return dist.is_initialized() and dist.get_world_size() > 1


def host_local_slice(n_global: int) -> slice:
    """The [start, stop) range of a length-n_global particle axis that this
    process owns under even sharding over the world."""
    if not dist.is_initialized():
        return slice(0, n_global)
    per = n_global // dist.get_world_size()
    start = dist.get_rank() * per
    return slice(start, start + per)


def replicate_to_all_hosts(tree):
    """Rank 0's value of `tree` (tensors, numbers, and dicts, lists and
    tuples of them) on every rank: one broadcast per tensor, one object
    broadcast for the rest."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree

    def go(v):
        if isinstance(v, torch.Tensor):
            buf = v.clone().contiguous()
            dist.broadcast(buf, 0)
            return buf
        if isinstance(v, dict):
            return {k: go(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(go(x) for x in v)
        box = [v]
        dist.broadcast_object_list(box, 0)
        return box[0]

    return go(tree)


class World:
    """A world of `world` processes of `argv` (a list) started by
    `start_world`: rank r runs with RANK=r and WORLD_SIZE=world on top of
    `env`, its output going to temporary files."""

    def __init__(self, argv, world: int, timeout_s: float, env=None, cwd=None):
        base = dict(os.environ if env is None else env)
        self.timeout_s = timeout_s
        self.t0 = time.monotonic()
        self.procs, self.files = [], []
        self._result = None
        for r in range(world):
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            self.files.append((out, err))
            self.procs.append(subprocess.Popen(
                [str(a) for a in argv], env=dict(base, RANK=str(r), WORLD_SIZE=str(world)),
                cwd=cwd, stdout=out, stderr=err, text=True,
            ))

    def wait(self):
        """Wait for every rank until `timeout_s` after the start; ranks still
        running then are killed. Returns (exit codes, one per rank, None for
        a killed rank; stdout texts; stderr texts; seconds); a second call
        returns the same."""
        if self._result is not None:
            return self._result
        rcs = []
        for p in self.procs:
            left = max(0.1, self.timeout_s - (time.monotonic() - self.t0))
            try:
                rcs.append(p.wait(timeout=left))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rcs.append(None)
        outs, errs = [], []
        for out, err in self.files:
            for f, acc in ((out, outs), (err, errs)):
                f.seek(0)
                acc.append(f.read())
                f.close()
        self._result = (rcs, outs, errs, time.monotonic() - self.t0)
        return self._result


def start_world(argv, world: int, *, timeout_s: float, env=None, cwd=None) -> World:
    """Start `world` ranks of `argv` (see `World`) and return at once."""
    return World(argv, world, timeout_s, env, cwd)


def launch_world(argv, world: int, *, timeout_s: float, env=None, cwd=None):
    """`start_world(...).wait()`: run a world to its end or its limit."""
    return start_world(argv, world, timeout_s=timeout_s, env=env, cwd=cwd).wait()
