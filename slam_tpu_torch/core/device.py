"""The device of the port's entry points.

`MCL`, `GridSLAM`, `AStar`, `RRTStar` and `HybridAStar` run on the CUDA
card unless the caller names another device: `device="cpu"` is the only
way onto the CPU. Library functions that take tensors (`make_ray_field`,
`mcl.init`, ...) follow their inputs' device instead.
"""

from __future__ import annotations

import torch


def entry_device(device=None) -> torch.device:
    """`device` as a torch.device, or the current CUDA device for None.
    Raises RuntimeError when that is a CUDA device and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "slam_tpu_torch's entry points run on a CUDA device unless asked "
                "otherwise, and this machine has none: pass device=\"cpu\" to run "
                "on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
