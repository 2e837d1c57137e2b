"""Raycast backend dispatch (port of `slam_tpu/ops/rayfield.py`).

The port has the ``march`` (exact fixed-step DDA), ``sdf`` (sphere trace
over a Euclidean distance transform: `edt_exact` for a static map,
`edt_jfa` for the per-step rebuild) and ``lut`` (dense directional table)
backends. ``cddt`` waits for ROADMAP.md Queue 1 item 11. A `RayField`
built with an EDT serves the likelihood-field measurements whatever the
backend.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional

import numpy as np
import torch

from slam_tpu_torch.core.config import RaycastConfig
from slam_tpu_torch.ops import edt as edtlib
from slam_tpu_torch.ops import lut as lutlib
from slam_tpu_torch.ops.raycast import raycast_march, raycast_sdf

_NOT_PORTED = {"cddt": "ROADMAP.md Queue 1 item 11 (ops/cddt.py)"}


def _not_ported(backend: str):
    return NotImplementedError(
        f"raycast backend {backend!r} is not ported to slam_tpu_torch yet: "
        f"see {_NOT_PORTED[backend]}"
    )


@dataclasses.dataclass
class RayField:
    blocked: torch.Tensor  # bool[H, W]
    # f32[H, W] distance transform: the sdf backend sphere-traces it, and
    # the likelihood-field measurements read it (the SLAM step builds it
    # with `ops/edt.py:edt_capped`).
    edt: Optional[torch.Tensor] = None
    # [H, W, P] bins-last table; P >= lut_bins is the storage width.
    lut: Optional[torch.Tensor] = None
    # Semantic angular bin count.
    lut_bins: Optional[int] = None


def _cache_path(host: np.ndarray, rc: RaycastConfig, cache_dir: str) -> str:
    # The JAX package's key, byte for byte: a table it cached loads here.
    key = hashlib.sha1(
        host.tobytes()
        + f"{host.shape}|{rc.lut_bins}|{rc.max_dist}|{rc.lut_dtype}|v2".encode()
    ).hexdigest()[:16]
    return os.path.join(cache_dir, f"beam_lut_{key}.npy")


def make_ray_field(
    blocked, rc: RaycastConfig, cache_dir: Optional[str] = None, device=None
) -> RayField:
    """Build the backend structure for a static map (one-off), on `device`
    (default: `blocked`'s device).

    `cache_dir` caches the LUT on disk in the JAX package's format (same
    sha1 key, bf16 saved as its uint16 bits), so either package loads a
    table the other wrote."""
    blocked = torch.as_tensor(blocked, dtype=torch.bool, device=device)
    if rc.backend == "march":
        return RayField(blocked=blocked)
    if rc.backend == "sdf":
        return RayField(blocked=blocked, edt=edtlib.edt_exact(blocked))
    if rc.backend in _NOT_PORTED:
        raise _not_ported(rc.backend)
    if rc.backend != "lut":
        raise ValueError(f"unknown raycast backend: {rc.backend}")
    dtype = {"bf16": torch.bfloat16, "u8": torch.uint8}[rc.lut_dtype]
    path = None
    if cache_dir is not None:
        host = blocked.cpu().numpy()
        os.makedirs(cache_dir, exist_ok=True)
        path = _cache_path(host, rc, cache_dir)
        if os.path.exists(path):
            lut_np = np.load(path)
            if dtype == torch.bfloat16:  # stored as its uint16 bits
                lut = torch.from_numpy(lut_np.view(np.int16)).view(torch.bfloat16)
            else:
                lut = torch.from_numpy(lut_np)
            return RayField(
                blocked=blocked, lut=lut.to(blocked.device), lut_bins=rc.lut_bins
            )
    lut = lutlib.build_beam_lut(
        blocked, n_bins=rc.lut_bins, max_dist=rc.max_dist, dtype=dtype
    )
    if path is not None:
        host_lut = lut.cpu()
        if dtype == torch.bfloat16:
            host_lut = host_lut.view(torch.int16).numpy().view(np.uint16)
        else:
            host_lut = host_lut.numpy()
        np.save(path, host_lut)
    return RayField(blocked=blocked, lut=lut, lut_bins=rc.lut_bins)


def dynamic_ray_field(blocked, rc: RaycastConfig) -> RayField:
    """The rebuild for maps that change every step (SLAM mode): the sdf
    backend takes the jump-flooding transform; lut and cddt are rejected
    (their build only pays over a static map)."""
    blocked = torch.as_tensor(blocked, dtype=torch.bool)
    if rc.backend == "march":
        return RayField(blocked=blocked)
    if rc.backend == "sdf":
        return RayField(blocked=blocked, edt=edtlib.edt_jfa(blocked))
    raise ValueError(
        f"backend {rc.backend!r} cannot be rebuilt per-step; use 'sdf' or "
        "'march' for SLAM mode"
    )


def raycast_field(field: RayField, x, y, theta, rc: RaycastConfig):
    """(dist, hit) for a ray batch via the configured backend."""
    if rc.backend == "march":
        return raycast_march(
            field.blocked, x, y, theta,
            step=rc.step, max_dist=rc.max_dist, chunk=rc.chunk,
        )
    if rc.backend == "sdf":
        if field.edt is None:
            raise ValueError("sdf backend needs field.edt")
        return raycast_sdf(
            field.edt, x, y, theta,
            step=rc.step, max_dist=rc.max_dist, margin=rc.sdf_margin,
        )
    if rc.backend == "lut":
        if field.lut is None:
            raise ValueError("lut backend needs field.lut")
        return lutlib.raycast_lut(
            field.lut, x, y, theta, max_dist=rc.max_dist, n_bins=field.lut_bins
        )
    if rc.backend in _NOT_PORTED:
        raise _not_ported(rc.backend)
    raise ValueError(f"unknown raycast backend: {rc.backend}")


def as_ray_field(field_or_blocked, rc: RaycastConfig) -> RayField:
    """Accept either a prebuilt RayField or a raw blocked mask (rebuilt by
    `dynamic_ray_field`)."""
    if isinstance(field_or_blocked, RayField):
        return field_or_blocked
    return dynamic_ray_field(field_or_blocked, rc)
