"""Raycast backend dispatch (port of `slam_tpu/ops/rayfield.py`).

Four backends: ``march`` (exact fixed-step DDA), ``sdf`` (sphere trace
over a Euclidean distance transform: `edt_exact` for a static map,
`edt_jfa` for the per-step rebuild), ``lut`` (dense directional table)
and ``cddt`` (the compressed interval table of `ops/cddt.py`, for maps
whose dense table outgrows memory). A `RayField` built with an EDT serves
the likelihood-field measurements whatever the backend.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional

import numpy as np
import torch

from slam_tpu_torch.core.config import RaycastConfig
from slam_tpu_torch.ops import cddt as cddtlib
from slam_tpu_torch.ops import edt as edtlib
from slam_tpu_torch.ops import lut as lutlib
from slam_tpu_torch.ops.raycast import raycast_march, raycast_sdf
from slam_tpu_torch.utils.logging import get_logger


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
    # Compressed directional table (cddt backend).
    cddt: Optional[cddtlib.CDDTTable] = None


def _cache_path(host: np.ndarray, rc: RaycastConfig, cache_dir: str) -> str:
    # The JAX package's keys, byte for byte: a table it cached loads here.
    if rc.backend == "cddt":
        tag, name, ext = f"{rc.cddt_k}|cddt-v1", "cddt", "npz"
    else:
        tag, name, ext = f"{rc.max_dist}|{rc.lut_dtype}|v2", "beam_lut", "npy"
    key = hashlib.sha1(
        host.tobytes() + f"{host.shape}|{rc.lut_bins}|{tag}".encode()
    ).hexdigest()[:16]
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"{name}_{key}.{ext}")


def _cddt_field(blocked: torch.Tensor, rc: RaycastConfig, cache_dir) -> RayField:
    """The cddt backend's field: the table from the `cddt-v1` npz cache when
    `cache_dir` holds it, else built (and cached). A table that dropped
    runs warns, on a cache hit too: it is wrong every run."""
    path = None if cache_dir is None else _cache_path(blocked.cpu().numpy(), rc, cache_dir)
    table = None
    if path is not None and os.path.exists(path):
        z = np.load(path)
        table = cddtlib.CDDTTable(
            starts=torch.from_numpy(z["starts"]).to(blocked.device),
            ends=torch.from_numpy(z["ends"]).to(blocked.device),
            n_bins=rc.lut_bins, n_overflow=int(z["n_overflow"]))
    fresh = table is None
    if fresh:
        table = cddtlib.build_cddt(blocked, n_bins=rc.lut_bins, k=rc.cddt_k)
    if table.n_overflow:
        get_logger().warning(
            "cddt table dropped %d runs (cddt_k=%s too small); far obstacles "
            "may read as misses", table.n_overflow, rc.cddt_k)
    if fresh and path is not None:
        np.savez(path, starts=table.starts.cpu().numpy(), ends=table.ends.cpu().numpy(),
                 n_overflow=table.n_overflow)
    return RayField(blocked=blocked, cddt=table)


def make_ray_field(
    blocked, rc: RaycastConfig, cache_dir: Optional[str] = None, device=None
) -> RayField:
    """Build the backend structure for a static map (one-off), on `device`
    (default: `blocked`'s device).

    `cache_dir` caches the LUT or the CDDT table on disk in the JAX
    package's format (same sha1 key; a bf16 LUT saved as its uint16 bits,
    the CDDT as the `cddt-v1` npz), so either package loads a table the
    other wrote."""
    blocked = torch.as_tensor(blocked, dtype=torch.bool, device=device)
    if rc.backend == "march":
        return RayField(blocked=blocked)
    if rc.backend == "sdf":
        return RayField(blocked=blocked, edt=edtlib.edt_exact(blocked))
    if rc.backend == "cddt":
        return _cddt_field(blocked, rc, cache_dir)
    if rc.backend != "lut":
        raise ValueError(f"unknown raycast backend: {rc.backend}")
    dtype = {"bf16": torch.bfloat16, "u8": torch.uint8}[rc.lut_dtype]
    path = None
    if cache_dir is not None:
        path = _cache_path(blocked.cpu().numpy(), rc, cache_dir)
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


def raycast_field(field: RayField, x, y, theta, rc: RaycastConfig, early_exit: bool = True):
    """(dist, hit) for a ray batch via the configured backend. With
    `early_exit` False the march and the sphere trace run their whole
    count with no host read (the same result; `ops/raycast.py`)."""
    if rc.backend == "march":
        return raycast_march(
            field.blocked, x, y, theta,
            step=rc.step, max_dist=rc.max_dist, chunk=rc.chunk, early_exit=early_exit,
        )
    if rc.backend == "sdf":
        if field.edt is None:
            raise ValueError("sdf backend needs field.edt")
        return raycast_sdf(
            field.edt, x, y, theta,
            step=rc.step, max_dist=rc.max_dist, margin=rc.sdf_margin,
            early_exit=early_exit,
        )
    if rc.backend == "lut":
        if field.lut is None:
            raise ValueError("lut backend needs field.lut")
        return lutlib.raycast_lut(
            field.lut, x, y, theta, max_dist=rc.max_dist, n_bins=field.lut_bins
        )
    if rc.backend == "cddt":
        if field.cddt is None:
            raise ValueError("cddt backend needs field.cddt")
        return cddtlib.raycast_cddt(
            field.cddt, x, y, theta, max_dist=rc.max_dist, shape=field.blocked.shape
        )
    raise ValueError(f"unknown raycast backend: {rc.backend}")


def as_ray_field(field_or_blocked, rc: RaycastConfig) -> RayField:
    """Accept either a prebuilt RayField or a raw blocked mask (rebuilt by
    `dynamic_ray_field`)."""
    if isinstance(field_or_blocked, RayField):
        return field_or_blocked
    return dynamic_ray_field(field_or_blocked, rc)
