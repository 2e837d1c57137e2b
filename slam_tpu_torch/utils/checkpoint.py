"""Checkpoint / resume for filter and SLAM state (port of
`slam_tpu/utils/checkpoint.py`).

The reference has no checkpointing (all state in memory). For production
SLAM the filter state (particles, log-odds grid, random generator, step
counters) must survive restarts. The JAX package writes orbax
directories; the port writes `torch.save` of one nested dict of tensors:
dataclass fields and tuple items become dict keys, tensors go to the CPU,
and each `torch.Generator`'s state is saved beside its device, so a
restored filter draws what the saved one would have drawn next (the
counterpart of the JAX package's `_unkey` / `_rekey` for typed keys).
`restore` takes a template state (a freshly initialized one) for the
structure, dtypes and devices.

Older layouts of the port's states restore through `_migrate`: a field
added since the checkpoint was written fills with its documented default
(`_MIGRATIONS`), and a saved field whose shape differs from the template's
is a real configuration mismatch and raises. The port does not read orbax
directories: JAX state crosses over through `utils/convert.py`.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Any

import torch

_FILE = "state.pt"
_GEN = "__generator_state__"
_MISSING = object()


def _to_raw(tree):
    """A state as the nested dict that is saved."""
    if isinstance(tree, torch.Generator):
        return {_GEN: tree.get_state()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _to_raw(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {str(k): _to_raw(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _to_raw(v) for i, v in enumerate(tree)}
    return tree


def _lookup(raw, keys):
    """Walk the raw nested dict by string keys; _MISSING if absent."""
    node = raw
    for k in keys:
        if not isinstance(node, dict) or k not in node:
            return _MISSING
        node = node[k]
    return node


# Fields added to MCLState/SLAMState after the first layout, with their
# documented migration defaults (PARITY.md "checkpoint format"). Keys are
# leaf-path SUFFIXES matched against the template's paths; values map the
# missing leaf to (source path in the OLD checkpoint, fallback literal).
# `est_pose`/`mode_pose` start from the saved best particle, which is what
# the older engines reported as their estimate; the adaptive EMAs restart
# from their NaN "no update seen" sentinel (they warm-start from the first
# observed likelihood, models/mcl.py); `updates` restarts from the saved
# frame counter `step` (exact when update_every=1, an upper bound
# otherwise: the every-k throttles at most fire one early).
_MIGRATIONS = {
    ("est_pose",): (("mcl", "best_pose"), None),
    ("mode_pose",): (("mcl", "best_pose"), None),
    ("log_w_slow",): (None, float("nan")),
    ("log_w_fast",): (None, float("nan")),
    ("updates",): (("mcl", "step"), 0),
}


def _fill(keys, tleaf, raw):
    """The migrated value of a leaf absent from the checkpoint: from its
    `_MIGRATIONS` source or literal, else the template's own."""
    for suffix, (src, literal) in _MIGRATIONS.items():
        child = ()
        if keys[-len(suffix):] != suffix:
            # 'est_pose'/'x' (a Pose subtree's leaf) matches 'est_pose'.
            if keys[-len(suffix) - 1:-1] != suffix:
                continue
            child = keys[-1:]
        saved = _MISSING if src is None else _lookup(raw, src + child)
        if saved is not _MISSING:
            return _leaf(keys, tleaf, saved)
        if literal is not None:
            return _leaf(keys, tleaf, literal)
        break
    return tleaf


def _leaf(keys, tleaf, saved):
    """The saved value `saved` in the template leaf's type, dtype, shape
    and device."""
    if isinstance(tleaf, torch.Tensor):
        value = torch.as_tensor(saved)
        if value.dim() == 0 and tleaf.dim() > 0 and not isinstance(saved, torch.Tensor):
            value = value.expand(tleaf.shape)  # a literal fills the whole leaf
        if tuple(value.shape) != tuple(tleaf.shape):
            raise ValueError(
                f"checkpoint field {'/'.join(keys)} has shape {tuple(value.shape)} but "
                f"the template expects {tuple(tleaf.shape)}: this is a real config "
                "mismatch (particle count / map size), not a format change; migration "
                "cannot fix it"
            )
        return value.to(device=tleaf.device, dtype=tleaf.dtype).clone()
    if isinstance(tleaf, torch.Generator):
        g = torch.Generator(device=tleaf.device)
        g.set_state(saved[_GEN])
        return g
    if isinstance(tleaf, (bool, int, float)):
        return type(tleaf)(saved.item() if isinstance(saved, torch.Tensor) else saved)
    return saved


def _migrate(raw: dict, template: Any):
    """The template's structure filled from `raw`: (state, the paths of
    the leaves the checkpoint lacked, filled with migration defaults).
    Raises ValueError when a saved leaf's shape mismatches the template's
    (a genuine incompatibility, not a format addition)."""
    filled = []

    def walk(t, keys):
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{
                f.name: walk(getattr(t, f.name), keys + (f.name,))
                for f in dataclasses.fields(t)})
        if isinstance(t, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, keys + (str(i),)) for i, v in enumerate(t))
        saved = _lookup(raw, keys)
        if saved is None and t is None:
            return None
        if saved is not None and saved is not _MISSING and not (
                isinstance(saved, dict) and _GEN not in saved):
            return _leaf(keys, t, saved)
        name = "/".join(keys)
        if keys[-1] == "edt":
            # A DERIVED cache: the template's value belongs to the
            # template's grid, not the restored one: consumers re-derive
            # it (slam.rebuild_edt) after a migrated restore.
            name += " (derived cache: re-derive from the restored grid, e.g. slam.rebuild_edt)"
        filled.append(name)
        return _fill(keys, t, raw)

    return walk(template, ()), filled


def _warn_filled(filled, where: str) -> None:
    if filled:
        from slam_tpu_torch.utils.logging import get_logger

        get_logger(__name__).warning(
            "checkpoint at %s predates the current state format; filled %d missing "
            "field(s) with migration defaults: %s", where, len(filled), ", ".join(filled))


def save(path: str, state: Any) -> None:
    """Write a state to `path` (a directory), replacing what is there."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{_FILE}.{os.getpid()}.tmp")
    torch.save(_to_raw(state), tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def restore(path: str, template: Any) -> Any:
    """Read a state saved by `save`; `template` supplies the structure,
    dtypes and devices (e.g. a freshly initialized state). Older layouts
    are migrated (see `_MIGRATIONS`) and a warning lists what was filled."""
    path = os.path.abspath(path)
    raw = torch.load(os.path.join(path, _FILE), weights_only=True)
    state, filled = _migrate(raw, template)
    _warn_filled(filled, path)
    return state


class CheckpointManager:
    """Rolling step-indexed checkpoints (keep the latest `max_to_keep`):
    one `save` directory per step under `directory`."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if re.fullmatch(r"\d+", d)
                      and os.path.exists(os.path.join(self.directory, d, _FILE)))

    def save(self, step: int, state: Any) -> None:
        save(os.path.join(self.directory, str(int(step))), state)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self):
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}: nothing has been saved "
                "yet (latest_step() is None)")
        return restore(os.path.join(self.directory, str(int(step))), template)

    def close(self) -> None:
        """Nothing is written in the background: saves are synchronous."""
