"""A traffic generator: a robot driving laps of a closed path through the
floor plan's door gaps, read from a data file of parameters
(`portbench/traffic/<name>.json`, whose `generator` names this module).

A request hands the system what a robot's driver hands its localizer:
the odometry since the last frame and the frame's scan. The truth moves
along the lap exactly, `frame_px` a frame; the odometry is the truth's
increment (the inverse odometry model) plus noise drawn from the seed
through the motion model's alphas; scans are cast from the truth's
sensor pose once per lap at set-up. Every seed drives the same
lap, so the work of a run does not depend on the seed; the seed draws
the odometry noise, the episodes' starting points and the filter's own
random stream.

Parameters (the data file):
  generator       "lap"
  kind            the kind of request every frame sends (the request
                  module's name for it)
  lap             {"cx", "y_bottom", "radius", "frames"}: a stadium, one
                  semicircle of `radius` centred (cx, y_bottom), the other
                  straight above it, closed in `frames` scan frames
  frame_px        px the truth moves a frame
  max_turn_rad    the largest heading change a frame may make
  clearance_px    the least distance of the robot and of its sensor from
                  any blocked cell
  episode         requests of an episode, the first of which wakes the
                  robot up lost (0: one unbroken drive)
  max_rate        requests a second whose noise is drawn at set-up (a
                  faster window draws more of the same stream)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from portbench.traffic import world


def stadium_pose(s: float, cx: float, yb: float, r: float, straight: float):
    """(x, y, heading) at arc length s of the counter-clockwise stadium
    whose right straight starts at (cx + r, yb) heading north."""
    half = math.pi * r
    total = 2.0 * straight + 2.0 * half
    s = s % total
    if s < straight:
        return cx + r, yb + s, math.pi / 2
    s -= straight
    if s < half:
        a = s / r  # around (cx, yb + straight), from angle 0
        return cx + r * math.cos(a), yb + straight + r * math.sin(a), math.pi / 2 + a
    s -= half
    if s < straight:
        return cx - r, yb + straight - s, 1.5 * math.pi
    s -= straight
    a = math.pi + s / r  # around (cx, yb), from angle pi
    return cx + r * math.cos(a), yb + r * math.sin(a), math.pi / 2 + a


def wrap(a):
    return (np.asarray(a) + math.pi) % (2.0 * math.pi) - math.pi


def increments(poses: np.ndarray) -> np.ndarray:
    """(rot1, trans, rot2) f64 [T, 3] taking pose t to pose t + 1 of the
    closed path `poses` [T, 3] (the last back to the first)."""
    nxt = np.roll(poses, -1, axis=0)
    dx, dy = nxt[:, 0] - poses[:, 0], nxt[:, 1] - poses[:, 1]
    trans = np.hypot(dx, dy)
    rot1 = wrap(np.arctan2(dy, dx) - poses[:, 2])
    rot2 = wrap(nxt[:, 2] - poses[:, 2] - rot1)
    return np.stack([rot1, trans, rot2], axis=1)


def clearance(blocked: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Distance from each world point [T, 2] to the centre of the nearest
    blocked cell, px."""
    h = blocked.shape[0]
    bi, bj = np.nonzero(blocked)
    bx, by = bj.astype(np.float64) + 0.5, (h - bi).astype(np.float64) - 0.5
    out = np.empty(len(xy))
    for k0 in range(0, len(xy), 64):
        p = xy[k0:k0 + 64]
        d2 = (p[:, 0:1] - bx[None]) ** 2 + (p[:, 1:2] - by[None]) ** 2
        out[k0:k0 + 64] = np.sqrt(d2.min(axis=1))
    return out


@dataclasses.dataclass
class Request:
    kind: str  # "init" (an episode's wake-up) or the mix's `kind`
    odom: Optional[tuple]  # (rot1, trans, rot2) as the robot reports it
    scan: Optional[int]  # row of `Traffic.dists`; None on a wake-up
    truth: int  # the frame the request ends at


class Traffic:
    """The requests of one run: `request(k)` for k = 0, 1, ... over laps
    of the path (or episodes), and the scans they carry as host tensors
    (`dists` f32 [frames, B], `angles` f32 [B])."""

    def __init__(self, spec: dict, cfg: dict, blocked: np.ndarray, seed: int, seconds: float,
                 scan_device=None):
        lap = spec["lap"]
        self.frame_px = float(spec["frame_px"])
        self.frames = int(lap["frames"])
        r = float(lap["radius"])
        straight = (self.frames * self.frame_px - 2.0 * math.pi * r) / 2.0
        if straight <= 0:
            raise ValueError("the lap is shorter than its two semicircles")
        self.poses = np.array([
            stadium_pose(f * self.frame_px, lap["cx"], lap["y_bottom"], r, straight)
            for f in range(self.frames)])
        self.poses[:, 2] = wrap(self.poses[:, 2])
        self.steps = increments(self.poses)
        self.episode = int(spec.get("episode", 0))
        self.kind = spec["kind"]
        offset = cfg["scanner_offset"]
        self._check(spec, cfg, blocked, offset)

        lidar = cfg["lidar"]
        dev = torch.device("cpu") if scan_device is None else scan_device
        self.dists = world.scans(torch.from_numpy(blocked).to(dev), self.poses, lidar,
                                 offset).cpu()
        self.angles = torch.tensor(world.beam_angles(lidar["start"], lidar["stop"],
                                                     lidar["n_rays"]), dtype=torch.float32)
        # Noise and episode starts drawn ahead for `max_rate` requests a
        # second; a faster window draws the next chunk of the same stream.
        self._chunk = int(math.ceil(seconds * float(spec["max_rate"]))) + 1
        self._rng = np.random.default_rng([int(seed), 0x1a9])
        self.noise = np.empty((0, 3))
        self.starts = np.empty((0,), np.int64)
        self._draw()
        a = cfg["alphas"]
        r1, t, r2 = self.steps[:, 0], self.steps[:, 1], self.steps[:, 2]
        self.std = np.stack([np.sqrt(a[0] * r1 * r1 + a[1] * t * t),
                             np.sqrt(a[2] * t * t + a[3] * (r1 * r1 + r2 * r2)),
                             np.sqrt(a[0] * r2 * r2 + a[1] * t * t)], axis=1)

    def _draw(self) -> None:
        n = self._chunk
        self.noise = np.concatenate([self.noise, self._rng.standard_normal((n, 3))])
        self.starts = np.concatenate([
            self.starts, self._rng.integers(0, self.frames, size=n // max(1, self.episode) + 1)])

    def _check(self, spec, cfg, blocked, offset):
        turn = np.abs(wrap(np.roll(self.poses[:, 2], -1) - self.poses[:, 2]))
        if turn.max() > spec["max_turn_rad"] + 1e-9:
            raise ValueError(f"the lap turns {turn.max():.4f} rad in a frame, over "
                             f"{spec['max_turn_rad']}")
        p = torch.from_numpy(self.poses)
        sx, sy, _ = world.sensor_pose(p[:, 0], p[:, 1], p[:, 2], offset)
        for name, xy in (("robot", self.poses[:, :2]),
                         ("sensor", torch.stack([sx, sy], 1).numpy())):
            c = clearance(blocked, xy)
            if c.min() < spec["clearance_px"]:
                raise ValueError(f"the {name} comes {c.min():.2f} px from a wall on the lap, "
                                 f"under the {spec['clearance_px']} px clearance")
        gh, gw = cfg.get("grid", blocked.shape)
        if not (self.poses[:, 0].min() > 0 and self.poses[:, 0].max() < gw
                and self.poses[:, 1].min() > 0 and self.poses[:, 1].max() < gh):
            raise ValueError("the lap leaves the map the filter holds")

    def start_pose(self):
        """The truth's pose where the run starts."""
        return tuple(self.poses[self._frame(0) if self.episode else 0])

    def _frame(self, k: int) -> int:
        """The frame request k ends at."""
        if not self.episode:
            return (k + 1) % self.frames
        e, j = divmod(k, self.episode)
        return (int(self.starts[e]) + j) % self.frames

    def request(self, k: int) -> Request:
        while k >= len(self.noise):
            self._draw()
        f = self._frame(k)
        if self.episode and k % self.episode == 0:
            return Request(kind="init", odom=None, scan=None, truth=f)
        prev = (f - 1) % self.frames
        odom = tuple(float(v) for v in self.steps[prev] + self.noise[k] * self.std[prev])
        return Request(kind=self.kind, odom=odom, scan=f, truth=f)
