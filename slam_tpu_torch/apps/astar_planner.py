"""A* grid planner demo (port of `slam_tpu/apps/astar_planner.py`; on the
CUDA card unless `--cpu`).

The reference ships A* as library-only (no app drives it — SURVEY.md
section 3.5); this demo completes the set: wavefront distance field from
start, greedy-descent path recovery, PNG output.

    python -m slam_tpu_torch.apps.astar_planner --map floor_plan.png \
        --start 450 250 --goal 250 650
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from slam_tpu_torch.apps.common import app_device, inflate, load_blocked, measure_time
from slam_tpu_torch.planners import AStar
from slam_tpu_torch.utils import render


def main(argv=None, result=None):
    """Run the demo; returns whether a path was found. A dict `result`
    receives the last query's path and the inflated map's free cells
    (bool[H, W]) under "path" and "free"."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--map", default=None)
    ap.add_argument("--start", type=int, nargs=2, default=None, metavar=("I", "J"))
    ap.add_argument("--goal", type=int, nargs=2, default=None, metavar=("I", "J"))
    ap.add_argument("--inflate", type=int, default=0)
    ap.add_argument("--out", default="astar.png")
    ap.add_argument("--animate", default=None, metavar="GIF",
                    help="write wavefront animation (uses the incremental API)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA card")
    args = ap.parse_args(argv)

    dev = app_device(args.cpu)

    blocked = load_blocked(args.map)
    h, w = blocked.shape
    free = torch.from_numpy(~inflate(blocked, args.inflate))
    start = tuple(args.start or (h // 2, w // 4))
    goal = tuple(args.goal or (3 * h // 4 + h // 8, 3 * w // 4))

    planner = AStar(free, start, goal, device=dev)
    if args.animate:
        frames = []
        with measure_time("A* distance field (animated)"):
            while not planner.pathfind(rounds=16):
                img = render.blocked_to_rgb(blocked)
                reached = (planner.dist < 1e29).cpu().numpy()
                img[reached] = (img[reached] * 0.4 + np.array(render.BLUE) * 0.6).astype(
                    np.uint8
                )
                frames.append(img)
        ok = planner.success
        if frames:
            render.save_gif(frames, args.animate)
            print(f"animation -> {args.animate}")
    else:
        with measure_time("A* distance field"):
            ok = planner.solve()

    img = render.blocked_to_rgb(blocked)
    path = planner.recover_path() if ok else []
    if result is not None:
        result.update(path=path, free=free.numpy())
    if ok:
        render.draw_path_cells(img, path, render.GREEN)
        print(f"path: {len(path)} cells, cost {planner.path_cost():.1f}")
    else:
        print("no path found")
    render.draw_disc(img, start[0], start[1], 4, render.BLUE)
    render.draw_disc(img, goal[0], goal[1], 4, render.RED)
    render.save_png(img, args.out)
    print(f"-> {args.out}")
    return ok


if __name__ == "__main__":
    main()
