"""RRT* planner demo (headless rebuild of `apps/rrt_planner.cpp`; port of
`slam_tpu/apps/rrt_planner.py`, on the CUDA card unless `--cpu`).

The reference takes endpoints from mouse clicks on an eroded CV_64F map,
runs RRTStar(reach=20, radius=50) until a path exists AND at least n_points
nodes were added (`apps/rrt_planner.cpp:50`), then draws the tree + path.

    python -m slam_tpu_torch.apps.rrt_planner --map floor_plan.png \
        --start 150 450 --goal 450 750 --n-points 2000 --out rrt.png
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from slam_tpu_torch.apps.common import app_device, inflate, load_blocked, measure_time
from slam_tpu_torch.core.config import RRTStarConfig
from slam_tpu_torch.planners import RRTStar
from slam_tpu_torch.utils import render


def _tree(state):
    """The tree as host arrays: (x, y, parent, valid)."""
    return tuple(getattr(state, f).cpu().numpy() for f in ("x", "y", "parent", "valid"))


def main(argv=None, result=None):
    """Run the demo; returns whether a path was found. A dict `result`
    receives the last query's path and the inflated map's free cells
    (bool[H, W]) under "path" and "free"."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--map", default=None)
    ap.add_argument("--start", type=float, nargs=2, default=None, metavar=("X", "Y"))
    ap.add_argument("--goal", type=float, nargs=2, default=None, metavar=("X", "Y"))
    ap.add_argument("--reach", type=float, default=20.0)
    ap.add_argument("--radius", type=float, default=50.0)
    ap.add_argument("--n-points", type=int, default=1000)
    ap.add_argument("--max-nodes", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--inflate", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1234)  # `benchmark/rrtstar.cpp`
    ap.add_argument("--out", default="rrt.png")
    ap.add_argument("--animate", default=None, metavar="GIF",
                    help="write tree-growth animation (round-by-round API)")
    ap.add_argument(
        "--interactive", action="store_true",
        help="read 'X1 Y1 X2 Y2' queries from stdin and replan on the warm "
        "planner (headless mouse loop, `apps/rrt_planner.cpp:44-68`)",
    )
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA card")
    args = ap.parse_args(argv)

    dev = app_device(args.cpu)

    blocked = load_blocked(args.map)
    h, w = blocked.shape
    free = torch.from_numpy(~inflate(blocked, args.inflate))

    start = tuple(args.start or (w * 0.25, h * 0.5))
    goal = tuple(args.goal or (w * 0.75, h * 0.25))
    cfg = RRTStarConfig(
        reach=args.reach,
        radius=args.radius,
        max_nodes=args.max_nodes,
        batch=args.batch,
    )
    planner = RRTStar(free, start, goal, cfg, seed=args.seed, device=dev)

    def run_and_render(out):
        frames = []
        with measure_time("RRT* pathfind"):
            # Iterate until success AND enough nodes (`rrt_planner.cpp:50`).
            while True:
                done = planner.pathfind()
                if args.animate:
                    fr = render.blocked_to_rgb(blocked)
                    xs0, ys0, par0, val0 = _tree(planner.state)
                    for i in np.nonzero(val0)[0]:
                        if par0[i] >= 0:
                            render.draw_path_world(
                                fr, [(xs0[i], ys0[i]), (xs0[par0[i]], ys0[par0[i]])],
                                render.BLUE,
                            )
                    frames.append(fr)
                if (done or planner.success) and planner.size >= args.n_points:
                    break
                if planner.used_up:
                    break
        if args.animate and frames:
            render.save_gif(frames, args.animate, fps=5)
            print(f"animation -> {args.animate}")

        img = render.blocked_to_rgb(blocked)
        # Tree edges (the reference draws each as it is added).
        xs, ys, par, val = _tree(planner.state)
        for i in np.nonzero(val)[0]:
            p = par[i]
            if p >= 0:
                render.draw_path_world(img, [(xs[i], ys[i]), (xs[p], ys[p])], render.BLUE)
        path = planner.recover_path() if planner.success else []
        if result is not None:
            result.update(path=path, free=free.numpy())
        if planner.success:
            render.draw_path_world(img, path, render.GREEN)
            print(f"path cost {planner.path_cost():.1f}, {planner.size} nodes")
        else:
            print(f"no path ({planner.size} nodes)")
        render.save_png(img, out)
        print(f"-> {out}")
        return planner.success

    ok = run_and_render(args.out)
    if args.interactive:
        from slam_tpu_torch.apps.common import interactive_queries

        stem, dot, ext = args.out.rpartition(".")
        for k, (s, g) in enumerate(interactive_queries(), start=1):
            planner.reset_query(s, g, seed=args.seed)  # warm replan
            ok = run_and_render(f"{stem}_{k}{dot}{ext}" if dot else f"{args.out}_{k}")
    return ok


if __name__ == "__main__":
    main()
