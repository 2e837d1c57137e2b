"""Nearest-neighbor demo (headless rebuild of `apps/nearest_neighbor.cpp`;
port of `slam_tpu/apps/nearest_neighbor.py`, on the CUDA card unless
`--cpu`).

The reference scatters N random points, answers kd-tree NN queries on mouse
click, and has an `#ifdef KDTREE` switch comparing against a brute-force
linear scan (`apps/nearest_neighbor.cpp:10,25-38`). Here the batched dense
NN op IS the production kernel; `--check` cross-validates it against an
independent numpy scan (the reference's oracle pattern), and the result is
rendered to PNG.

    python -m slam_tpu_torch.apps.nearest_neighbor --n 500 --queries 5 --check
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from slam_tpu_torch.apps.common import app_device, measure_time
from slam_tpu_torch.ops import spatial
from slam_tpu_torch.utils import render


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--queries", type=int, default=5)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true", help="brute-force cross-check")
    ap.add_argument(
        "--draw-partition", action="store_true",
        help="shade each pixel by its nearest point — the partition the "
        "dense NN kernel implicitly queries (the index-structure "
        "visualization analog of the reference's kd-tree split lines, "
        "`slam/kdtree.cpp:201-223`)",
    )
    ap.add_argument("--out", default="nearest_neighbor.png")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA card")
    args = ap.parse_args(argv)

    dev = app_device(args.cpu)

    def put(a):
        return torch.from_numpy(a).to(dev)

    rng = np.random.default_rng(args.seed)
    px = rng.uniform(0, args.size, args.n).astype(np.float32)
    py = rng.uniform(0, args.size, args.n).astype(np.float32)
    qx = rng.uniform(0, args.size, args.queries).astype(np.float32)
    qy = rng.uniform(0, args.size, args.queries).astype(np.float32)
    valid = np.ones(args.n, bool)

    with measure_time(f"NN {args.queries} queries over {args.n} points"):
        idx, dist = spatial.nearest_neighbor(put(px), put(py), put(valid), put(qx), put(qy))
        idx = idx.cpu().numpy()
        dist = dist.cpu().numpy()

    if args.check:
        d2 = (px[None, :] - qx[:, None]) ** 2 + (py[None, :] - qy[:, None]) ** 2
        want = np.argmin(d2, axis=1)
        assert np.array_equal(idx, want), "NN mismatch vs brute force!"
        print("brute-force check OK")

    img = np.full((args.size, args.size, 3), 255, np.uint8)
    if args.draw_partition:
        # Voronoi regions of the point set, computed with the SAME batched
        # NN kernel (pixels are just a big query batch), pastel-shaded by
        # owner index.
        jj, ii = np.meshgrid(np.arange(args.size), np.arange(args.size))
        gx = jj.reshape(-1).astype(np.float32)  # world x == col
        gy = (args.size - 1 - ii).reshape(-1).astype(np.float32)  # y-up
        owner = np.empty(gx.size, np.int32)
        chunk = 65536
        for s in range(0, gx.size, chunk):
            o, _ = spatial.nearest_neighbor(
                put(px), put(py), put(valid), put(gx[s : s + chunk]), put(gy[s : s + chunk]),
            )
            owner[s : s + chunk] = o.cpu().numpy()
        h = (owner.reshape(args.size, args.size).astype(np.uint64)
             * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
        img[..., 0] = 205 + (h >> 8) % 50
        img[..., 1] = 205 + (h >> 16) % 50
        img[..., 2] = 205 + (h >> 24) % 50
    for x, y in zip(px, py):
        render.draw_disc(img, int(args.size - y - 1), int(x), 1, render.BLACK)
    for k in range(args.queries):
        qi, qj = int(args.size - qy[k] - 1), int(qx[k])
        ni, nj = int(args.size - py[idx[k]] - 1), int(px[idx[k]])
        render.draw_disc(img, qi, qj, 3, render.RED)
        render.draw_disc(img, ni, nj, 3, render.GREEN)
        render.draw_line(img, qi, qj, ni, nj, render.BLUE)
        print(f"query ({qx[k]:.0f},{qy[k]:.0f}) -> point {idx[k]} at {dist[k]:.1f}px")
    render.save_png(img, args.out)
    print(f"-> {args.out}")


if __name__ == "__main__":
    main()
