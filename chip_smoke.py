#!/usr/bin/env python3
"""Chip smoke test of slam_tpu_torch on one NVIDIA GPU: the 100k-particle
MCL step through the fused predict -> weigh kernel, the hand-written CUDA
kernels each against its plain version, the 1M-particle full SLAM step,
the planners of `benchmarks/suite.py` (lattice and continuous Hybrid A*,
RRT*, the spatial queries) with the sdf ray backend, and the filter's
features: 1M-particle global localization, the auto measurement tier,
kidnap recovery, scan matching and the per-particle-map RBPF; the maze
through the compressed ray table (CDDT), the multi-robot fleet through one
batched launch of the fused kernel, and the apps; each filter step as one
CUDA graph replay through its entry point against the eager step, with
the JAX package's device branches as CUDA graph conditional nodes, the
RBPF and the sharded engines' steps too; and the counterpart of
`__graft_entry__.py`.

    python3 chip_smoke.py

Phases (each prints its lines before the next starts; a failed check
raises, so the exit code is nonzero):

  1. device   name, torch/CUDA versions, nvidia-smi name and power limit
  2. build    nvcc builds csrc/*.cu for sm_90a, one process a source (timed)
  3. K2       row gather == rows[idx] exactly (f32/bf16/u8, edge indices)
  4. K1       motion sampler: moments, seed reproducibility, ragged N; the
              odometry read from device memory: device fields == host
              fields, and poses == the fused kernel's prologue bit for bit
              for the same seed and device odometry; its branch-free math
              == libdevice's on all 2^24 uniforms; the robot axis: 16 rows
              of 100,003 == one-robot launches and shards at i0 == the
              slices, bit for bit
  5. LUT      360-bin bf16 table of the synthetic floor plan on the card;
              raycast_lut vs raycast_march; K2 on the real table rows; the
              card's bf16 and u8 tables == the CPU's build bit for bit, and
              raycast_lut card == CPU
  6. weights  K1 through predict's wrapper vs the plain sampler by moments,
              and LUT weights through K2's rows == through plain indexing,
              bit for bit, on the bench cloud after 3 warm-up steps and on
              100k poses spread over free space; the fused kernel
              (lut_weights) on those clouds and on 100,003 poses a third
              off the map, bf16 and u8 tables: its poses == K1's for the
              same seed bit for bit, its weights vs the plain composition
              (share within a relative 1e-5, first argmax), timed; and on
              adversarial clouds of 100,003 (the table's last cell and off
              its edge, wrapping segments, u8 rows 8 B off 16 B, the u8
              table's end 8 B off 16 B), with a shard at i0 != 0 == the
              whole launch's slice bit for bit; its weights == PyTorch's
              per-beam terms summed in its order bit for bit; scans of
              180 and 360 beams
  7. main     bench.py's configuration end to end through mcl.step (init,
              3 warm-up steps, 5 blocks of 20 steps, CUDA-event timed,
              under set_sync_debug_mode("error")), with per-phase times
              and the kernel launch counts; in the same call the
              predict -> update path and the earlier route (K1, K2's
              panorama rows, pano_log_weights), each with ms/step, device
              ms/step, launches/step and the busy share
  8. track    40 steps of tracking a moving pose with 100k particles
              through mcl.step
  9. slam       `benchmarks/suite.py slam`'s configuration end to end
              through GridSLAM (one CUDA graph replay a step, a block per
              resample-gate phase) at 1M particles (init, 4 warm-up steps, 5
              blocks of 20 steps, CUDA-event timed, under
              set_sync_debug_mode("error"): a host sync in the step raises),
              with per-phase times, the profile and K1 at N = 1M
 10. edt        edt_capped on the card == on the CPU bit for bit; 20 steps
              with the incremental EDT cache (edt_box=512), each equal to a
              full rebuild bit for bit; the map update on the card vs the
              CPU
 11. slam-track closed-loop SLAM at 1M particles on the floor plan: final
              pose error and the share of mapped walls near true walls
 12. sdf        edt_jfa and edt_exact of the floor plan on the card == on
              the CPU bit for bit; the planners' sphere trace against the
              march on 100k rays from free cells (hit agreement, |ddist| <=
              step + margin); both timed
 13. plan-lattice  the suite's lattice HA* on the floor plan inflated by 7:
              reset, 5 x (reset_query + solve) through the CUDA graphs of
              its search chain and of the query init's A* wavefront (every
              warm-up and replay under set_sync_debug_mode("error")), each
              beside the same query through chains of the same blocks run
              eagerly on the card (capture=False): equal bit for bit (state,
              heuristic, rounds, iterations launched, path; host reads no
              more), also with max_rounds cut inside a block; graph and
              eager ms, query init, capture ms, the pools' memory, replays,
              the profiles (device ms, kernels, host-issued launches); the
              path free and no shorter than the straight line less tol; the
              same search by the port on the CPU equal bit for bit; the
              path walk's kernel (csrc/lattice_chain.cu) == the eager walk
              bit for bit (cells, next index, done, cost; whole and in
              chunks of 4, from the goal, the start and the max_rounds
              cut's deepest states), one launch and one host read a chunk,
              its device ms and the walk's ms beside the eager walk's;
              solve_many of 4 queries, graph == eager, one walk launch a
              query and each path the query's
 14. plan-rrt / plan-continuous / spatial  the suite's RRT* over seeds
              1234-1238 through its chain's CUDA graph, each seed == the
              eager chain on the card (tree, rounds, the generator's state;
              also cut inside a block) (success count; every path edge ends
              in a free cell of the map inflated by 7 and crosses no blocked
              stretch of a ray step along it; the edges the fixed-step march
              flags are printed), continuous HA* with the lut edge field and
              with the sdf backend (graph == eager the same way), and the
              spatial workload at 1M points (card == CPU)

 15. globalloc  `tools/global_loc_bench.py`'s configuration at 1M
              particles through mcl.step, driven by the port's
              `slam_tpu_torch/tools/global_loc_bench.py`: init_uniform on
              the card (moved particles on free cells, the share left at
              the start pose vs the plan's blocked share, headings by
              moments); the fused kernel at step 1 of the uniform cloud vs
              its plain composition, timed beside its bound; 3 seeds x 60
              steps (converged_at_step, post-convergence ATE, CUDA-event
              ms/step, launches, the truth's weight rank on the final scan,
              profiles of a uniform and a converged step); one run with
              1000 particles planted at the truth, which must converge;
              three adaptive steps through the fused route
 16. autotier   GridSLAM(likelihood_field_auto) at slam_config(): the auto
              step == the forced-table step (converged state) and the
              forced-direct step (init_uniform state) bit for bit; 40
              dispatcher steps under the sync check, the cloud dispersed
              after 20: ms/step, host reads of the predicate, the tiers;
              profiles of a table and a direct step; mcl.update's auto
              route (eagerly one host read of the predicate, one tier
              computed; through MCL.update's graph the tier a cond) ==
              the forced tier bit for bit on the converged and the
              dispersed 1M cloud, as the free function and through
              MCL.update's graphs, timed beside the forced tiers
 17. kidnap     tests/test_mcl.py:347-392's kidnap recovery on the card over
              8 seeds, the test's bounds on one
 18. scanmatch  refine_pose card vs CPU (1e-4 px, 1e-5 rad; subcell off pins
              the integer argmax), coarse level off and on; the 1M SLAM
              step with ScanMatchConfig() under the sync check
 19. rbpf       `tools/rbpf_fidelity.py`'s configuration at 1000 particles
              (777 MB of u8 maps), 30 steps through `RBPF.step`'s CUDA
              graph: ATE, ms/step, peak memory, profile, the graph's
              capture ms and pool, one launch of K1 a step and of each
              fidelity kernel a chunk; one N = 8 step card vs CPU (maps bit
              for bit, weights 1e-5, best_map_idx)
 20. maze       `benchmarks/maze_bench.py` through the port's tool: the 2400
              px procedural maze's CDDT built on the card == the CPU's build
              bit for bit (K > 64: binary search), the dense u8 table beside
              it, CDDT vs dense queries on 100k rays (angle ties counted),
              the 10k-particle MCL step and 60-step ATE through both tables,
              the fused kernel on the u8 table's step vs its plain version,
              the card's CDDT queries against the CPU's (count printed);
              the 7000 px beyond-memory demo through the CDDT (K <= 64:
              masked min)
 21. fleet      `benchmarks/fleet_bench.py` through the port's tool: the fused
              kernel with a robot axis == one-robot launches bit for bit (R =
              1, 4), whole fleet steps == independent filters bit for bit (R =
              1, 4, 16), R = 1, 4, 8, 16 x 100k (one lut_weights launch a fleet
              step), the kernel at 16 x 100k vs its plain version (poses == K1's
              per robot, weights within phase 6's tolerance) and beside its
              bound, and on adversarial clouds of 16 x 100,003; on the
              likelihood field (one K1 launch a step with a robot axis) 16
              x 100k == independent filters bit for bit, K1 timed; the
              fleet_localization app
 22. apps       the apps on the floor plan's PNG: grid_slam's quick start, a
              --checkpoint-dir run cut in two == an uninterrupted one,
              slam_replan at 100k particles, the A*, HA*, RRT*, nearest-
              neighbour and regions apps
 23. parallel   slam_tpu_torch/parallel/ on torch.distributed. (a) A world
              of one rank over NCCL in this process: ShardedGridSLAM at 1M
              (phase 9's configuration, shard_bench's) == GridSLAM over 8
              steps and ShardedMCL at 1M through the fused route ==
              mcl.step, bit for bit; systematic_resample_sharded at 1M vs
              the plain resampler with the same u0; each sharded engine
              (ShardedMCL at 1M through the fused route, ShardedGridSLAM and
              MapShardedGridSLAM at 1M, ShardedMCLFleet 16 x 100k) through
              its CUDA graph (the collectives captured as NCCL kernels)
              against the eager free functions, 8 steps, bit for bit and in
              the collectives counted, graph and eager ms, device ms and
              host-issued calls a step; a psum inside a CUDA graph IF body
              (the sharded auto tier's shape), its values and counts.
              (b) Worlds of 2 and 4
              ranks sharing the card over gloo (`python3 chip_smoke.py
              --parallel-rank DIR` is one rank; each world has a wall-clock
              limit and every rank's exit code is checked): the fused
              kernel with i0 == its slice of the whole launch, ShardedMCL
              and ShardedGridSLAM at 1M against the unsharded engines
              (poses and weights bit for bit before resampling, estimates
              within 1e-5, resampled slots within 0.1%, the grids equal on
              every rank, the collectives' elements and the largest
              all-gather), MapShardedGridSLAM on the 2400 px maze (the
              sharded capped EDT and march == the replicated ones bit for
              bit, one step vs GridSLAM), ShardedMCLFleet 16 x 100k ==
              MCLFleet bit for bit, lattice HA* queries spread over the
              ranks; step times labelled as D ranks sharing one card
 24. tools      the port's rbpf_fidelity and maze_slam_bench at their
              defaults: their JSON lines, finite
 25. graphs     each filter step through its entry point's CUDA graph
              (`models/_graph.py`) against the eager free function, at
              full width: the 100k MCL step and 1M global localization
              (`MCL.step`), the 1M SLAM step and the scan-matched one
              (`GridSLAM.step`), the fleet of 16 x 100k (`MCLFleet.step`),
              the 2400 px maze's 10k step through the CDDT and the dense
              u8 table, grid_slam's sdf-beam SLAM step at 1000 particles;
              and the device control flow (CUDA graph IF nodes through
              csrc/graph_cond.cu): the 1M SLAM step with edt_box=512 (the
              refresh's three branches, counted), the maze SLAM tool's
              likelihood_field_table:128:e1024 at 10k on the 2400 px maze,
              the auto-tier MCL.step at 1M on a converged and a dispersed
              cloud, the fleet's auto step at 16 x 100k (one K1 launch a
              step) and the 1M tracking step with ess_threshold 0.5 (what
              each step chose, counted);
              the RBPF at 1000 maps (`RBPF.step`, at most RBPF_HOST_CALLS
              host-issued calls a step):
              20 steps each with a new odometry and scan at each, every
              replay under set_sync_debug_mode("error"), graph == eager
              bit for bit after every step (states, counters, generators)
              and in kernel launches (plus the warm-ups); graph and eager
              ms/step in turns, device ms, kernels and host-issued
              launches a step (each hand-written kernel's runs in the
              profile == its wrapper's count), capture ms, pool memory,
              state copies a step; and a block captured with the garbage
              collector off (an earlier graph freed during a capture
              would lose it), which an earlier block's cyclic garbage
              outlives
 26. entry      `slam_tpu_torch/entry.py` (the counterpart of
              `__graft_entry__.py`): `entry()`'s SLAM step on the card
              through a CUDA graph == eager bit for bit, timed both ways;
              `dryrun_multichip(2)` and `(4)` at once as ranks sharing the
              card (gloo): every rank exits 0 with finite states in every
              layout, the HA* results of the queries over 'p'

 27. padded     the port's public names (`from slam_tpu_torch import Pose`,
              `slam_tpu_torch.ops.lut.pad_lut_rows`); `lut.pad_lut_rows`
              of the floor plan's tables (360 bins in rows of 512 bf16 and
              384 u8): K2 on the padded rows == rows[idx] exactly, the
              panorama rows == the unpadded table's; the fused kernel on
              both padded tables == its launch on the unpadded ones bit
              for bit (poses, weights) on the bench cloud, 100k poses over
              free space, step 1 of the 1M uniform cloud and the
              adversarial clouds with a shard at i0 != 0; both kernels
              timed padded against unpadded in turns beside their bounds
              (K2 beside index_select); MCL.step through its CUDA graph
              with the padded bf16 field == the unpadded field's over 20
              steps (states, generators), and the panorama-row route (K1,
              K2, plain weights) likewise, graphed ms/step both ways in
              turns; MCL.update(state, scan, blocked=<bool grid>) == the
              call with the mask's RayField
 28. resample   the systematic resampler's kernel chain (csrc/resample.cu)
              against the plain path from the same softmax weights and
              draws: 1M dispersed and collapsed clouds (on a random, the
              first and the last particle), 100k, 100,003, 1000 (one
              tile), N = 1, 16 x 100k rows with the gate off on every
              third, 4 x 100k with -inf log weights: indices == the plain
              path's but for draws within RESAMPLE_EDGE of a bin edge (their
              count), poses == the gather of its indices and log weights
              -log(n) bit for bit, gated-off rows copied; device ms at 1M,
              100k and 16 x 100k beside the 32 N bytes bound, the plain
              chain's and the public resample's
 29. estimate   the best and mode poses' kernel chain (csrc/estimate.cu)
              against the plain estimate on the same particles: dispersed
              at 256, 4097, 100k, 1M and 16 x 100k; every score equal;
              equal maxima in different blocks; -inf entries; NaNs;
              exactly half the scores tied; every log weight -inf; mixed
              rows: the best index and pose, the tie share and the
              informative flag bit for bit, the mode within ESTIMATE_RTOL
              and ESTIMATE_RAD; two launches and a graph replay == eager
              bit for bit; one launch counted a call; device ms at 100k,
              1M and 16 x 100k beside the 20 N bytes bound and the plain
              estimate's
 30. rbpf_fidelity  the RBPF's march and map write kernels
              (csrc/rbpf_fidelity.cu) at phase 19's shapes (1000 maps of
              the plan, 90 beams to 500 px, step 0.5): RBPF_FIDELITY_FRAMES
              frames of phase 19's wander from maps at 128, each through
              the kernels == the plain path on the card (log weights and
              maps bit for bit, the first chunk's hits and distances), one
              launch of each kernel a chunk; the last frame with every
              second beam cut to 2 px (cells of a particle written with
              both updates) held the same way, and the first writer's maps
              differing; on the last frame each kernel's device ms over the
              chunks beside its byte bound and the plain path's march and
              write, the whole update both ways, and the mean steps a beam
              marched against K

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Needs one CUDA device; without one it
raises and prints no result. Phase 23 starts its worlds itself, on that
one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_PARTICLES = 100_000
# Phase 6: the fused kernel's weights against the plain composition. The
# beam sum runs in another order (<= 90 terms of one sign: a relative
# 5.4e-6 at most), and a bin or cell on a rounding tie can flip, which
# changes a particle's weight whole.
LW_RTOL = 1e-5
LW_SHARE = 0.999
RAGGED_N = 100_003
# Phase 4: K1's robot axis, K1_ROBOTS rows of RAGGED_N, and its shards.
K1_ROBOTS = 16
K1_SHARD_I0 = 33_334
K1_SHARD_I0_1M = 333_334
# The fused kernel's adversarial clouds (`adversarial_poses`): where their
# sensors land.
ADVERSARIAL_KINDS = ("last_cell", "off_bottom_right", "wrapped", "odd_row", "random")
# Least-time bounds (H100 SXM datasheet: 3.35 TB/s HBM,
# 67 TFLOP/s FP32 outside the tensor cores, at 700 W). Operations per
# particle and per beam are counted from the kernels' arithmetic, integer
# and float alike, at the FP32 rate: K1's sampler (Philox4x32-10's 10
# rounds of 2 wide and 2 low multiplies, 4 xors and 2 key adds; Box-Muller;
# the integration and wrap) ~130; locating the sensor cell and bin ~20; one
# beam (bin index, decode, hit test, error, the clamped pdf's 3 multiplies,
# exp, log, the sum) ~12; a ray step's cell in the RBPF's march and write
# (two products, two sums, two differences, two floors) 8.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_SAMPLE = 130
OPS_LOCATE = 20
OPS_BEAM = 12
OPS_RAY_STEP = 8
# Tracking bound (phase 8), px: the final best pose must be this close.
# Over 16 H100 runs (12 filter seeds, seed 1 five times) the error ranged
# 0.31-1.33 px: the step is not bitwise run-to-run deterministic (CUDA's
# float cumsum in the resampler is not), so one seed's error varies too.
TRACK_BOUND_PX = 2.5
SLAM_PARTICLES = 1_000_000
SLAM_TRACK_STEPS = 50
# Closed-loop SLAM bounds (phase 11). Over 50 H100 runs (seeds 0-21, seed
# 1 in 28 of them) the final est_pose error ranged 1.97-3.44 px (seed 1
# over 25 runs in one process: mean 2.88, sd 0.29; the step is not bitwise
# reproducible) and the share of mapped blocked cells within 2 px of a
# true wall 0.888-1.0.
SLAM_TRACK_BOUND_PX = 4.5
SLAM_WALL_SHARE = 0.8
# Planner phases (12-14): the suite's configurations on the synthetic
# floor plan inflated by 7 (`benchmarks/suite.py:155`). The suite's goal,
# image cell (450, 750), lies inside the plan's horizontal wall at rows
# 450-453, so no robot reaches it; the checks keep the suite's start and
# use the nearest reachable goal, (440, 750).
PLAN_INFLATE = 7
PLAN_START_IJ = (150, 450)
PLAN_GOAL_IJ = (440, 750)
SDF_RAYS = 100_000
# The sphere trace against the march on phase 12's 100k rays (seeded, so
# the same in every run): hits agreed on 0.99995 and |ddist| <= step +
# margin held on 0.99955 of the rays in every H100 run.
SDF_HIT_AGREE = 0.999
SDF_CLOSE = 0.998
RRT_SEEDS = tuple(range(1234, 1239))
RRT_ROUNDS = 400
# Seeds 1234-1237 reach the goal and 1238 spends its 8192 nodes first, in
# every H100 run; the search is deterministic for a seed.
RRT_MIN_SUCCESS = 4
# Points per RRT* path edge for the blocked-stretch check (<= 0.013 px
# apart on the 50 px edges the rewire radius allows).
EDGE_SAMPLES = 4096
LATTICE_QUERIES = 5
LATTICE_MANY = 4
# Host-side runtime events that issue work to the card: one a kernel, one a
# graph replay, one a copy or fill.
HOST_LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                      "cudaMemsetAsync")
# `traced_kernels`' spin kernels each side of the profiled calls: their
# count, their lengths in cycles, and the length in us that tells them
# apart (~1 us against ~50 us on an H100).
PAD_SPINS = 64
LEAD_SPIN_CYCLES = 2_000
TRAIL_SPIN_CYCLES = 100_000
SPIN_SPLIT_US = 20.0
# The hand-written kernels by wrapper count, as the profiler names them.
# The resampler's chain counts one launch a call: its select kernel (the
# multi-block one, or the one-tile form), whose names share this part; the
# estimate's chain likewise its pose kernel.
KERNEL_NAMES = {"gather_rows": "gather_rows_kernel", "motion_odometry": "motion_odometry_kernel",
                "lut_weights": "lut_weights_kernel", "resample": "resample_select",
                "estimate": "estimate_pose", "rbpf_march": "rbpf_march_kernel",
                "rbpf_write": "rbpf_write_kernel"}
SPATIAL_POINTS = 1_000_000
SPATIAL_BOXES = 1000
SPATIAL_QUERIES = 1024
# Phase 15: `tools/global_loc_bench.py:63-110` at 1M particles (3 seeds x
# 60 steps, timed in 5 blocks of 12), through the port's counterpart of
# that tool (`slam_tpu_torch/tools/global_loc_bench.py`). A uniform cloud
# converges on the truth only where some particle starts near it (the
# tool's 10-seed sweep in PERF.md), so the guards are ones a wrong
# weighting or resampling fails: on every seed's final scan the truth
# outweighs GL_TRUTH_RANK of the uniform cloud; with GL_PLANT particles
# planted next to the truth's start pose the filter converges on the truth
# by step GL_PLANT_BY; a seed that converges keeps its post-convergence
# ATE below GL_ATE_PX. In the first H100 run of these guards (NVIDIA H100
# 80GB HBM3, 700 W) the truth's rank was 1.0 on all 3 seeds and the
# planted cloud converged at step 1 with ATE 0.57 px; in the same call the
# tool's sweep over seeds 0-9 converged on 3 (ATE 0.38-1.21 px).
GL_PARTICLES = 1_000_000
GL_STEPS = 60
GL_SEEDS = (0, 1, 2)
GL_BLOCKS = 5
GL_TRUTH_RANK = 0.999
GL_PLANT = 1000
GL_PLANT_BY = 5
GL_ATE_PX = 5.0
# Phase 16: the auto tier at slam_config(), the cloud dispersed before
# step 21 (no resample until step 24, so the lagged table steps cannot
# collapse it before the predicate sees it).
AUTO_STEPS = 40
AUTO_DISPERSE_AT = 21
# Phase 17: kidnap recovery (tests/test_mcl.py:347-392) on the card. In
# every H100 run of this phase seeds 0-7 gave the same errors, and seed 1 alone
# met the test's bounds (1.61 px min, 1.85 px mean of the last 10);
# the others tracked before the kidnap (< 0.3 px) and did not re-localize
# within 40 steps (on the CPU the loop recovers on 8 of 40 seeds in the
# port and 13 of 40 in the JAX package: `python tests/torch_port.py kidnap
# 0 40`).
KIDNAP_SEEDS = tuple(range(8))
KIDNAP_SEED = 1
# Phase 18: refine_pose card vs CPU, and the scan-matched 1M SLAM step.
SM_PX = 1e-4
SM_RAD = 1e-5
SM_BLOCKS = 3
SM_ITERS = 10
# Phase 19: `tools/rbpf_fidelity.py:50-80` at full width, 30 steps. ATE
# 1.914-1.969 px in the H100 runs of this phase; the bound leaves room.
RBPF_PARTICLES = 1000
RBPF_STEPS = 30
RBPF_ATE_PX = 5.0
# Phase 25: host-issued calls a graphed RBPF step may make (the replay, the
# odometry's copy, the graph-safe RNG's fills, the state's copies out).
RBPF_HOST_CALLS = 10
# Phase 30: frames of phase 19's wander through the RBPF's march and write
# kernels against the plain path (the walls the first frames write give
# the later ones hits), the particles spread around the truth by
# RBPF_FIDELITY_SPREAD px.
RBPF_FIDELITY_FRAMES = 4
RBPF_FIDELITY_SPREAD = 1.5
# Phase 30's last-lane frame: every second beam of the last frame's scan
# cut to RBPF_POST_PX, and the first writer's maps formed on the CPU for
# RBPF_POST_FEW of the particles.
RBPF_POST_PX = 2.0
RBPF_POST_FEW = 8
# Phase 20: `benchmarks/maze_bench.py` through the port's tool on its
# procedural maze (MAZE_SIZE px, walls every MAZE_PITCH) and its
# beyond-memory demo (BIG_SIZE, BIG_PITCH), 10k particles, 60 ATE steps.
# CDDT_AGREE is the JAX package's own bound for CDDT against the dense
# table (`tests/test_rayfield.py:175`); MAZE_ATE_PX the JAX tool's
# expected tracking error (<= 1 px).
MAZE_SIZE = 2400
MAZE_PITCH = 40
BIG_SIZE = 7000
BIG_PITCH = 400
MAZE_PARTICLES = 10_000
MAZE_STEPS = 60
MAZE_RAYS = 100_000
CDDT_AGREE = 0.995
MAZE_ATE_PX = 1.0
# Phase 21: `benchmarks/fleet_bench.py` through the port's tool. Fleets of
# 4 and FLEET_CHECK_R robots equal as many independent filters bit for bit
# over three whole steps. FLEET_APP_ATE_PX is the JAX app test's bound
# (`tests/test_apps.py:170`).
FLEET_N = 100_000
FLEET_ROBOTS = (1, 4, 8, 16)
FLEET_CHECK_R = 16
FLEET_ITERS = 10
FLEET_SEED = 7
FLEET_APP_ATE_PX = 10.0
# Phase 25: each filter step's CUDA graph against the eager step: steps
# compared bit for bit per case (a new odometry and scan at each), steps a
# timed turn (two turns a way) and steps profiled a way.
GRAPH_STEPS = 20
# Phase 25's IF nodes a case (two a `cond`): the `edt_box` refreshes and
# the auto tiers. The ESS gate adds none on the card: the resampler's
# kernel chain reads it (the single filters' cases held two more for it
# before).
GRAPH_IF_NODES = {"slam_edt512_1m": 16, "maze_slam_e1024_10k": 4,
                  "auto_step_1m_converged": 8, "auto_step_1m_dispersed": 8,
                  "fleet_auto_16x100k": 4}
# The `edt_box` case's first steps, standing still on one scan; the rest
# alternate scans.
EDT_STILL = 6
GRAPH_ITERS = 20
GRAPH_PROFILE = 5
# Phase 26: `entry()`'s steps compared graph against eager; the dryrun
# worlds (ranks sharing the card) and their wall clock each.
ENTRY_STEPS = 4
ENTRY_WORLDS = (2, 4)
ENTRY_DRYRUN_LIMIT_S = 300.0
# Phase 27: both kernels on row-padded tables (`ops/lut.py:pad_lut_rows`:
# the floor plan's 360-bin rows stored 512 bf16 or 384 u8 wide). Device ms
# in turns (A, B, B, A) over PAD_ROUNDS rounds, a launch's from a graph of
# `tools/_ab.py`'s ITERS; PAD_STEPS graphed MCL steps and PAD_K2_STEPS steps
# of the panorama-row route compared padded against unpadded; MCL.update
# with a raw mask at PAD_MARCH_N particles (the march backend).
PAD_ROUNDS = 4
PAD_STEPS = 20
PAD_K2_STEPS = 5
PAD_MARCH_N = 2000
# Phase 28: the resampler's kernel chain against the plain path. A slot
# may take another particle than the plain path's only where the plain
# path's draw lies within RESAMPLE_EDGE of a bin edge (the two sum the f64
# prefix in other orders); timed at RESAMPLE_TIMED.
RESAMPLE_SEED = 2024
RESAMPLE_EDGE = 1e-9
RESAMPLE_TIMED = ("dispersed_1m", "dispersed_100k", "rows_16x100k")
# Phase 29: the estimate's kernel chain against the plain estimate. The
# best index and pose, the tie share and the informative decision bit for
# bit; the mode pose, whose sums run in another order, within ESTIMATE_RTOL
# (x, y, relative) and ESTIMATE_RAD (theta); timed at ESTIMATE_TIMED.
ESTIMATE_SEED = 2121
ESTIMATE_RTOL = 1e-5
ESTIMATE_RAD = 1e-6
ESTIMATE_TIMED = ("dispersed_100k", "dispersed_1m", "rows_16x100k")
# Phase 22: the apps. GRID_SLAM_ATE_PX is the JAX app test's bound
# (`tests/test_apps.py:27`); the checkpoint runs take CKPT_STEPS steps.
GRID_SLAM_ATE_PX = 30.0
CKPT_STEPS = 40


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def moment_gap(start, a, b, label: str) -> float:
    """Largest gap between the means and the stds of the displacements
    a - start and b - start (x, y, and theta wrapped) of two motion samples
    from the same start poses. Two independent samples of one distribution
    differ by less than 5 sigma of the gap, 5 * std * sqrt(2 / n)."""
    n = start.x.numel()
    gap = 0.0
    for field in ("x", "y", "theta"):
        s = getattr(start, field).double()
        da = getattr(a, field).double() - s
        db = getattr(b, field).double() - s
        if field == "theta":
            da = torch.remainder(da + math.pi, 2 * math.pi) - math.pi
            db = torch.remainder(db + math.pi, 2 * math.pi) - math.pi
        d = max(abs(da.mean() - db.mean()).item(), abs(da.std() - db.std()).item())
        tol = 5.0 * db.std().item() * math.sqrt(2.0 / n)
        check(d < tol, f"K1 vs plain {field} moments differ by {d} (tolerance {tol}; {label})")
        gap = max(gap, d)
    return gap


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of `fn`, by CUDA events around `iters` back-to-back
    calls after `warmup` calls. Where the host enqueues a call more slowly
    than the card runs it, this is the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def traced_kernels(fn, host: bool = False):
    """The CUDA kernels (torch.profiler events) that `fn` ran, and with
    `host` also the launches and copies the host issued in it
    (`HOST_LAUNCH_EVENTS`, by name; the spins' own launches taken off): a
    (kernels, issued) pair then. A trace can lose kernels at the edges of
    its session (a 20-launch session of K1 at 1M read 0.0039 ms, under its
    bytes bound; the whole script's phase 25 sessions lost ~20 kernels; a
    session can come back with none), so the session runs PAD_SPINS short
    `torch.cuda._sleep` kernels before `fn` and PAD_SPINS long ones after,
    and only the kernels between the last short spin and the first long
    one in the trace count. A session whose trace kept no spin of either
    group is repeated, up to four sessions."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(PAD_SPINS):
                torch.cuda._sleep(LEAD_SPIN_CYCLES)
            fn()
            for _ in range(PAD_SPINS):
                torch.cuda._sleep(TRAIL_SPIN_CYCLES)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time > 0]
        spins = [e for e in kernels if "spin_kernel" in e.name]
        lead = [e.time_range.start for e in spins if e.device_time < SPIN_SPLIT_US]
        trail = [e.time_range.start for e in spins if e.device_time >= SPIN_SPLIT_US]
        if lead and trail:
            break
    check(lead and trail, "the profiler's trace kept no spin kernel before or after the calls")
    lo, hi = max(lead), min(trail)
    inside = [e for e in kernels if lo < e.time_range.start < hi and "spin_kernel" not in e.name]
    if not host:
        return inside
    issued = dict.fromkeys(HOST_LAUNCH_EVENTS, 0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA and e.name in issued:
            issued[e.name] += 1
    issued["cudaLaunchKernel"] -= 2 * PAD_SPINS
    return inside, issued


def profiled(fn, iters: int = 20, warmup: int = 3):
    """({kernel name: [device ms per call, launches per call]}, ms per
    call) of `fn` over `iters` calls after `warmup` calls: the kernels from
    torch.profiler (`traced_kernels`), the ms from CUDA events around the
    same calls (the profiler's host cost included)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def calls():
        start.record()
        for _ in range(iters):
            fn()
        stop.record()

    by_name = {}
    for e in traced_kernels(calls):
        row = by_name.setdefault(e.name, [0.0, 0.0])
        row[0] += e.device_time / 1e3 / iters
        row[1] += 1 / iters
    check(by_name, "the profiler saw no CUDA kernels")
    return by_name, start.elapsed_time(stop) / iters


def kernel_profile(fn, iters: int = 20, warmup: int = 3):
    """The kernels of `profiled`."""
    return profiled(fn, iters, warmup)[0]


def own_kernel_ms(fn, name: str, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of the kernels of `fn` whose name holds `name`
    (a wrapper's own kernel, without the copies or stacks that prepare
    its inputs)."""
    rows = kernel_profile(fn, iters, warmup)
    found = [r[0] for k, r in rows.items() if name in k]
    check(found, f"no kernel named {name} in the profile")
    return sum(found)


def step_profile(fn, iters: int, warmup: int = 0) -> dict:
    """Device ms, launches and the 8 largest kernels per call of `fn`,
    and the busy share: the device ms over the CUDA-event ms of the same
    profiled calls."""
    rows, ms = profiled(fn, iters, warmup)
    dev_ms = sum(r[0] for r in rows.values())
    return {"device_ms_per_step": dev_ms, "launches_per_step": sum(r[1] for r in rows.values()),
            "profiled_ms_per_step": ms, "device_busy_share": dev_ms / ms,
            "top": top_kernels(rows)}


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """(device ms, kernel launches) per call of `fn`: the summed time of
    the CUDA kernels `iters` calls ran, from torch.profiler, so host-side
    overhead between launches is left out."""
    rows = kernel_profile(fn, iters, warmup).values()
    return sum(r[0] for r in rows), sum(r[1] for r in rows)


def slam_config(shape=None, edt_box=None):
    """`benchmarks/suite.py slam`'s production configuration (`suite.py:
    82-99`): 1M particles, 90 beams over pi, max_dist 500, sigma 5, the
    boxed correlative table (box 128, 32 f32 bins), resample_every=4,
    map_pose="mode", on MapConfig()'s 1000x1000 grid unless `shape`."""
    from slam_tpu_torch.core.config import (
        LidarConfig, MapConfig, MCLConfig, MotionConfig, RaycastConfig, SLAMConfig,
    )

    return SLAMConfig(
        mcl=MCLConfig(n_particles=SLAM_PARTICLES, meas_stddev=5.0,
                      measurement="likelihood_field_table", lf_table_box=128,
                      resample_every=4),
        map=MapConfig() if shape is None else MapConfig(height=shape[0], width=shape[1]),
        lidar=LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90),
        motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
        raycast=RaycastConfig(step=0.5, max_dist=500.0, backend="sdf"),
        map_pose="mode",
        edt_box=edt_box,
    )


def slam_track(dev, blocked, seed: int):
    """Closed-loop SLAM at 1M particles on the floor plan `blocked` (a
    bool tensor on `dev`), in its own frame: from (640, 190, 0) along the
    free arc of odometry (0.01, 2.0, 0.01) for SLAM_TRACK_STEPS steps, scans
    from the truth. Returns (final est_pose error px, share of mapped
    blocked cells within 2 px of a true wall, mapped blocked cells)."""
    from slam_tpu_torch.core import grid as gridlib
    from slam_tpu_torch.core.types import Odometry, Pose
    from slam_tpu_torch.models import fake_lidar
    from slam_tpu_torch.models import slam as slam_mod
    from slam_tpu_torch.ops import edt as edtlib
    from slam_tpu_torch.ops.measurement import sensor_pose

    cfg = slam_config(shape=tuple(blocked.shape))
    truth = [640.0, 190.0, 0.0]
    engine = slam_mod.GridSLAM(cfg, seed=seed, device=dev)
    state = engine.init(Pose.create(*truth, device=dev))
    cmd = (0.01, 2.0, 0.01)
    odom = Odometry.create(*cmd)
    for _ in range(SLAM_TRACK_STEPS):
        r1, t, r2 = cmd
        truth = [truth[0] + t * math.cos(truth[2] + r1),
                 truth[1] + t * math.sin(truth[2] + r1), truth[2] + r1 + r2]
        sensor = sensor_pose(Pose.create(*truth, device=dev), cfg.mcl.scanner_offset)
        state = engine.step(state, odom, fake_lidar.scan(blocked, sensor, cfg.lidar,
                                                         cfg.raycast))
    est = state.est_pose
    for v in (est.x, est.y, est.theta, state.grid, state.mcl.particles.log_weight):
        check(bool(torch.isfinite(v).all()), "slam-track produced non-finite values")
    err = math.hypot(float(est.x) - truth[0], float(est.y) - truth[1])
    mapped = gridlib.blocked_from_logodds(state.grid)
    near = edtlib.edt_capped(blocked, 3.0)[mapped] <= 2.0
    return err, float(near.float().mean()), int(mapped.sum())


def bound(n_bytes: float, n_ops: float):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the card's memory rate and the operations over its FP32 rate."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def event_ms(fn) -> float:
    """ms of one call of `fn` between two CUDA events (host pace included)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def spread(values) -> dict:
    return {"median": statistics.median(values), "min": min(values), "max": max(values),
            "repeats": len(values)}


def ij_to_world(h: int, i: int, j: int):
    """`benchmarks/suite.py:141`'s image cell -> world (x, y)."""
    return float(j), float(h - i)


def plan_config():
    """The suite's lattice HA* (`suite.py:158-191`, lattice defaults)."""
    from slam_tpu_torch.core.config import HybridAStarConfig

    vel, steer = 10.0, 40 * math.pi / 180
    return HybridAStarConfig(
        velocity=vel, max_steering=steer,
        length=vel * math.tan(steer) / (10 * math.pi / 180),
        theta_res=36, branching_factor=3, tol=5.0, batch=512, mode="lattice",
        lattice_reps=1, heuristic_weight=1.3,
    )


def planner_profile(fn) -> dict:
    """Of one call of `fn`, from torch.profiler (`traced_kernels`): the
    device ms and the kernels the card ran (graph replays' kernels
    included), the 8 largest, the runs of each hand-written kernel
    (`KERNEL_NAMES`), and what the host issued (`HOST_LAUNCH_EVENTS`, by
    name and in all)."""
    kernels, host = traced_kernels(fn, host=True)
    rows = {}
    for e in kernels:
        row = rows.setdefault(e.name, [0.0, 0.0])
        row[0] += e.device_time / 1e3
        row[1] += 1
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:8]
    return {"device_ms_per_solve": sum(r[0] for r in rows.values()),
            "hand_written_kernels_ran": {
                w: int(sum(r[1] for k, r in rows.items() if kname in k))
                for w, kname in KERNEL_NAMES.items()},
            "launches_per_solve": sum(r[1] for r in rows.values()),
            "host_issued_per_solve": sum(host.values()), "host_issued": host,
            "top": [[k[:90], round(v[0], 4), round(v[1], 1)] for k, v in top]}


@contextlib.contextmanager
def sync_error():
    """A host sync raises inside (torch's sync debug mode)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def graph_stats(cache, before=None) -> dict:
    """Per block of a planner's graph cache: capture ms, the device memory
    its graph's pool took, and replays (since `before`, an earlier result
    of this function)."""
    out = {}
    for key, blk in cache.blocks.items():
        name = key[0] if key[0] != "lattice" or key[3] == () else f"lattice_q{key[3][0]}"
        out[name] = {"capture_ms": blk.capture_ms, "pool_bytes": blk.pool_bytes,
                     "replays": blk.replays - ((before or {}).get(name, {}).get("replays", 0))}
    return out


def snapshot(p, fields) -> dict:
    """What a planner's last solve left: its state's fields (copies) and
    its counters."""
    return {"state": {f: getattr(p.state, f).clone() for f in fields}, "rounds": p.rounds,
            "launched": p.launched, "host_reads": p.host_reads}


def hold_solves(graph, eager, fields, what: str) -> None:
    """A graph solve == the same query through eager chains on the card
    (`eager_chains`): every state field, rounds and iterations launched;
    host reads no more than the eager chains'."""
    for f in fields:
        check(torch.equal(graph["state"][f], eager["state"][f]),
              f"{what}: {f} of the graph solve != the eager chain's on the card")
    check(graph["rounds"] == eager["rounds"],
          f"{what}: rounds {graph['rounds']} (graph) != {eager['rounds']} (eager)")
    check(graph["host_reads"] <= eager["host_reads"],
          f"{what}: host reads {graph['host_reads']} (graph), {eager['host_reads']} (eager)")
    check(graph["launched"] == eager["launched"],
          f"{what}: launched {graph['launched']} (graph) != {eager['launched']} (eager)")


def eager_chains(p):
    """A context in which planner `p`'s searches run through a cache of its
    own whose chains run their blocks eagerly on the card (`capture`
    False): the same block code as the captured chains, the reference
    they are held to."""
    from slam_tpu_torch.planners import _graph as planner_graph

    class Eager(planner_graph.Cache):
        def get(self, key, make):
            block = super().get(key, make)
            block.capture = False
            return block

    cache = Eager()

    @contextlib.contextmanager
    def through():
        saved, p._graphs = p._graphs, cache
        try:
            yield
        finally:
            p._graphs = saved

    return through


def plan_poses(h: int):
    """World (x, y) of the planner start and goal on a map of height h."""
    return ij_to_world(h, *PLAN_START_IJ), ij_to_world(h, *PLAN_GOAL_IJ)


def sdf_phase(dev, blocked_np) -> dict:
    """Phase 12: the sdf backend. edt_jfa / edt_exact on `dev` == the CPU
    bit for bit; the sphere trace of the planners' ray config against the
    fixed-step march on SDF_RAYS rays from free cells."""
    from slam_tpu_torch.core.config import RaycastConfig
    from slam_tpu_torch.ops import edt as edtlib
    from slam_tpu_torch.ops import rayfield
    from slam_tpu_torch.ops.raycast import raycast_march

    blocked = torch.from_numpy(blocked_np).to(dev)
    h, w = blocked_np.shape
    out = {}
    for name in ("edt_jfa", "edt_exact"):
        fn = getattr(edtlib, name)
        card = fn(blocked)
        cpu = fn(torch.from_numpy(blocked_np))
        check(torch.equal(card.cpu().view(torch.int32), cpu.view(torch.int32)),
              f"{name} on {dev} != on the CPU")
        out[f"{name}_ms"] = statistics.median(event_ms(lambda: fn(blocked)) for _ in range(5))
    rc = RaycastConfig(backend="sdf", step=1.0, max_dist=500.0)
    field = rayfield.make_ray_field(blocked, rc)
    rng = np.random.default_rng(12)
    free = np.argwhere(~blocked_np)
    pick = free[rng.integers(0, len(free), SDF_RAYS)]
    x = torch.tensor(pick[:, 1] + rng.uniform(0, 1, SDF_RAYS), dtype=torch.float32, device=dev)
    y = torch.tensor(h - pick[:, 0] - rng.uniform(0, 1, SDF_RAYS), dtype=torch.float32,
                     device=dev)
    th = torch.tensor(rng.uniform(-math.pi, math.pi, SDF_RAYS), dtype=torch.float32, device=dev)
    ds, hs = rayfield.raycast_field(field, x, y, th, rc)
    dm, hm = raycast_march(blocked, x, y, th, step=rc.step, max_dist=rc.max_dist)
    agree = float((hs == hm).float().mean())
    close = float(((ds - dm).abs() <= rc.step + rc.sdf_margin).float().mean())
    check(agree >= SDF_HIT_AGREE, f"sdf vs march hit agreement {agree} < {SDF_HIT_AGREE}")
    check(close >= SDF_CLOSE, f"sdf vs march |ddist| <= step + margin on {close} < {SDF_CLOSE}")
    out.update(rays=SDF_RAYS, hit_agreement=agree, close_share=close,
               hit_share=float(hs.float().mean()),
               sdf_ms=statistics.median(event_ms(lambda: rayfield.raycast_field(
                   field, x, y, th, rc)) for _ in range(5)),
               march_ms=statistics.median(event_ms(lambda: raycast_march(
                   blocked, x, y, th, step=rc.step, max_dist=rc.max_dist)) for _ in range(5)))
    return out


def hold_chain_walks(p, gp, firsts, what: str) -> int:
    """The path walk's kernel (`ops/lattice_chain_cuda.py`) against the
    eager walk (`_lattice_chain_device`, `_lattice_chain_cost`) on the
    card, over the packed words `gp` from each state of `firsts` (ints,
    each on a chain that ends at the start: the eager walk cannot leave
    one), whole and in chunks of 4: each chunk's cells with their -1 tail,
    next index, `done` and quantized cost bit for bit, the kernel going on
    from its own next index on the device. Returns the chunks held."""
    from slam_tpu_torch.ops import lattice_chain_cuda
    from slam_tpu_torch.planners import hastar as hastar_mod

    k = p.cfg.theta_res
    inv, cost_t = p._lat_inv_off_dev, p._lat_edge_cost
    start = p.state.start_idx
    head = lattice_chain_cuda.HEADER
    held = 0
    for first in firsts:
        for max_len in (4, 1 << 15):
            idx_k = torch.full((1,), first, dtype=torch.int64, device=gp.device)
            idx_e, done = first, False
            while not done:
                out = lattice_chain_cuda.launch(gp, inv, cost_t, idx_k, start, max_len)
                cells, nxt, done_t, _ = hastar_mod._lattice_chain_device(
                    gp, inv, idx_e, start, k, max_len)
                cost = hastar_mod._lattice_chain_cost(gp, inv, cost_t, cells, k)
                want = [int((cells >= 0).sum()), int(cost), int(done_t), int(nxt)]
                check(torch.equal(out[head:], cells) and out[:head].tolist() == want,
                      f"{what}: the walk's kernel from {first} (chunk {max_len}) gave "
                      f"{out[:head].tolist()}, the eager walk {want}, or other cells")
                idx_k, idx_e, done = out[3:4], nxt, bool(done_t)
                held += 1
    return held


def lattice_walk_phase(p, path, cut_gp) -> dict:
    """Phase 13's path walk on the card: the kernel against the eager walk
    (`hold_chain_walks`) from the query's goal and start, and from the
    three deepest set states of the max_rounds cut's words `cut_gp`; from
    -1 and from an unset state it stops at once. `recover_path` makes one
    launch and one host read a chunk, whole and with `_chain_chunk` 4, and
    gives the same path and cost; the kernel's device ms; the query's walk
    beside the eager walk's (with its read of the two ends)."""
    from slam_tpu_torch.ops import lattice_chain_cuda
    from slam_tpu_torch.planners import hastar as hastar_mod

    st = p.state
    goal, start = torch.stack([st.goal_idx, st.start_idx]).tolist()
    held = hold_chain_walks(p, st.gp, (goal, start), "lattice HA* walk")
    unset = int(hastar_mod._INF_PACKED)
    deep = torch.where(cut_gp == unset, -1, cut_gp).topk(3).indices.tolist()
    held += hold_chain_walks(p, cut_gp, deep, "lattice HA* walk (max_rounds cut)")
    inv, cost_t = p._lat_inv_off_dev, p._lat_edge_cost
    none = int(torch.nonzero(st.gp == unset)[0])
    for first in (-1, none):
        out = lattice_chain_cuda.launch(st.gp, inv, cost_t, torch.full(
            (1,), first, dtype=torch.int32, device=st.gp.device), st.start_idx, 4)
        check(out.tolist() == [0, 0, 1, first, -1, -1, -1, -1],
              f"lattice HA* walk from {first}: {out.tolist()}")
    cost = p.path_cost()
    counts = {}
    for chunk in (1 << 15, 4):
        p._chain_chunk = chunk
        before = lattice_chain_cuda.launch.launches
        got = p.recover_path()
        chunks = len(path) // chunk + 1
        counts[chunk] = lattice_chain_cuda.launch.launches - before
        check(got == path and p.path_cost() == cost,
              f"lattice HA* walk with chunk {chunk}: another path or cost")
        check(counts[chunk] == p.path_launches == p.path_reads == chunks,
              f"lattice HA* walk with chunk {chunk}: {counts[chunk]} launches, "
              f"{p.path_launches} counted, {p.path_reads} reads, {chunks} chunks")
    del p._chain_chunk
    reps = 20
    ends = (st.goal_idx, st.start_idx)
    kernel_ms = event_ms(lambda: [lattice_chain_cuda.launch(st.gp, inv, cost_t, *ends, 1 << 15)
                                  for _ in range(reps)]) / reps
    k = p.cfg.theta_res

    def eager_walk():
        idx, first = torch.stack(list(ends)).tolist()
        cells, _, done, _ = hastar_mod._lattice_chain_device(st.gp, inv, idx, first, k, 1 << 15)
        cost_q = hastar_mod._lattice_chain_cost(st.gp, inv, cost_t, cells, k)
        torch.cat([cells, cost_q.reshape(1)]).cpu()
        bool(done)

    walk_ms = [event_ms(p.recover_path) for _ in range(5)]
    eager_ms = [event_ms(eager_walk) for _ in range(5)]
    return {"chunks_held": held, "cut_firsts": deep, "launches": counts,
            "kernel_ms": kernel_ms, "path_walk_ms": spread(walk_ms),
            "eager_walk_ms": spread(eager_ms), "kernel_equals_eager": True}


def lattice_phase(dev, free_np) -> dict:
    """Phase 13: the suite's lattice HA* on `free_np`: one reset (the
    tables), then LATTICE_QUERIES x (reset_query + solve) through the CUDA
    graphs (the query init's A* wavefront and the search chain, every
    warm-up and replay under `sync_error`), each beside the same query
    through eager chains on the card (`eager_chains`). The graph solve
    equals the eager one bit for bit (every state field, the heuristic
    field the wavefront made, rounds, iterations launched, the path; host
    reads no more), also with max_rounds cut inside a block; the path is
    checked on the map; the path walk's kernel equals the eager walk
    (`lattice_walk_phase`); the same search by the port on the CPU equals
    the card's bit for bit, and so do `solve_many`'s paths."""
    from slam_tpu_torch.core.types import Pose
    from slam_tpu_torch.ops import lattice_chain_cuda
    from slam_tpu_torch.planners import HybridAStar
    from slam_tpu_torch.planners import hastar as hastar_mod

    fields = hastar_mod._LAT_FIELDS
    h, w = free_np.shape
    cfg = plan_config()
    (ax, ay), (bx, by) = plan_poses(h)
    a, b = Pose.create(ax, ay, 0.0), Pose.create(bx, by, 0.0)
    free = torch.from_numpy(free_np).to(dev)
    p = None

    def reset():
        nonlocal p
        p = HybridAStar(free, a, b, cfg)
        p._graphs.guard = sync_error

    reset_ms = [event_ms(reset) for _ in range(2)]
    check(p.solve(), "lattice HA*: no path to the goal")  # captures the chains
    captured = graph_stats(p._graphs)
    eagerly = eager_chains(p)

    def query(max_rounds=None):
        p.reset_query(a, b)
        p.solve(max_rounds)

    def eager(max_rounds=None):
        with eagerly():
            query(max_rounds)

    def init():
        p.reset_query(a, b)
        p._ensure_query_state()

    def init_eager():
        with eagerly():
            init()

    def take():
        return {**snapshot(p, fields), "hfield": p._hfield.clone(), "path": p.recover_path()}

    eager()  # makes the eager chains' buffers
    init_ms = event_ms(init)
    init_eager_ms = event_ms(init_eager)
    solve_ms, eager_ms = [], []
    for _ in range(LATTICE_QUERIES):
        eager_ms.append(event_ms(eager))
        e = take()
        before = graph_stats(p._graphs)
        solve_ms.append(event_ms(query))
        g = take()
        hold_solves(g, e, fields, "lattice HA*")
        check(torch.equal(g["hfield"], e["hfield"]),
              "lattice HA*: the A* wavefront's heuristic (graph) != the eager chain's")
        check(g["path"] == e["path"], "lattice HA* path: graph != eager")
    replays = graph_stats(p._graphs, before)
    # max_rounds inside a block: n_iters = ceil(cut / 2) is not a multiple
    # of the block's iterations.
    cut = 8 * (g["rounds"] // 16) + 5
    eager(cut)
    e_cut = take()
    query(cut)
    g_cut = take()
    hold_solves(g_cut, e_cut, fields, f"lattice HA* max_rounds {cut}")
    query()
    path = []
    before = lattice_chain_cuda.launch.launches
    walk_ms = event_ms(lambda: path.extend(p.recover_path()))
    check(lattice_chain_cuda.launch.launches - before == p.path_launches == p.path_reads == 1,
          f"lattice HA* walk: {p.path_launches} launches, {p.path_reads} host reads")
    check(p.success and len(path) >= 2, "lattice HA*: no path")
    check(all(free_np[i, j] for i, j in path), "lattice HA*: a path cell is blocked")
    cost = p.path_cost()
    line = math.hypot(bx - ax, by - ay)
    check(cost >= line - cfg.tol, f"lattice HA* cost {cost} < straight line {line} - tol")
    out = {"map": [h, w], "states": h * w * cfg.theta_res, "ring": p._ring_capacity(),
           "reset_ms": reset_ms, "solve_ms": spread(solve_ms), "eager_solve_ms": spread(eager_ms),
           "query_init_ms": init_ms, "query_init_eager_ms": init_eager_ms,
           "path_walk_ms": walk_ms, "rounds": p.rounds, "iterations_launched": p.launched,
           "host_reads": p.host_reads, "cost": cost, "n_expanded": int(p.state.n_expanded),
           "n_lost": int(p.state.n_lost), "path_cells": len(path),
           "walk": lattice_walk_phase(p, path, g_cut["state"]["gp"]),
           "graph_equals_eager": True, "cut": {"max_rounds": cut, "rounds": g_cut["rounds"],
                                               "launched_graph": g_cut["launched"],
                                               "launched_eager": e_cut["launched"]},
           "graphs": captured, "replays_per_query": replays,
           "profile": planner_profile(query), "profile_eager": planner_profile(eager),
           "query_init_profile": planner_profile(init)}
    query()
    t0 = time.perf_counter()
    q = HybridAStar(torch.from_numpy(free_np), a, b, cfg, device="cpu")
    q.solve()
    out["cpu_s"] = time.perf_counter() - t0
    for f in ("goal_idx", "goal_cost", "n_expanded", "n_lost", "wp", "gp"):
        check(torch.equal(getattr(q.state, f), getattr(p.state, f).cpu()),
              f"lattice HA* {f}: {dev} != CPU")
    check(q.recover_path() == path, f"lattice HA* path: {dev} != CPU")
    out["cpu_equal"] = True
    # solve_many: LATTICE_MANY stacked queries through their own capture
    # == eager chains == one query at a time.
    queries = [(a, b)] * LATTICE_MANY

    def many_eager():
        with eagerly():
            return p.solve_many(queries)

    before = lattice_chain_cuda.launch.launches
    many = (p.solve_many(queries), p._fleet_state.gp.clone(), p.launched, p.host_reads)
    check(lattice_chain_cuda.launch.launches - before == p.path_launches == LATTICE_MANY
          and all(p.recover_path_for(q) == path for q in range(LATTICE_MANY)),
          f"lattice HA* solve_many: {p.path_launches} walk launches, or a path != the query's")
    many_e = (many_eager(), p._fleet_state.gp.clone(), p.launched, p.host_reads)
    many_ms = event_ms(lambda: p.solve_many(queries))  # after the capture for Q
    many_eager_ms = event_ms(many_eager)
    check(many[0] == many_e[0] and torch.equal(many[1], many_e[1]) and many[2] == many_e[2]
          and many[3] <= many_e[3], "lattice HA* solve_many: graph != eager")
    check(all(r == (True, cost) for r in many[0]), "lattice HA* solve_many != solve")
    out["solve_many"] = {"queries": LATTICE_MANY, "ms": many_ms, "eager_ms": many_eager_ms,
                         "host_reads": many[3], "eager_host_reads": many_e[3],
                         "graph_equals_eager": True}
    return out


def path_edges(blocked, path):
    """The edges of an RRT* path (world points, goal first) on the bool map
    `blocked`, each from its tree parent as the planner checked it: (x0,
    y0, x1, y1) f32[E, 4]; march faults bool[E] (the fixed-step march from
    the parent meets a blocked cell before the child, or the child's cell
    is blocked); the longest blocked stretch along each edge, px f32[E],
    from EDGE_SAMPLES points; whether each child's cell is free, bool[E]."""
    from slam_tpu_torch.core import grid as gridlib
    from slam_tpu_torch.ops.raycast import raycast_march

    shape = tuple(blocked.shape)
    dev = blocked.device
    pts = torch.tensor(path, dtype=torch.float32, device=dev)
    x0, y0, x1, y1 = pts[1:, 0], pts[1:, 1], pts[:-1, 0], pts[:-1, 1]
    d = torch.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2)

    def blocked_at(x, y):
        i, j = gridlib.world_to_cell(shape, x, y)
        ic, jc = gridlib.clamp_cell(shape, i, j)
        return ~gridlib.in_bounds(shape, i, j) | blocked[ic.long(), jc.long()]

    dist, hit = raycast_march(blocked, x0, y0, torch.atan2(y1 - y0, x1 - x0), step=1.0,
                              max_dist=float(d.max()) + 2.0)
    end_free = ~blocked_at(x1, y1)
    fault = (hit & (dist < d)) | ~end_free
    t = torch.linspace(0.0, 1.0, EDGE_SAMPLES, device=dev)
    on = blocked_at(x0[:, None] + t * (x1 - x0)[:, None], y0[:, None] + t * (y1 - y0)[:, None])
    k = torch.arange(EDGE_SAMPLES, device=dev)
    last_free = torch.cummax(torch.where(on, -1, k), dim=1).values
    run = (k - last_free).amax(dim=1).to(torch.float32) * d / (EDGE_SAMPLES - 1)
    return torch.stack([x0, y0, x1, y1], 1), fault, run, end_free


def rrt_phase(dev, free_np) -> dict:
    """Phase 14a: `suite.py:229`'s RRT* (sdf default) over RRT_SEEDS,
    through the CUDA graph of its search chain (warm-up and replays under
    `sync_error`), each seed beside eager chains on the card
    (`eager_chains`): the tree, rounds and the generator's state
    afterwards equal bit for bit, also with max_rounds cut inside a block
    (both then draw for the block's remaining rounds). Every path edge ends in a free cell
    of `free_np` (the map inflated by 7) and crosses no blocked stretch of
    a ray step or more along it. The planner's sphere trace tests a ray at
    points a step or more apart, as the march does but at other points, so
    either may pass over a blocked corner that an edge clips by less than a
    step."""
    from slam_tpu_torch.core.config import RRTStarConfig
    from slam_tpu_torch.planners import RRTStar
    from slam_tpu_torch.planners import rrtstar as rrt_mod

    fields = rrt_mod._RRT_FIELDS
    h, w = free_np.shape
    a, b = plan_poses(h)
    free = torch.from_numpy(free_np).to(dev)
    cfg = RRTStarConfig(reach=20.0, radius=50.0, max_nodes=8192, batch=256)
    p = RRTStar(free, a, b, cfg, seed=999)
    p._graphs.guard = sync_error
    p.solve(max_rounds=RRT_ROUNDS)  # captures the chain
    captured = graph_stats(p._graphs)
    eagerly = eager_chains(p)

    def take():
        return {**snapshot(p, fields), "generator": p.generator.get_state(),
                "path": p.recover_path()}

    def graph_run(seed, max_rounds=RRT_ROUNDS):
        p.reset_query(a, b, seed)
        p.solve(max_rounds=max_rounds)

    def eager_run(seed, max_rounds=RRT_ROUNDS):
        with eagerly():
            graph_run(seed, max_rounds)

    eager_run(RRT_SEEDS[0])  # makes the eager chain's buffers
    ms, eager_ms, wins, rounds, costs, faults, max_run = [], [], 0, [], [], [], 0.0
    for seed in RRT_SEEDS:
        eager_ms.append(event_ms(lambda: eager_run(seed)))
        e = take()
        before = graph_stats(p._graphs)
        ms.append(event_ms(lambda: graph_run(seed)))
        g = take()
        hold_solves(g, e, fields, f"RRT* seed {seed}")
        check(torch.equal(g["generator"], e["generator"]) and g["path"] == e["path"],
              f"RRT* seed {seed}: generator state or path, graph != eager")
        rounds.append(p.rounds)
        if not p.success:
            continue
        wins += 1
        costs.append(p.path_cost())
        edges, fault, run, end_free = path_edges(~free, g["path"])
        check(bool(end_free.all()), f"RRT* seed {seed}: a path node lies in a blocked cell")
        check(float(run.max()) < p.rc.step,
              f"RRT* seed {seed}: a path edge crosses {float(run.max())} px of blocked cells "
              f"(>= a step, {p.rc.step})")
        max_run = max(max_run, float(run.max()))
        for e_ in fault.nonzero()[:, 0].tolist():
            faults.append({"seed": seed, "x0_y0_x1_y1": edges[e_].tolist(),
                           "blocked_run_px": float(run[e_])})
    check(wins >= RRT_MIN_SUCCESS,
          f"RRT* {wins} of {len(RRT_SEEDS)} found a path < {RRT_MIN_SUCCESS}")
    replays = graph_stats(p._graphs, before)
    # max_rounds inside a block: both draw for the block's remaining gated
    # rounds.
    cut = 8 * (rounds[0] // 16) + 3
    eager_run(RRT_SEEDS[0], cut)
    e_cut = take()
    graph_run(RRT_SEEDS[0], cut)
    g_cut = take()
    hold_solves(g_cut, e_cut, fields, f"RRT* max_rounds {cut}")
    check(torch.equal(g_cut["generator"], e_cut["generator"]),
          f"RRT* max_rounds {cut}: generator state, graph != eager")
    out = {"solve_ms": spread(ms), "eager_solve_ms": spread(eager_ms), "success": wins,
           "seeds": list(RRT_SEEDS), "rounds": rounds, "costs": costs, "nodes": p.size,
           "max_blocked_run_px": max_run, "march_faults": faults, "graph_equals_eager": True,
           "cut": {"max_rounds": cut, "rounds": g_cut["rounds"]}, "graphs": captured,
           "replays_last_seed": replays}
    out["profile_seed_1234"] = planner_profile(lambda: graph_run(RRT_SEEDS[0]))
    out["profile_eager_seed_1234"] = planner_profile(lambda: eager_run(RRT_SEEDS[0]))
    return out


def continuous_phase(dev, free_np) -> dict:
    """Phase 14b: continuous HA* with the suite's lut edge field
    (`suite.py:195`), theta_res 5, and with the sdf backend: the graph
    solve (the A* wavefront and the search chain, under `sync_error`)
    beside eager chains on the card (`eager_chains`), equal bit for bit
    (state, rounds, launched, path; host reads no more), also with
    max_rounds cut inside a block."""
    from slam_tpu_torch.core.config import RaycastConfig
    from slam_tpu_torch.core.types import Pose
    from slam_tpu_torch.planners import HybridAStar
    from slam_tpu_torch.planners import hastar as hastar_mod

    fields = hastar_mod._HA_FIELDS
    h, w = free_np.shape
    cfg = dataclasses.replace(plan_config(), mode="continuous", theta_res=5,
                              heuristic_weight=1.0)
    (ax, ay), (bx, by) = plan_poses(h)
    a, b = Pose.create(ax, ay, 0.0), Pose.create(bx, by, 0.0)
    out = {}
    for backend in ("lut", "sdf"):
        rc = RaycastConfig(backend=backend, step=1.0, lut_bins=180)
        p = None

        def reset():
            nonlocal p
            p = HybridAStar(torch.from_numpy(free_np).to(dev), a, b, cfg, rc)
            p._graphs.guard = sync_error

        def query(max_rounds=None):
            p.reset_query(a, b)
            p.solve(max_rounds)

        def eager(max_rounds=None):
            with eagerly():
                query(max_rounds)

        def take():
            return {**snapshot(p, fields), "path": p.recover_path()}

        reset_ms = event_ms(reset)
        query()  # captures the chains
        captured = graph_stats(p._graphs)
        eagerly = eager_chains(p)
        eager()  # makes the eager chains' buffers
        ms, eager_ms = [], []
        for _ in range(2 if backend == "lut" else 1):
            eager_ms.append(event_ms(eager))
            e = take()
            before = graph_stats(p._graphs)
            ms.append(event_ms(query))
            g = take()
            hold_solves(g, e, fields, f"continuous HA* ({backend})")
            check(g["path"] == e["path"], f"continuous HA* ({backend}) path: graph != eager")
        replays = graph_stats(p._graphs, before)
        check(p.success, f"continuous HA* ({backend}): no path")
        path = g["path"]
        check(len(path) >= 2 and all(free_np[i, j] for i, j in path),
              f"continuous HA* ({backend}): a path cell is blocked")
        res = {"reset_ms": reset_ms, "solve_ms": spread(ms), "eager_solve_ms": spread(eager_ms),
               "rounds": p.rounds, "iterations_launched": p.launched,
               "host_reads": p.host_reads, "cost": p.path_cost(),
               "n_expanded": int(p.state.n_expanded), "states": h * w * cfg.theta_res,
               "graph_equals_eager": True, "graphs": captured, "replays_per_query": replays}
        if backend == "lut":
            cut = 4 * (g["rounds"] // 8) + 3
            eager(cut)
            e_cut = take()
            query(cut)
            g_cut = take()
            hold_solves(g_cut, e_cut, fields, f"continuous HA* max_rounds {cut}")
            res["cut"] = {"max_rounds": cut, "rounds": g_cut["rounds"],
                          "launched_graph": g_cut["launched"],
                          "launched_eager": e_cut["launched"]}
            res["profile"] = planner_profile(query)
            res["profile_eager"] = planner_profile(eager)
        out[backend] = res
    return {**out["lut"], "sdf": out["sdf"]}


def spatial_phase(dev) -> dict:
    """Phase 14c: `suite.py:253-359`'s spatial workload: the bucketed
    build, box counts and blocked NN queries on SPATIAL_POINTS points; the
    card's results == the CPU's (NN on the first 256 queries)."""
    from slam_tpu_torch.ops import spatial

    n, n_boxes, n_queries = SPATIAL_POINTS, SPATIAL_BOXES, SPATIAL_QUERIES
    max_val, grid_cells = 10_000, 256
    cell = max_val / grid_cells
    rng = np.random.default_rng(0)
    px = rng.integers(0, max_val, n).astype(np.float32)
    py = rng.integers(0, max_val, n).astype(np.float32)
    lo = rng.integers(0, max_val, (n_boxes, 2)).astype(np.float32)
    ext = rng.integers(1, max_val // 10, (n_boxes, 2)).astype(np.float32)
    boxes = np.concatenate([lo, lo + ext], axis=1)
    qx = rng.integers(0, max_val, n_queries).astype(np.float32)
    qy = rng.integers(0, max_val, n_queries).astype(np.float32)

    def on(d):
        return [torch.from_numpy(v).to(d) for v in (px, py, boxes, qx, qy)]

    def build(px_, py_):
        ci = (torch.floor(py_ / cell).to(torch.int32) * grid_cells
              + torch.floor(px_ / cell).to(torch.int32))
        order = torch.argsort(ci, stable=True)
        return ci[order], order

    def counts(px_, py_, boxes_, chunk=100):
        valid = torch.ones_like(px_, dtype=torch.bool)
        return torch.cat([spatial.range_query_boxes(px_, py_, valid, boxes_[k:k + chunk]).sum(1)
                          for k in range(0, boxes_.shape[0], chunk)])

    def nn(px_, py_, qx_, qy_):
        return spatial.nearest_neighbor_blocked(px_, py_, torch.ones_like(px_, dtype=torch.bool),
                                                qx_, qy_)

    dpx, dpy, dbox, dqx, dqy = on(dev)
    cpx, cpy, cbox, cqx, cqy = on("cpu")
    for got, want, what in ((build(dpx, dpy), build(cpx, cpy), "bucketed build"),
                            ((counts(dpx, dpy, dbox),), (counts(cpx, cpy, cbox),), "box counts"),
                            (nn(dpx, dpy, dqx[:256], dqy[:256]), nn(cpx, cpy, cqx[:256], cqy[:256]),
                             "NN")):
        for g_, w_ in zip(got, want):
            check(torch.equal(g_.cpu(), w_), f"spatial {what}: {dev} != CPU")
    total = int(counts(dpx, dpy, dbox).sum())
    build_ms = statistics.median(event_ms(lambda: build(dpx, dpy)) for _ in range(5))
    count_ms = statistics.median(event_ms(lambda: counts(dpx, dpy, dbox)) for _ in range(5))
    nn_ms = statistics.median(event_ms(lambda: nn(dpx, dpy, dqx, dqy)) for _ in range(5))
    return {"points": n, "box_hits_total": total, "build_ms": build_ms,
            "bucketed_build_pts_per_s": n / (build_ms / 1e3), "box_count_ms": count_ms,
            "range_queries_per_s": n_boxes / (count_ms / 1e3), "nn_ms": nn_ms,
            "nn_queries_per_s": n_queries / (nn_ms / 1e3)}


def plain_lut_weights(lut, poses, scan, cfg, max_dist: float):
    """(panorama cell indices, weights) of `poses` through the plain LUT
    route the fused kernel replaces: sensor_pose, panorama_index,
    rows[idx], pano_log_weights."""
    from slam_tpu_torch.ops import lut as lutlib
    from slam_tpu_torch.ops import measurement

    h, w, n_bins = lut.shape
    sp = measurement.sensor_pose(poses, cfg.scanner_offset)
    pidx, inb = lutlib.panorama_index((h, w), sp.x, sp.y)
    pano = lut.reshape(h * w, n_bins)[pidx.long()]
    return pidx, measurement.pano_log_weights(
        pano, inb, sp.theta, scan, n_bins=n_bins, beam_stride=cfg.lut_beam_stride,
        lut_dtype=lut.dtype, max_dist=max_dist, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon)


def adversarial_poses(h: int, w: int, n_bins: int, n: int, span: int, displacement,
                      angle0: float, rng):
    """n poses (f32 numpy x, y, theta) and their kinds (index into
    ADVERSARIAL_KINDS),
    the kinds dealt in turn and shuffled, whose sensors (`displacement` =
    (d, theta, rot), `measurement.scanner_displacement`) land: in the
    table's last cell (row (h-1) w + w-1: a segment reaching its end is the
    table's last bytes); off the map's bottom-right edge (clamped to that
    cell, off the map); on a random cell with a segment of `span` bins
    that wraps (first bin in [n_bins - span + 1, n_bins)); on a random cell
    of odd row index (a u8 row of 360 B starts 8 B off 16 B); on a random
    cell. Each heading puts the first bin, round((theta + rot + angle0) /
    binw) mod n_bins, 0.3 bins or less off a chosen bin, so never on a
    rounding tie; each position sits 0.1 px or more inside its cell."""
    d, dth, rot = displacement
    binw = 2.0 * math.pi / n_bins
    kind = np.arange(n) % len(ADVERSARIAL_KINDS)
    rng.shuffle(kind)
    i = rng.integers(0, h, n)
    j = rng.integers(0, w, n)
    odd = kind == ADVERSARIAL_KINDS.index("odd_row")
    flip = odd & ((i * w + j) % 2 == 0)
    j = np.where(flip, np.where(j + 1 < w, j + 1, j - 1), j)
    # Cell (i, j) holds sensor y in (h - i - 2, h - i - 1] (i = floor(h - y - 1)).
    sx = j + rng.uniform(0.1, 0.9, n)
    sy = h - i - 1 - rng.uniform(0.1, 0.9, n)
    last = kind == ADVERSARIAL_KINDS.index("last_cell")
    sx = np.where(last, w - 1 + rng.uniform(0.1, 0.9, n), sx)
    sy = np.where(last, -rng.uniform(0.1, 0.9, n), sy)
    off = kind == ADVERSARIAL_KINDS.index("off_bottom_right")
    sx = np.where(off, w + rng.uniform(0.5, 50.0, n), sx)
    sy = np.where(off, -rng.uniform(1.5, 50.0, n), sy)
    first = rng.integers(0, n_bins, n)
    wrapped = kind == ADVERSARIAL_KINDS.index("wrapped")
    lo = max(n_bins - span + 1, 0)
    first = np.where(wrapped, rng.integers(lo, n_bins, n), first)
    first[np.flatnonzero(wrapped)[:8]] = n_bins - 1
    heading = (first + rng.uniform(-0.3, 0.3, n)) * binw - angle0 - rot
    theta = (heading + math.pi) % (2.0 * math.pi) - math.pi
    x = sx - np.cos(theta + dth) * d
    y = sy - np.sin(theta + dth) * d
    return (x.astype(np.float32), y.astype(np.float32), theta.astype(np.float32)), kind


def kernel_order_weights(lut, poses, scan, cfg, max_dist: float):
    """The plain per-beam terms of `poses` (sensor_pose, panorama_index, the
    table value at each beam's bin, log_pdf_normal_clamp_eps), summed in
    the fused kernel's order: lane l of a particle's warp adds beams l,
    l + 32, l + 64, ... in turn (an exact 0 past the scan), and the lanes'
    sums meet in the xor tree (16, 8, 4, 2, 1), which leaves every lane
    the same sum. Equal to the kernel's weights bit for bit wherever the
    kernel's terms equal PyTorch's (its exp and log are those of
    `torch.exp` and `torch.log`)."""
    from slam_tpu_torch.core.stats import log_pdf_normal_clamp_eps
    from slam_tpu_torch.ops import lut as lutlib
    from slam_tpu_torch.ops import measurement

    h, w, n_bins = lut.shape
    dev = lut.device
    n, b = poses.x.shape[0], scan.angles.shape[0]
    sp = measurement.sensor_pose(poses, cfg.scanner_offset)
    pidx, inb = lutlib.panorama_index((h, w), sp.x, sp.y)
    first = torch.remainder(torch.round((sp.theta + scan.angles[0]) / (2.0 * math.pi / n_bins))
                            .to(torch.int32), n_bins).long()
    bins = torch.remainder(first[:, None] + cfg.lut_beam_stride * torch.arange(b, device=dev),
                           n_bins)
    raw = lut.reshape(h * w, n_bins)[pidx.long()[:, None], bins]
    pred = lutlib.dequantize(raw, lut.dtype, max_dist)
    z = scan.dists.to(torch.float32)[None, :]
    err = torch.where((pred < max_dist) & inb[:, None], pred - z, z - max_dist)
    passes = -(-b // 32)
    terms = torch.zeros((n, passes * 32), dtype=torch.float32, device=dev)
    terms[:, :b] = log_pdf_normal_clamp_eps(cfg.meas_stddev, err, cfg.meas_epsilon)
    acc = torch.zeros((n, 32), dtype=torch.float32, device=dev)
    for j in range(passes):
        acc = acc + terms[:, 32 * j:32 * j + 32]
    lanes = torch.arange(32, device=dev)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ off]
    return acc[:, 0]


def order_held(lwk, lut, poses, scan, cfg, max_dist: float, label: str) -> float:
    """The share of the kernel's weights `lwk` of `poses` that equal the
    plain per-beam terms summed in the kernel's order bit for bit
    (`kernel_order_weights`); fails below LW_SHARE. Where that holds, a
    weight off the plain one by more than LW_RTOL, or a best particle
    other than the plain's, comes from the order of the sum alone."""
    same = float((kernel_order_weights(lut, poses, scan, cfg, max_dist).view(torch.int32)
                  == lwk.view(torch.int32)).float().mean())
    check(same >= LW_SHARE, f"lut_weights: {same} of weights == PyTorch's terms summed "
          f"in the kernel's order < {LW_SHARE} ({label})")
    return same


def hold_fused_to_plain(lut, poses, scan, cfg, max_dist: float, seed, odom, alphas,
                        label: str, ties: bool = False) -> dict:
    """The fused kernel's predict -> weigh launch on one filter's `poses`
    against its plain composition, as in phase 6: its poses == K1's for
    the same seed (int64 [1]) and host odometry bit for bit, its weights
    within a relative LW_RTOL of the plain LUT weights of those poses on
    LW_SHARE of the particles, the same best particle (`weights_held`,
    `ties` as there), and equal on LW_SHARE of them to the plain terms
    summed in the kernel's order bit for bit (`order_held`). Returns the
    share, the count outside, max |diff|, the best particle, the share
    equal in the kernel's order and the distinct panorama cells."""
    from slam_tpu_torch.ops import lut_weights_cuda, measurement, motion_cuda

    pk, lwk = lut_weights_cuda.launch(
        lut, lut.shape[-1], poses, scan, beam_stride=cfg.lut_beam_stride,
        displacement=measurement.scanner_displacement(cfg.scanner_offset),
        max_dist=max_dist, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon,
        motion=(seed, motion_cuda.odometry_rows(odom, lut.device), alphas))
    p1 = motion_cuda.launch(seed, odom, poses, alphas)
    for f in ("x", "y", "theta"):
        check(torch.equal(getattr(pk, f).view(torch.int32), getattr(p1, f).view(torch.int32)),
              f"lut_weights poses != K1's for the same seed ({f}; {label})")
    pidx, lwp = plain_lut_weights(lut, p1, scan, cfg, max_dist)
    return {**weights_held(lwk, lwp, label, ties),
            "kernel_order_share": order_held(lwk, lut, p1, scan, cfg, max_dist, label),
            "distinct_cells": int(torch.unique(pidx).numel())}


def weights_held(lwk, lwp, label: str, ties: bool = False) -> dict:
    """The kernel's weights `lwk` against the plain ones `lwp`: finite,
    within a relative LW_RTOL on LW_SHARE of the particles, the same first
    best particle. With `ties`, when the plain's two best weights lie so
    close that weights each within LW_RTOL of theirs may swap them (a tie
    that the beam sum's order may break either way), the kernel's best
    particle need only be one whose plain weight lies that close to the
    best. Returns the share, the count outside, max |diff|, the best
    particle and whether the best was tied."""
    diff = (lwk - lwp).abs()
    close = diff <= LW_RTOL * lwp.abs()
    share = float(close.float().mean())
    arg_k, arg_p = int(torch.argmax(lwk)), int(torch.argmax(lwp))
    check(bool(torch.isfinite(lwk).all()), f"lut_weights non-finite ({label})")
    check(share >= LW_SHARE, f"lut_weights {label}: {share} within {LW_RTOL} < {LW_SHARE}")
    top = torch.topk(lwp, 2).values.tolist()
    tied = ties and top[0] - top[1] <= LW_RTOL * (abs(top[0]) + abs(top[1]))
    if tied:
        mine = float(lwp[arg_k])
        check(top[0] - mine <= LW_RTOL * (abs(top[0]) + abs(mine)),
              f"lut_weights {label}: best particle {arg_k} not among the plain's tied best")
    else:
        check(arg_k == arg_p, f"lut_weights {label}: best particle {arg_k} != plain {arg_p}")
    return {"within_rtol_share": share, "outside": int((~close).sum()),
            "max_abs_diff": float(diff.max()), "best_particle": arg_k, "best_tied": int(tied)}


def hold_adversarial(lut, scan, cfg, max_dist: float, r: int, label: str, seed0: int) -> dict:
    """The fused kernel on adversarial clouds of RAGGED_N particles a robot
    (`adversarial_poses`: sensors in the table's last
    cell, off its bottom-right edge and so clamped to that cell, on
    segments that wrap, on rows of odd index (a u8 row 8 B off 16 B), on
    random cells), r robots in one launch (`scan` [B], or [r, B] for r >
    1) under the zero odometry with seeds seed0 + q: robot q's poses ==
    K1's for its seed bit for bit, its weights held to the plain
    composition (`weights_held`; these clouds put thousands of sensors in
    one cell, so their best weights may tie) and to the plain terms summed
    in the kernel's order bit for bit (`order_held`). With r = 1 also a shard of
    the particles from i0 = RAGGED_N // 3 on: its poses == K1's at that i0
    and its poses and weights == the whole launch's slice bit for bit.
    Returns the share within LW_RTOL, the count outside, max |diff|, the
    kinds' counts and, for each kind, the particles whose segment reaches
    the table's last byte."""
    from slam_tpu_torch.core.types import Odometry, Pose, Scan
    from slam_tpu_torch.ops import lut as lutlib
    from slam_tpu_torch.ops import lut_weights_cuda, measurement, motion_cuda

    dev = lut.device
    h, w, n_bins = lut.shape
    disp = measurement.scanner_displacement(cfg.scanner_offset)
    g = cfg.lut_beam_stride
    span = g * (scan.angles.shape[-1] - 1) + 1
    rng = np.random.default_rng(seed0)
    scans = [scan] if r == 1 else [Scan(angles=scan.angles[q], dists=scan.dists[q])
                                   for q in range(r)]
    clouds, kinds = [], []
    for q in range(r):
        xyz, kind = adversarial_poses(h, w, n_bins, RAGGED_N, span, disp,
                                      float(scans[q].angles[0]), rng)
        clouds.append([torch.from_numpy(v).to(dev) for v in xyz])
        kinds.append(kind)
    poses = Pose(*clouds[0]) if r == 1 else Pose(*(torch.stack(v) for v in zip(*clouds)))
    zero = Odometry.create(0.0, 0.0, 0.0)
    seeds = torch.arange(r, dtype=torch.int64, device=dev) + seed0
    alphas = (0.0005, 0.0005, 0.01, 0.01)
    wkw = dict(beam_stride=g, displacement=disp, max_dist=max_dist, stddev=cfg.meas_stddev,
               eps=cfg.meas_epsilon)
    rows = motion_cuda.odometry_rows(Odometry.create([0.0] * r, [0.0] * r, [0.0] * r), dev)
    pk, lwk = lut_weights_cuda.launch(lut, n_bins, poses, scan, motion=(seeds, rows, alphas),
                                      **wkw)
    outside, max_diff, at_end, ties, order = 0, 0.0, {}, 0, 1.0
    cell_bytes = n_bins * lut.element_size()
    for q in range(r):
        pq = poses if r == 1 else Pose(x=poses.x[q], y=poses.y[q], theta=poses.theta[q])
        kq = pk if r == 1 else Pose(x=pk.x[q], y=pk.y[q], theta=pk.theta[q])
        lq = lwk if r == 1 else lwk[q]
        p1 = motion_cuda.launch(seeds[q:q + 1], zero, pq, alphas)
        for f in ("x", "y", "theta"):
            check(torch.equal(getattr(kq, f).view(torch.int32), getattr(p1, f).view(torch.int32)),
                  f"lut_weights poses != K1's ({f}; {label}, robot {q})")
        pidx, lwp = plain_lut_weights(lut, p1, scans[q], cfg, max_dist)
        held = weights_held(lq, lwp, f"{label}, robot {q}", ties=True)
        order = min(order, order_held(lq, lut, p1, scans[q], cfg, max_dist,
                                      f"{label}, robot {q}"))
        ties += held["best_tied"]
        outside += held["outside"]
        max_diff = max(max_diff, held["max_abs_diff"])
        # A segment reaches the table's last bytes: the last cell, on the
        # map, with a segment running to its row's end.
        sp = measurement.sensor_pose(p1, cfg.scanner_offset)
        inb = lutlib.panorama_index((h, w), sp.x, sp.y)[1]
        first = torch.remainder(torch.round((sp.theta + scans[q].angles[0]) / (
            2 * math.pi / n_bins)), n_bins)
        end = (pidx == h * w - 1) & inb & (first + span >= n_bins)
        for k, name in enumerate(ADVERSARIAL_KINDS):
            sel = torch.from_numpy(kinds[q] == k).to(dev)
            at_end[name] = at_end.get(name, 0) + int((end & sel).sum())
    share = 1.0 - outside / (r * RAGGED_N)
    check(share >= LW_SHARE, f"lut_weights {label}: {share} within {LW_RTOL} < {LW_SHARE}")
    check(at_end["last_cell"] > 0, f"lut_weights {label}: no copy reached the table's end")
    out = {"robots": r, "particles": RAGGED_N, "table_bytes_mod_16":
           lut.numel() * lut.element_size() % 16, "row_bytes": cell_bytes,
           "within_rtol_share": share, "outside": outside, "max_abs_diff": max_diff,
           "robots_best_tied": ties, "kernel_order_share_min": order, "kinds": {name: int(sum((k_ == i).sum() for k_ in kinds))
                     for i, name in enumerate(ADVERSARIAL_KINDS)}, "reach_table_end": at_end}
    if r == 1:
        i0 = RAGGED_N // 3
        part = Pose(*(v[i0:].contiguous() for v in (poses.x, poses.y, poses.theta)))
        ps, lws = lut_weights_cuda.launch(lut, n_bins, part, scan, motion=(seeds, rows, alphas),
                                          i0=i0, **wkw)
        p1 = motion_cuda.launch(seeds, zero, part, alphas, i0=i0)
        for f in ("x", "y", "theta"):
            a, b, c = (getattr(v, f) for v in (ps, p1, pk))
            check(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  and torch.equal(a.view(torch.int32), c[i0:].view(torch.int32)),
                  f"lut_weights shard at i0 = {i0} != K1 / the whole launch ({f}; {label})")
        check(torch.equal(lws.view(torch.int32), lwk[i0:].view(torch.int32)),
              f"lut_weights shard at i0 = {i0}: weights != the whole launch's ({label})")
        out["shard_i0"] = i0
    return out


def clone_generator(g: torch.Generator) -> torch.Generator:
    c = torch.Generator(device=g.device)
    c.set_state(g.get_state())
    return c


def no_sync(fn):
    """fn() with a host sync raising (torch's sync debug mode)."""
    with sync_error():
        return fn()


def top_kernels(prof, k: int = 8):
    return [[n[:90], round(v[0], 4), round(v[1], 2)]
            for n, v in sorted(prof.items(), key=lambda kv: -kv[1][0])[:k]]


def globalloc_phase(dev, blocked_np, field, counts) -> dict:
    """Phase 15: `tools/global_loc_bench.py`'s configuration through
    mcl.step at GL_PARTICLES particles, driven by the port's tool
    (`slam_tpu_torch/tools/global_loc_bench.py`): init_uniform on the card
    (moved particles on free cells, the share left at the start pose
    against the plan's blocked share, headings by moments); the fused
    kernel against its plain composition at step 1 of the uniform cloud;
    GL_SEEDS seeds x GL_STEPS steps (convergence, post-convergence ATE,
    CUDA-event step times, launches, the truth's weight rank on the final
    scan, profiles); one run with GL_PLANT particles planted next to the
    truth; three adaptive steps through the fused route."""
    from slam_tpu_torch.core.config import AdaptiveConfig
    from slam_tpu_torch.core.types import Pose
    from slam_tpu_torch.models import mcl as mcl_mod
    from slam_tpu_torch.models.simulate import forward_arc_commands
    from slam_tpu_torch.ops import lut_weights_cuda, measurement, motion_cuda
    from slam_tpu_torch.tools import global_loc_bench as glb

    reset_counts, read_counts = counts
    fused = lut_weights_cuda.launch
    blocked = torch.from_numpy(blocked_np).to(dev)
    h, w = blocked_np.shape
    n = GL_PARTICLES
    lidar, rc, scan_rc, cfg = glb.configs(n)
    alphas = glb.ALPHAS
    cmds = forward_arc_commands(GL_STEPS, trans=2.5, rot=0.04)
    out = {"particles": n, "steps": GL_STEPS, "seeds": list(GL_SEEDS)}

    # init_uniform on the card.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st0 = mcl_mod.init_uniform(mcl_mod.make_generator(0, dev), n, blocked)
    torch.cuda.synchronize()
    out["init_uniform_ms"] = (time.perf_counter() - t0) * 1e3
    p = st0.particles.pose
    at_start = (p.x == w / 2.0) & (p.y == h / 2.0) & (p.theta == math.pi / 2.0)
    moved = ~at_start
    i = (h - p.y).long().clamp(0, h - 1)
    j = p.x.long().clamp(0, w - 1)
    check(not bool((blocked[i, j] & moved).any()), "init_uniform: a moved particle is blocked")
    check(bool((p.x[moved] == torch.floor(p.x[moved])).all()), "init_uniform: off-cell pose")
    share, pb = float(at_start.float().mean()), float(blocked_np.mean())
    tol = 5.0 * math.sqrt(pb * (1.0 - pb) / n)
    check(abs(share - pb) < tol, f"init_uniform: {share} at the start pose vs blocked share "
          f"{pb} (5 sigma {tol})")
    th = p.theta[moved].double()
    m = th.numel()
    mean_tol = 5.0 * (math.pi / math.sqrt(3.0)) / math.sqrt(m)
    var_tol = 5.0 * math.sqrt(4.0 * math.pi ** 4 / 45.0 / m)
    check(abs(float(th.mean())) < mean_tol and abs(float((th * th).mean()) - math.pi ** 2 / 3)
          < var_tol, "init_uniform: headings not uniform on [-pi, pi)")
    out["init_uniform"] = {"left_at_start": share, "blocked_share": pb, "five_sigma": tol,
                           "heading_mean": float(th.mean()),
                           "heading_second_moment": float((th * th).mean())}

    def truth_and_scans(seed):
        return glb.truth_and_scans(blocked, lidar, scan_rc, cfg, seed, cmds)

    # The fused kernel at step 1 of the uniform cloud, against its plain
    # composition (K1, then the plain LUT weights), as in phase 6.
    truths0, scans0 = truth_and_scans(GL_SEEDS[0])
    wkw = dict(beam_stride=cfg.lut_beam_stride,
               displacement=measurement.scanner_displacement(cfg.scanner_offset),
               max_dist=rc.max_dist, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon)
    sd = torch.tensor([13], dtype=torch.int64, device=dev)
    held = hold_fused_to_plain(field.lut, p, scans0[0], cfg, rc.max_dist, sd, cmds[0], alphas,
                               "1M uniform cloud")
    motion_args = (sd, motion_cuda.odometry_rows(cmds[0], dev), alphas)
    cells = held["distinct_cells"]
    n_beams = scans0[0].angles.shape[0]
    lw_bound = bound(n * (12 + 12 + 4) + cells * n_beams * 2 + n_beams * 8 + 8,
                     n * (OPS_SAMPLE + OPS_LOCATE + n_beams * OPS_BEAM))
    k_ms = device_ms(lambda: fused(field.lut, 360, p, scans0[0], motion=motion_args, **wkw),
                     iters=10)[0]
    plain_ms = device_ms(lambda: plain_lut_weights(
        field.lut, motion_cuda.launch(sd, cmds[0], p, alphas), scans0[0], cfg, rc.max_dist),
        iters=5, warmup=1)[0]
    out["lut_weights_1m_uniform"] = {
        **held, "ms": k_ms, "plain_ms": plain_ms, "bound_ms": lw_bound[0], "bound_by": lw_bound[1],
        "bound_share": lw_bound[0] / k_ms}
    say("globalloc", f"init_uniform {out['init_uniform']}; lut_weights at step 1 of the "
        f"{n} uniform cloud: poses == K1's bit for bit; {json.dumps(out['lut_weights_1m_uniform'])}")

    lw_kw = dict(scanner_offset=cfg.scanner_offset, stddev=cfg.meas_stddev,
                 eps=cfg.meas_epsilon, lut_beam_stride=cfg.lut_beam_stride)
    launches = dict.fromkeys(KERNEL_NAMES, 0)

    engine = mcl_mod.MCL(cfg, rc, device=dev)
    engine.graphs.guard = sync_error

    def drive(st, scans):
        """GL_STEPS steps through the tool's graphed step, every replay
        under the sync check; their launch counts (a new cloud's
        generator is a new block: one warm-up launch)."""
        torch.cuda.synchronize()
        reset_counts()
        st, stats, ms = glb.run(st, field, cmds, scans, cfg, rc, engine=engine)
        c, w = read_counts(), warmup_counts()
        check(c["lut_weights"] == GL_STEPS + w["lut_weights"] and c["motion_odometry"] == 0
              and c["gather_rows"] == 0 and w["lut_weights"] >= 1,
              f"global localization launches {c} (warm-ups {w}) for {GL_STEPS} steps")
        for k_ in launches:
            launches[k_] += c[k_]
        return st, stats, ms

    runs, per_step = [], GL_STEPS // GL_BLOCKS
    for seed in GL_SEEDS:
        truths, scans = (truths0, scans0) if seed == GL_SEEDS[0] else truth_and_scans(seed)
        st = mcl_mod.init_uniform(mcl_mod.make_generator(seed, dev), n, blocked)
        near = glb.near_start(st.particles.pose)
        st, stats, ms = drive(st, scans)
        res = glb.summarize(stats, truths)
        check(res["finite"], f"global localization seed {seed}: non-finite estimates")
        blocks = [sum(ms[b * per_step:(b + 1) * per_step]) / per_step for b in range(GL_BLOCKS)]
        # How well the final estimate and the truth explain the final scan:
        # their weights' ranks among those of the init_uniform cloud
        # (random poses over free space) on that scan.
        ref = measurement.particle_log_weights(field, p, scans[-1], rc=rc, **lw_kw)
        bp = st.best_pose
        lw_est, lw_truth = (float(measurement.particle_log_weights(
            field, q, scans[-1], rc=rc, **lw_kw)[0]) for q in (
            Pose(x=bp.x.reshape(1), y=bp.y.reshape(1), theta=bp.theta.reshape(1)),
            Pose.create([truths[-1, 0]], [truths[-1, 1]], [truths[-1, 2]], device=dev)))
        runs.append({"seed": seed, **res, "near_start": near,
                     "final_lw_estimate": lw_est, "final_lw_truth": lw_truth,
                     "estimate_rank": float((ref < lw_est).float().mean()),
                     "truth_rank": float((ref < lw_truth).float().mean()),
                     "ms_per_step": spread(blocks), "step_1_ms": ms[0]})
        say("globalloc", json.dumps(runs[-1]))
        if seed == GL_SEEDS[0]:
            box = [st, GL_STEPS]

            def advance():
                k_ = box[1] % GL_STEPS
                box[0] = mcl_mod.step(box[0], cmds[k_], alphas, scans[k_], field, cfg, rc)
                box[1] += 1

            converged_prof = step_profile(advance, iters=5, warmup=1)
            box = [mcl_mod.init_uniform(mcl_mod.make_generator(seed, dev), n, blocked), 0]
            uniform_prof = step_profile(advance, iters=1)
    for r in runs:
        check(r["truth_rank"] >= GL_TRUTH_RANK,
              f"global localization seed {r['seed']}: the truth outweighs only "
              f"{r['truth_rank']} of the uniform cloud on the final scan (bound {GL_TRUTH_RANK})")
        check(r["converged_at_step"] is None or r["post_convergence_ate_px"] < GL_ATE_PX,
              f"global localization seed {r['seed']}: post-convergence ATE "
              f"{r['post_convergence_ate_px']} px >= {GL_ATE_PX}")

    # GL_PLANT particles of seed GL_SEEDS[0]'s cloud planted next to the
    # truth's start pose: the filter must converge on the truth.
    st = glb.plant(mcl_mod.init_uniform(mcl_mod.make_generator(GL_SEEDS[0], dev), n, blocked),
                   torch.randn((3, GL_PLANT), device=dev,
                               generator=mcl_mod.make_generator(GL_SEEDS[0] + 200, dev)))
    planted = {"planted": GL_PLANT, "near_start": glb.near_start(st.particles.pose)}
    st, stats, ms = drive(st, scans0)
    planted.update(glb.summarize(stats, truths0), ms_per_step=statistics.median(ms))
    say("globalloc", f"planted {json.dumps(planted)}")
    check(planted["converged_at_step"] is not None
          and planted["converged_at_step"] <= GL_PLANT_BY
          and planted["post_convergence_ate_px"] < GL_ATE_PX,
          f"global localization with {GL_PLANT} particles planted at the truth: {planted} "
          f"(bounds: converged by step {GL_PLANT_BY}, ATE < {GL_ATE_PX} px)")
    out.update(runs=runs, planted=planted, launches=launches,
               converged_step=converged_prof, uniform_step_1=uniform_prof,
               converged_on_truth=sum(r["converged_at_step"] is not None for r in runs))

    # Adaptive injection through the fused route: three steps, no sync.
    acfg = dataclasses.replace(cfg, adaptive=AdaptiveConfig(max_ratio=0.1))
    st = mcl_mod.init_uniform(mcl_mod.make_generator(9, dev), n, blocked)
    reset_counts()
    for k in range(3):
        st = no_sync(lambda: mcl_mod.step(st, cmds[k], alphas, scans0[k], field, acfg, rc))
    c = read_counts()
    check(c["lut_weights"] == 3, f"adaptive mcl.step launches {c}")
    for k_ in launches:
        launches[k_] += c[k_]
    check(bool(torch.isfinite(st.log_w_slow)) and bool(torch.isfinite(st.log_w_fast)),
          "adaptive EMAs not finite after three fused steps")
    out["adaptive_fused"] = {"log_w_slow": float(st.log_w_slow), "log_w_fast": float(st.log_w_fast)}
    return out


def autotier_phase(dev, slam_scans, slam_odom, counts) -> dict:
    """Phase 16: GridSLAM(likelihood_field_auto) at slam_config(): the
    auto step equal bit for bit to the forced-table step on a converged
    state and to the forced-direct step on an init_uniform state (same
    generator state); then AUTO_STEPS steps through the dispatcher, the
    cloud dispersed (init_uniform over the grid's free cells) after
    AUTO_DISPERSE_AT, each step under the sync check with the lagged
    predicate read outside it; each tier's step profiled, and mcl.update
    with each of the three measurements timed on the same states."""
    from slam_tpu_torch.core import grid as gridlib
    from slam_tpu_torch.entry import state_difference
    from slam_tpu_torch.core.types import Pose
    from slam_tpu_torch.models import mcl as mcl_mod
    from slam_tpu_torch.models import slam as slam_mod
    from slam_tpu_torch.ops import edt as edtlib
    from slam_tpu_torch.ops.rayfield import RayField

    reset_counts, read_counts = counts
    base = slam_config()
    cfgs = {m: dataclasses.replace(base, mcl=dataclasses.replace(base.mcl, measurement=m))
            for m in ("likelihood_field_auto", "likelihood_field_table", "likelihood_field")}
    start = Pose.create(400.0, 400.0, math.pi, device=dev)

    def clone(s):
        return s.replace(mcl=s.mcl.replace(generator=clone_generator(s.mcl.generator)))

    def dispersed(s, seed):
        u = mcl_mod.init_uniform(mcl_mod.make_generator(seed, dev), base.mcl.n_particles,
                                 gridlib.blocked_from_logodds(s.grid))
        return s.replace(mcl=s.mcl.replace(particles=u.particles))

    engine = slam_mod.GridSLAM(cfgs["likelihood_field_auto"], seed=0, device=dev)
    st = engine.init(start)
    equal = {}
    step_ms, tiers_ms = [], []
    reset_counts()
    for k in range(AUTO_STEPS):
        z = slam_scans[k % 2]
        if k == 5:  # updates == 5: the next step does not resample
            for label, s_, forced in (("converged", st, "likelihood_field_table"),
                                      ("init_uniform", dispersed(st, 5), "likelihood_field")):
                fresh = slam_mod.GridSLAM(cfgs["likelihood_field_auto"], seed=0, device=dev)
                a = fresh.step(clone(s_), slam_odom, z)
                f = slam_mod.step(clone(s_), slam_odom, z, cfgs[forced])
                for name, x, y in (("x", a.mcl.particles.pose.x, f.mcl.particles.pose.x),
                                   ("theta", a.mcl.particles.pose.theta,
                                    f.mcl.particles.pose.theta),
                                   ("log_weight", a.mcl.particles.log_weight,
                                    f.mcl.particles.log_weight),
                                   ("grid", a.grid, f.grid), ("est_x", a.est_pose.x, f.est_pose.x)):
                    check(torch.equal(x, y), f"auto step != forced {forced} step ({label}, {name})")
                equal[label] = {"tier": fresh._auto.tiers[0], "forced": forced}
            converged_5 = st
            reset_counts()  # the comparison steps launched K1 too
        if k == AUTO_DISPERSE_AT:
            st = dispersed(st, 7)
        engine._auto.read_tier(st)  # the lagged read, outside the sync check
        start_e = torch.cuda.Event(enable_timing=True)
        stop_e = torch.cuda.Event(enable_timing=True)
        start_e.record()
        st = no_sync(lambda: engine.step(st, slam_odom, z))
        stop_e.record()
        step_ms.append((start_e, stop_e))
    torch.cuda.synchronize()
    c, w = read_counts(), warmup_counts()
    steps_after = AUTO_STEPS - 5
    check(c["motion_odometry"] == steps_after + w["motion_odometry"],
          f"autotier K1 launches {c} != {steps_after} + warm-ups {w}")
    d = engine._auto
    ms = [a.elapsed_time(b) for a, b in step_ms]
    lag = AUTO_DISPERSE_AT + 2 * d.check_every
    check("direct" in d.tiers[AUTO_DISPERSE_AT:lag],
          f"autotier: the dispersed cloud took no direct step by step {lag}: {d.tiers}")
    check(d.host_reads == 1 + (AUTO_STEPS - 1) // d.check_every,
          f"autotier: {d.host_reads} predicate reads in {AUTO_STEPS} steps")
    for v in (st.grid, st.mcl.particles.log_weight, st.est_pose.x):
        check(bool(torch.isfinite(v).all()), "autotier: non-finite state")

    # Each tier's step profiled: the forced-table step on the converged
    # state, the forced-direct step on a dispersed one (what the
    # dispatcher calls; the converged state is step 5's). Then mcl.update's
    # own auto route (JAX's lax.cond) beside the two forced tiers on the
    # same predicted states and field: the free function (one host read of
    # the predicate, one tier) and `MCL.update` (one graph, the tier under
    # `cond`: IF nodes, no host read) each equal to the forced tier bit for
    # bit.
    profiles, update_ms = {}, {}
    for label, s0, forced in (("table", converged_5, "likelihood_field_table"),
                              ("direct", dispersed(st, 11), "likelihood_field")):
        box = [s0, 0]

        def advance():
            box[0] = slam_mod.step(box[0], slam_odom, slam_scans[box[1] % 2], cfgs[forced])
            box[1] += 1

        profiles[label] = step_profile(advance, iters=3)
        blocked = gridlib.blocked_from_logodds(s0.grid)
        lf_field = RayField(blocked=blocked, edt=edtlib.edt_capped(
            blocked, 5.0 * base.mcl.meas_stddev + 2.0))
        pst = mcl_mod.predict(s0.mcl, slam_odom, base.motion.alphas)

        def fresh_pst():
            return pst.replace(generator=clone_generator(pst.generator))

        auto_mcl = cfgs["likelihood_field_auto"].mcl
        want = mcl_mod.update(fresh_pst(), slam_scans[0], lf_field, cfgs[forced].mcl,
                              base.raycast)
        eng = mcl_mod.MCL(auto_mcl, base.raycast, device=dev)
        eng.graphs.guard = sync_error
        for way, got in (("free function", mcl_mod.update(fresh_pst(), slam_scans[0], lf_field,
                                                           auto_mcl, base.raycast)),
                         ("MCL.update", eng.update(fresh_pst(), slam_scans[0], lf_field))):
            diff = state_difference(got, want)
            check(diff is None, f"auto mcl.update ({way}) != forced {forced} ({label}): {diff}")
        update_ms[label] = {}
        for m_, c_ in cfgs.items():
            dev_ms, n_launch = device_ms(lambda: mcl_mod.update(
                pst, slam_scans[0], lf_field, c_.mcl, base.raycast), iters=5, warmup=1)
            update_ms[label][m_] = {"device_ms": dev_ms, "launches": n_launch, "ms": statistics.median(
                event_ms(lambda: mcl_mod.update(pst, slam_scans[0], lf_field, c_.mcl, base.raycast))
                for _ in range(5))}
        eng.update(pst, slam_scans[0], lf_field)  # its generator's blocks, captured
        prof = planner_profile(lambda: [eng.update(pst, slam_scans[0], lf_field)
                                        for _ in range(5)])
        update_ms[label]["MCL.update auto (graphs)"] = {
            "device_ms": prof["device_ms_per_solve"] / 5, "launches": prof["launches_per_solve"] / 5,
            "host_issued": prof["host_issued_per_solve"] / 5, "ms": statistics.median(
                event_ms(lambda: eng.update(pst, slam_scans[0], lf_field)) for _ in range(5)),
            "equal_to_forced": forced}
    return {"equal_bit_for_bit": equal, "steps": AUTO_STEPS, "dispersed_at": AUTO_DISPERSE_AT,
            "check_every": d.check_every, "host_reads": d.host_reads, "tiers": d.tiers,
            "ms_per_step": spread(ms), "ms_table": spread([m for m, t in zip(ms, d.tiers)
                                                           if t == "table"]),
            "ms_direct": spread([m for m, t in zip(ms, d.tiers) if t == "direct"]),
            "step_profiles": profiles, "mcl_update_1m": update_ms,
            "launches_after_step_5": c}


def kidnap_phase(dev) -> dict:
    """Phase 17: tests/test_mcl.py:347-392's kidnap scenario on the card
    (1024 particles, the 128x128 room, sdf field, direct likelihood field,
    AdaptiveConfig(max_ratio=0.1)), over KIDNAP_SEEDS; the test's bounds
    (tracking < 2 px before the kidnap, min error < 3 px and mean of the
    last 10 < 4 px after it) hold for KIDNAP_SEED."""
    from slam_tpu_torch.core.config import AdaptiveConfig, LidarConfig, MCLConfig, RaycastConfig
    from slam_tpu_torch.core.types import Odometry, Pose
    from slam_tpu_torch.models import fake_lidar
    from slam_tpu_torch.models import mcl as mcl_mod
    from slam_tpu_torch.models.simulate import synthetic_room
    from slam_tpu_torch.ops import edt as edtlib
    from slam_tpu_torch.ops import motion
    from slam_tpu_torch.ops.rayfield import RayField

    blocked = torch.from_numpy(synthetic_room(128, 128)).to(dev)
    field = RayField(blocked=blocked, edt=edtlib.edt_jfa(blocked))
    rc = RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    lidar = LidarConfig(max_dist=60.0, n_rays=36)
    cfg = MCLConfig(n_particles=1024, meas_stddev=3.0, measurement="likelihood_field",
                    adaptive=AdaptiveConfig(max_ratio=0.1))
    odom = Odometry.create(0.03, 1.2, 0.03)
    runs = {}
    t0 = time.perf_counter()
    for seed in KIDNAP_SEEDS:
        gt = Pose.create(40.0, 40.0, 0.3)
        st = mcl_mod.init(mcl_mod.make_generator(seed, dev), cfg.n_particles, gt.to(dev))
        g_gt = torch.Generator().manual_seed(seed + 100)
        errs = []
        for t in range(50):
            if t == 10:
                gt = Pose.create(90.0, 90.0, -0.8)  # kidnap
            gt = motion.sample_motion_model_odometry(odom, gt, (0.002,) * 4, generator=g_gt)
            scan = fake_lidar.scan(blocked, gt.to(dev), lidar, rc)
            st = mcl_mod.update(mcl_mod.predict(st, odom, (0.002,) * 4), scan, field, cfg, rc)
            errs.append(math.hypot(float(st.mode_pose.x) - float(gt.x),
                                   float(st.mode_pose.y) - float(gt.y)))
        runs[seed] = {"before_kidnap_px": errs[9], "min_after_px": min(errs[10:]),
                      "mean_last_10_px": float(np.mean(errs[-10:]))}
    ok = {s: r["before_kidnap_px"] < 2.0 and r["min_after_px"] < 3.0
          and r["mean_last_10_px"] < 4.0 for s, r in runs.items()}
    r = runs[KIDNAP_SEED]
    check(ok[KIDNAP_SEED], f"kidnap seed {KIDNAP_SEED}: {r} (bounds 2 / 3 / 4 px)")
    check(all(v["before_kidnap_px"] < 2.0 for v in runs.values()), f"kidnap tracking: {runs}")
    return {"runs": runs, "recovered_within_bounds": sum(ok.values()), "of": len(ok),
            "checked_seed": KIDNAP_SEED, "seconds": time.perf_counter() - t0}


def scanmatch_phase(dev, blocked_np, slam_scans, slam_odom, counts, slam_med) -> dict:
    """Phase 18: refine_pose on the card against the port's CPU result on
    the floor plan's capped EDT field (the same seed pose and scan; pose
    within SM_PX / SM_RAD, subcell off pins the integer argmax), coarse
    level off and on; then the 1M SLAM step with ScanMatchConfig() under
    the sync check, beside phase 9's step."""
    from slam_tpu_torch.core.config import LidarConfig, RaycastConfig, ScanMatchConfig
    from slam_tpu_torch.core.types import Pose
    from slam_tpu_torch.models import fake_lidar
    from slam_tpu_torch.models import slam as slam_mod
    from slam_tpu_torch.ops import edt as edtlib
    from slam_tpu_torch.ops import scanmatch
    from slam_tpu_torch.ops.rayfield import RayField

    reset_counts, read_counts = counts
    rc = RaycastConfig(step=0.5, max_dist=500.0)
    lidar = LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90)
    truth = Pose.create(640.0, 190.0, 0.3)
    seed_pose = Pose.create(642.3, 188.3, 0.33)
    out = {"cases": {}}
    fields = {}
    for d in (dev, torch.device("cpu")):
        b = torch.from_numpy(blocked_np).to(d)
        fields[d.type] = (RayField(blocked=b, edt=edtlib.edt_capped(b, 27.0)),
                          fake_lidar.scan(b, truth.to(d), lidar, rc))
    scan_cpu = fields["cpu"][1]
    fields["cuda"] = (fields["cuda"][0], scan_cpu.to(dev))
    for subcell in (True, False):
        for coarse in (0, 12):
            cfg = ScanMatchConfig(subcell=subcell, coarse_window=coarse)
            res = {}
            for key_, (f, z) in fields.items():
                res[key_] = scanmatch.refine_pose(f, seed_pose.to(f.edt.device), z, rc=rc,
                                                  cfg=cfg, stddev=5.0)
            (pc, kc), (pg, kg) = res["cpu"], res["cuda"]
            dxy = max(abs(float(pc.x) - float(pg.x)), abs(float(pc.y) - float(pg.y)))
            dth = abs(float(pc.theta) - float(pg.theta))
            check(dxy <= SM_PX and dth <= SM_RAD,
                  f"refine_pose card vs CPU: {dxy} px, {dth} rad (subcell {subcell}, coarse "
                  f"{coarse})")
            label = f"subcell={subcell},coarse_window={coarse}"
            out["cases"][label] = {"pose": [float(pg.x), float(pg.y), float(pg.theta)],
                                   "max_dxy_px": dxy, "dtheta_rad": dth,
                                   "peak_card": float(kg), "peak_cpu": float(kc)}
            if subcell and not coarse:
                f, z = fields["cuda"]
                sp_dev = seed_pose.to(dev)
                out["refine_ms"] = statistics.median(event_ms(lambda: scanmatch.refine_pose(
                    f, sp_dev, z, rc=rc, cfg=cfg, stddev=5.0)) for _ in range(5))
                out["refine_device_ms"], out["refine_launches"] = device_ms(
                    lambda: scanmatch.refine_pose(f, sp_dev, z, rc=rc, cfg=cfg, stddev=5.0),
                    iters=5, warmup=1)
    say("scanmatch", json.dumps(out))

    sm_cfg = dataclasses.replace(slam_config(), scanmatch=ScanMatchConfig())
    engine = slam_mod.GridSLAM(sm_cfg, seed=0, device=dev)
    st = engine.init(Pose.create(400.0, 400.0, math.pi, device=dev))
    reset_counts()
    n_steps = 0
    for _ in range(4):
        st = engine.step(st, slam_odom, slam_scans[n_steps % 2])
        n_steps += 1
    torch.cuda.synchronize()
    block_ms = []
    for _ in range(SM_BLOCKS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SM_ITERS):
            st = no_sync(lambda: engine.step(st, slam_odom, slam_scans[n_steps % 2]))
            n_steps += 1
        stop.record()
        stop.synchronize()
        block_ms.append(start.elapsed_time(stop) / SM_ITERS)
    c, w = read_counts(), warmup_counts()
    check(c["motion_odometry"] == n_steps + w["motion_odometry"],
          f"scan-matched SLAM K1 launches {c} != {n_steps} + warm-ups {w}")
    for v in (st.est_pose.x, st.est_pose.y, st.grid):
        check(bool(torch.isfinite(v).all()), "scan-matched SLAM: non-finite state")
    box = [st, n_steps]

    def advance():
        box[0] = engine.step(box[0], slam_odom, slam_scans[box[1] % 2])
        box[1] += 1

    return {**out, "slam_ms_per_step": spread(block_ms), "phase9_ms_per_step": slam_med,
            **step_profile(advance, iters=SM_ITERS), "launches": c,
            "est_minus_best_px": math.hypot(float(st.est_pose.x - st.mcl.best_pose.x),
                                            float(st.est_pose.y - st.mcl.best_pose.y))}


def rbpf_config():
    """`tools/rbpf_fidelity.py:50-80`'s configuration at RBPF_PARTICLES maps:
    (cfg, rc, lidar)."""
    from slam_tpu_torch.core.config import LidarConfig, MCLConfig, RaycastConfig

    return (MCLConfig(n_particles=RBPF_PARTICLES, meas_stddev=5.0,
                      scanner_offset=(0.0, 30.0, 0.0), resample="systematic"),
            RaycastConfig(step=0.5, max_dist=500.0, backend="march"),
            LidarConfig(start=0.0, stop=2 * math.pi, max_dist=500.0, n_rays=90))


def rbpf_start(blocked_np):
    """(the RBPF tool's start (x, y): the canvas center, or the nearest free
    cell when that is blocked; which of the two)."""
    from slam_tpu_torch.core import grid as gridlib

    h, w = blocked_np.shape
    ci, cj = gridlib.world_to_cell((h, w), torch.tensor(w / 2.0), torch.tensor(h / 2.0))
    ci, cj = int(ci), int(cj)
    if not blocked_np[ci, cj]:
        return (w / 2.0, h / 2.0), "the canvas center (free)"
    free = np.argwhere(~blocked_np)
    ci, cj = (int(v) for v in free[np.argmin((free[:, 0] - ci) ** 2 + (free[:, 1] - cj) ** 2)])
    return (float(cj) + 0.5, float(h - ci) - 1.5), "the nearest free cell"


def rbpf_phase(dev, blocked_np, counts) -> dict:
    """Phase 19: `tools/rbpf_fidelity.py:50-80` at full width (RBPF_PARTICLES
    maps of the floor plan, offset (0, 30, 0), step 0.5, max_dist 500, 90
    rays over 2 pi, systematic) along the deterministic wander (0.01, 2.5,
    0.01) from the canvas center (or the nearest free cell), RBPF_STEPS
    steps through `RBPF.step` (one CUDA graph replay a step; the first
    captures it); then one step at N = 8 on the card against the CPU's, with the
    card's K1 poses and u0 injected on the CPU: maps bit for bit, weights
    within a relative 1e-5, the same best_map_idx."""
    from slam_tpu_torch.core.types import Odometry, Pose
    from slam_tpu_torch.models import fake_lidar
    from slam_tpu_torch.models import rbpf
    from slam_tpu_torch.ops import mapping, motion_cuda
    from slam_tpu_torch.ops.measurement import sensor_pose
    from slam_tpu_torch.utils.metrics import ate_rmse

    reset_counts, read_counts = counts
    blocked = torch.from_numpy(blocked_np).to(dev)
    h, w = blocked_np.shape
    cfg, rc, lidar = rbpf_config()
    start_xy, where = rbpf_start(blocked_np)
    odom = Odometry.create(0.01, 2.5, 0.01)
    gt = [*start_xy, math.pi / 2]
    truths, scans = [], []
    for _ in range(RBPF_STEPS):
        th1 = gt[2] + 0.01
        gt = [gt[0] + 2.5 * math.cos(th1), gt[1] + 2.5 * math.sin(th1), th1 + 0.01]
        truths.append(gt[:2])
        scans.append(fake_lidar.scan(blocked, sensor_pose(Pose.create(*gt, device=dev),
                                                          cfg.scanner_offset), lidar, rc))
    engine = rbpf.RBPF(cfg, rc, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    st = engine.init(Pose.create(*start_xy, math.pi / 2), (h, w))
    reset_counts()
    est, step_ms = [], []
    for k in range(RBPF_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        st = no_sync(lambda: engine.step(st, odom, scans[k]))
        stop.record()
        step_ms.append((start, stop))
        mp = rbpf.mean_pose(st)
        est.append(torch.stack([mp.x, mp.y]))
    torch.cuda.synchronize()
    c = read_counts()
    # One K1 launch a step: a replay counts its capture's, and the capture's
    # warm-up (step 1) its own.
    warm = warmup_counts()
    want = RBPF_STEPS + warm["motion_odometry"]
    check(c["motion_odometry"] == want, f"RBPF K1 launches {c} != {want}")
    # One launch of each fidelity kernel a chunk of a step, the same way.
    chunks = len(mapping._fidelity_spans(RBPF_PARTICLES, lidar.n_rays,
                                         int(math.ceil(rc.max_dist / rc.step))))
    for k_ in ("rbpf_march", "rbpf_write"):
        check(warm[k_] == chunks and c[k_] == chunks * RBPF_STEPS + warm[k_],
              f"RBPF {k_} launches {c[k_]} (warm-up {warm[k_]}) != {chunks} a step over "
              f"{RBPF_STEPS} steps and the warm-up's")
    peak = torch.cuda.max_memory_allocated(dev)
    ms = [a.elapsed_time(b) for a, b in step_ms]
    est_np = torch.stack(est).cpu().numpy().astype(np.float64)
    ate = ate_rmse(est_np, np.array(truths))
    check(np.isfinite(est_np).all() and ate < RBPF_ATE_PX, f"RBPF ATE {ate} px >= {RBPF_ATE_PX}")
    pf = rbpf.best_map_prob_free(st)
    check(float(pf.min()) < 0.3 and float(pf.max()) > 0.7, "RBPF best map learned nothing")
    box = [st, 0]

    def advance():
        box[0] = engine.step(box[0], odom, scans[box[1] % RBPF_STEPS])
        box[1] += 1

    out = {"particles": RBPF_PARTICLES, "maps_mb": RBPF_PARTICLES * h * w / 1e6, "start": where,
           "start_xy": list(start_xy), "steps": RBPF_STEPS, "ate_px": ate,
           "ms_per_step": spread(ms[2:]), "first_steps_ms": ms[:2],
           "peak_memory_gb": peak / 1e9, **step_profile(advance, iters=3), "launches": c,
           "graphs": engine.graphs.stats()}
    say("rbpf", json.dumps(out))

    # One step at N = 8: the card against the CPU.
    small = dataclasses.replace(cfg, n_particles=8)
    s8 = rbpf.init(11, 8, Pose.create(*start_xy, math.pi / 2, device=dev), (h, w))
    for k in range(2):  # maps with some structure first
        s8 = rbpf.step(s8, odom, scans[k], small, rc)
    g_before = clone_generator(s8.generator)
    u0 = torch.tensor(0.37, device=dev)
    card = rbpf.step(s8, odom, scans[2], small, rc, u0=u0)
    moved = motion_cuda.launch(motion_cuda.draw_seed(g_before, dev), odom, s8.particles.pose,
                               rbpf.ALPHAS)
    cpu_state = s8.replace(particles=s8.particles.to("cpu"), maps=s8.maps.cpu(),
                           best_pose=s8.best_pose.to("cpu"), best_map_idx=s8.best_map_idx.cpu(),
                           generator=torch.Generator())
    cpu = rbpf.update(cpu_state, moved.to("cpu"), scans[2].to("cpu"), small, rc, u0=u0.cpu())
    lw_card, maps_card = mapping.fidelity_measurement_and_mapping(
        s8.maps, moved, scans[2], scanner_offset=small.scanner_offset, stddev=5.0, eps=0.1,
        max_dist=500.0, step=0.5)
    lw_cpu, maps_cpu = mapping.fidelity_measurement_and_mapping(
        s8.maps.cpu(), moved.to("cpu"), scans[2].to("cpu"), scanner_offset=small.scanner_offset,
        stddev=5.0, eps=0.1, max_dist=500.0, step=0.5)
    check(torch.equal(maps_card.cpu(), maps_cpu), "RBPF fidelity maps: card != CPU")
    rel = float(((lw_card.cpu() - lw_cpu).abs() / lw_cpu.abs()).max())
    check(rel <= 1e-5, f"RBPF fidelity weights: card vs CPU relative {rel} > 1e-5")
    check(torch.equal(card.maps.cpu(), cpu.maps), "RBPF step maps: card != CPU")
    check(int(card.best_map_idx) == int(cpu.best_map_idx), "RBPF best_map_idx: card != CPU")
    out["n8_card_vs_cpu"] = {"maps_equal": True, "weights_max_rel": rel,
                             "best_map_idx": int(card.best_map_idx),
                             "changed_cells": int((maps_card != s8.maps).sum())}
    return out


def maze_phase(dev, counts) -> dict:
    """Phase 20: the maze through the compressed ray table and the dense
    one, driven by `slam_tpu_torch/tools/maze_bench.py`. The procedural
    maze of MAZE_SIZE px: the CDDT built on the card equal bit for bit to
    the port's CPU build (K > 64 there: the binary-search branch); the
    dense u8 table beside it; CDDT queries against the dense table's on
    MAZE_RAYS random rays; the tool's 10k-particle MCL step through both
    tables (ms, device ms, launches, busy share) and its 60-step ATE; on
    the u8 table the fused kernel on the step's cloud against its plain
    version (poses == K1's, weights within phase 6's tolerance). Then
    the tool's beyond-memory demo (BIG_SIZE px, pitch BIG_PITCH) through
    the CDDT alone (K <= 64: the masked-min branch)."""
    from slam_tpu_torch.core.config import RaycastConfig
    from slam_tpu_torch.core.types import Odometry, Pose
    from slam_tpu_torch.models import fake_lidar
    from slam_tpu_torch.models import mcl as mcl_mod
    from slam_tpu_torch.ops import cddt as cddtlib
    from slam_tpu_torch.ops import lut as lutlib
    from slam_tpu_torch.ops import lut_weights_cuda, measurement, motion, motion_cuda
    from slam_tpu_torch.tools import maze_bench as mb

    reset_counts, read_counts = counts
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    out = {}

    def mcl_run(blocked_np, field, backend, start):
        """The tool's timed step and ATE run, their launches and a profile
        of one step."""
        torch.cuda.synchronize()
        reset_counts()
        ms, st = mb.step_ms(blocked_np, field, backend, start, MAZE_PARTICLES, iters=20,
                            device=dev)
        ate = mb.localization_ate(blocked_np, field, backend, start, MAZE_PARTICLES,
                                  steps=MAZE_STEPS, device=dev)
        c, warm = read_counts(), warmup_counts()
        for k_ in launches:
            launches[k_] += c[k_]
        lidar, rc, cfg = mb.configs(backend, MAZE_PARTICLES)
        pose = st.particles.pose
        scan = fake_lidar.scan(field.blocked, Pose.create(*start, device=dev), lidar,
                               RaycastConfig(max_dist=500.0))
        box = [st]
        odom = Odometry.create(0.05, 1.0, 0.05)
        held = {}
        if backend == "lut":
            sd = torch.tensor([17], dtype=torch.int64, device=dev)
            held = hold_fused_to_plain(field.lut, pose, scan, cfg, rc.max_dist, sd, odom,
                                       mb.ALPHAS, f"maze {MAZE_SIZE} u8")
            motion_args = (sd, motion_cuda.odometry_rows(odom, dev), mb.ALPHAS)
            wkw = dict(beam_stride=cfg.lut_beam_stride,
                       displacement=measurement.scanner_displacement(cfg.scanner_offset),
                       max_dist=rc.max_dist, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon)
            held["ms"] = device_ms(lambda: lut_weights_cuda.launch(
                field.lut, field.lut.shape[-1], pose, scan, motion=motion_args, **wkw))[0]
            gp = mcl_mod.make_generator(18, dev)
            held["plain_ms"] = device_ms(lambda: plain_lut_weights(
                field.lut, motion.sample_motion_model_odometry(odom, pose, mb.ALPHAS,
                                                               generator=gp),
                scan, cfg, rc.max_dist))[0]
            n_beams = scan.angles.shape[0]
            mb_bound = bound(MAZE_PARTICLES * (12 + 12 + 4) + held["distinct_cells"] * n_beams
                             + n_beams * 8 + 8,
                             MAZE_PARTICLES * (OPS_SAMPLE + OPS_LOCATE + n_beams * OPS_BEAM))
            held.update(bound_ms=mb_bound[0], bound_by=mb_bound[1],
                        bound_share=mb_bound[0] / held["ms"])
            say("maze", f"lut_weights on the u8 table, {MAZE_PARTICLES} particles: poses == "
                f"K1's bit for bit; {json.dumps(held)}")

        def advance():
            box[0] = mcl_mod.step(box[0], odom, mb.ALPHAS, scan, field, cfg, rc)

        prof = step_profile(advance, iters=5, warmup=1)
        check(bool(torch.isfinite(pose.x).all()), f"maze {backend}: non-finite poses")
        check(ate < MAZE_ATE_PX, f"maze {backend}: ATE {ate} px >= {MAZE_ATE_PX}")
        return {"ms_per_step": ms, "ate_px": ate, "launches": c, "warm_ups": warm, **prof,
                **({"lut_weights_vs_plain": held} if held else {})}

    # The MAZE_SIZE maze: CDDT on the card and on the CPU, dense u8 beside.
    maze = mb.procedural_maze(MAZE_SIZE, MAZE_PITCH)
    h, w = maze.shape
    start = (*mb.find_start(maze, dev), 0.9)
    field_c, cddt_s, desc = mb.build_field(maze, "cddt", device=dev)
    tab = field_c.cddt
    check(tab.n_overflow == 0, "maze cddt dropped runs")
    t0 = time.perf_counter()
    cpu_tab = cddtlib.build_cddt(torch.from_numpy(maze), 360, k=tab.k)
    cpu_s = time.perf_counter() - t0
    differ = int((cpu_tab.starts != tab.starts.cpu()).sum() + (cpu_tab.ends != tab.ends.cpu()).sum())
    say("maze", f"{desc} built in {cddt_s:.2f} s on the card; the CPU's build at K={tab.k} "
        f"took {cpu_s:.1f} s; {differ} entries differ")
    check(cpu_tab.n_overflow == 0 and differ == 0, "maze cddt: the card's table != the CPU's")
    field_l, lut_s, lut_desc = mb.build_field(maze, "lut", device=dev)
    out["maze"] = {"size": MAZE_SIZE, "pitch": MAZE_PITCH, "d": tab.d, "k": tab.k,
                   "branch": "binary search" if tab.k > 64 else "masked min",
                   "cddt_mib": tab.nbytes / 2**20, "cddt_build_s": cddt_s,
                   "cpu_build_s_at_k": cpu_s, "card_equals_cpu": True,
                   "dense_u8_gb": field_l.lut.numel() / 1e9, "dense_build_s": lut_s}
    say("maze", f"the card's table == the CPU's bit for bit; {lut_desc} built in "
        f"{lut_s:.2f} s")

    # CDDT queries against the dense u8 table's: the dense value is the
    # CDDT distance encoded to its u8 code and decoded, except where an
    # angle tie puts the ray in another canvas row.
    g = mcl_mod.make_generator(20, dev)
    x = torch.rand(MAZE_RAYS, generator=g, device=dev) * w
    y = torch.rand(MAZE_RAYS, generator=g, device=dev) * h
    th = (torch.rand(MAZE_RAYS, generator=g, device=dev) * 2 - 1) * math.pi
    dc, hc = cddtlib.raycast_cddt(tab, x, y, th, max_dist=500.0, shape=(h, w))
    dl, hl = lutlib.raycast_lut(field_l.lut, x, y, th, max_dist=500.0)
    q = torch.tensor(np.float32(500.0 * 1.25) * (np.float32(1.0) / np.float32(255.0)),
                     device=dev)
    enc = lutlib.dequantize(torch.clamp(torch.floor(dc / q), 0.0, 255.0), torch.uint8, 500.0)
    agree = (hc == hl) & (~hc | (dl == enc))
    share = float(agree.float().mean())
    # The query's own trig: each ray's bin angle takes its sin and cos on
    # the device; the same rays through the CPU's table on the CPU.
    dcc, hcc = cddtlib.raycast_cddt(cpu_tab, x.cpu(), y.cpu(), th.cpu(), max_dist=500.0,
                                    shape=(h, w))
    q_differ = int(((dcc.view(torch.int32) != dc.cpu().view(torch.int32))
                    | (hcc != hc.cpu())).sum())
    out["maze"]["queries"] = {"rays": MAZE_RAYS, "agree_share": share,
                              "ties": int((~agree).sum()), "cddt_hit_share": float(hc.float().mean()),
                              "card_vs_cpu_differ": q_differ}
    check(share >= CDDT_AGREE, f"maze cddt vs dense u8 queries: {share} agree < {CDDT_AGREE}")
    say("maze", f"{MAZE_RAYS} random rays, CDDT vs the dense u8 table: {share:.6f} agree "
        f"({int((~agree).sum())} angle ties); the card's CDDT queries against the CPU's on "
        f"the same rays and table: {q_differ} differ")

    for backend, field in (("lut", field_l), ("cddt", field_c)):
        out["maze"][backend] = mcl_run(maze, field, backend, start)
        say("maze", f"{backend}: {json.dumps(out['maze'][backend])}")
    # The lut route: the timed steps are fused launches; the ATE run's
    # predict -> update is K1 then the weigh-only kernel. The cddt route:
    # K1, then the queries in plain torch.
    c_lut, c_cddt = out["maze"]["lut"]["launches"], out["maze"]["cddt"]["launches"]
    w_lut, w_cddt = out["maze"]["lut"]["warm_ups"], out["maze"]["cddt"]["warm_ups"]
    check(c_lut["lut_weights"] == 23 + MAZE_STEPS + w_lut["lut_weights"]
          and c_lut["motion_odometry"] == MAZE_STEPS, f"maze lut route launches {c_lut}")
    check(c_cddt["motion_odometry"] == 23 + MAZE_STEPS + w_cddt["motion_odometry"]
          and c_cddt["lut_weights"] == 0, f"maze cddt route launches {c_cddt}")
    # Phase 25 steps the 10k filter through both tables again.
    out["graph_inputs"] = {"fields": {"lut": field_l, "cddt": field_c}, "start": start}
    del field_l, field_c
    torch.cuda.empty_cache()

    # The beyond-memory demo through the CDDT alone.
    big = mb.procedural_maze(BIG_SIZE, BIG_PITCH)
    start_b = (*mb.find_start(big, dev), 0.9)
    field_b, big_s, big_desc = mb.build_field(big, "cddt", device=dev)
    tb = field_b.cddt
    dense_gb = BIG_SIZE * BIG_SIZE * 360 / 1e9
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9  # decimal GB
    out["big"] = {"size": BIG_SIZE, "pitch": BIG_PITCH, "d": tb.d, "k": tb.k,
                  "branch": "binary search" if tb.k > 64 else "masked min",
                  "cddt_mib": tb.nbytes / 2**20, "cddt_build_s": big_s,
                  "dense_u8_gb_avoided": dense_gb, "card_gb": card_gb,
                  "dense_would_fit": dense_gb < card_gb,
                  "cddt": mcl_run(big, field_b, "cddt", start_b)}
    say("maze", f"beyond-memory demo {BIG_SIZE} px: {big_desc} built in {big_s:.2f} s, "
        f"against {dense_gb:.1f} GB of dense u8 table, which "
        f"{'would fit' if dense_gb < card_gb else 'would not fit'} on this {card_gb:.1f} GB "
        f"card; {json.dumps(out['big']['cddt'])}")
    branches = {out["maze"]["branch"], out["big"]["branch"]}
    check(branches == {"binary search", "masked min"},
          f"the two maps took branches {branches}: both must run")
    out["launches"] = launches
    return out


def fleet_phase(dev, blocked_np, field, counts, map_png, workdir) -> dict:
    """Phase 21: the fleet through one launch of the fused kernel a step
    (`models/fleet.py`), at `slam_tpu_torch/tools/fleet_bench.py`'s
    configuration on the floor plan's bf16 LUT: the kernel with the robot
    axis at R = 1 and each robot's slice at R = 4 == a one-robot launch with
    that robot's seed, odometry and scan, bit for bit; two fleet steps at R
    = 1 against mcl.step and three at R = 4 and FLEET_CHECK_R against as
    many independent filters, and the batched resampler's indices against
    the 1-D one's, all bit for bit; the bench at R in FLEET_ROBOTS (ms,
    device ms, launches, busy share); the kernel at R x N = 1.6M against
    its plain version (poses == K1's, weights within phase 6's tolerance)
    and beside its bound; the fleet's other route, on the likelihood field
    (one K1 launch with a robot axis a step): FLEET_CHECK_R x 100k for three
    steps == as many independent filters bit for bit, one K1 launch a step,
    K1 at 16 x 100k timed beside its bound; the fleet_localization app at
    its defaults on the plan's PNG."""
    import contextlib
    import io
    import re

    from slam_tpu_torch.apps import fleet_localization
    from slam_tpu_torch.core.types import Odometry, Pose, Scan
    from slam_tpu_torch.models import fleet
    from slam_tpu_torch.models import mcl as mcl_mod
    from slam_tpu_torch.ops import lut_weights_cuda, measurement, motion, motion_cuda
    from slam_tpu_torch.ops import resample as resample_mod
    from slam_tpu_torch.tools import fleet_bench as fb

    def bits_equal(a, b) -> bool:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    reset_counts, read_counts = counts
    fused = lut_weights_cuda.launch
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    blocked = torch.from_numpy(blocked_np).to(dev)
    n = FLEET_N
    lidar, rc, cfg = fb.configs(n)
    alphas = fb.ALPHAS
    out = {"particles": n, "lut_mb": field.lut.numel() * field.lut.element_size() / 1e6}
    wkw = dict(beam_stride=cfg.lut_beam_stride,
               displacement=measurement.scanner_displacement(cfg.scanner_offset),
               max_dist=rc.max_dist, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon)

    def share_differing(a, b) -> dict:
        """Per field, the share of particles whose bits differ between two
        single-filter states."""
        pa, pb = a.particles, b.particles
        return {f: float((u.view(torch.int32) != v.view(torch.int32)).float().mean())
                for f, u, v in (("x", pa.pose.x, pb.pose.x), ("y", pa.pose.y, pb.pose.y),
                                ("theta", pa.pose.theta, pb.pose.theta),
                                ("log_weight", pa.log_weight, pb.log_weight))}

    def robot_scan(scans, q):
        return Scan(angles=scans.angles[q], dists=scans.dists[q])

    rng = np.random.default_rng(21)
    odom0 = Odometry.create(*fb.ODOM)

    def host_odom(odoms, q):
        return Odometry.create(float(odoms.rot1[q]), float(odoms.trans[q]),
                               float(odoms.rot2[q]))

    # The kernel with the robot axis: at R = 1 and, per robot, at R = 4,
    # equal bit for bit to a one-robot launch with that robot's seed,
    # odometry and scan.
    poses4, odoms4, scans4 = fb.fleet_inputs(blocked, 4, lidar, cfg, rng)
    cloud = fleet.fleet_step(fleet.init_fleet(FLEET_SEED, 4, n, poses4), odoms4, scans4,
                             field, alphas, cfg, rc).particles.pose
    odo4 = Odometry.create([0.02, 0.3, -0.1, 0.0], [2.5, 1.0, 3.0, 0.5], [0.02, -0.2, 0.1, 0.0])
    seeds4 = torch.tensor([5, 6, 7, 8], dtype=torch.int64, device=dev)
    for r in (1, 4):
        sub = Pose(x=cloud.x[:r].contiguous(), y=cloud.y[:r].contiguous(),
                   theta=cloud.theta[:r].contiguous())
        sub_scans = Scan(angles=scans4.angles[:r].contiguous(), dists=scans4.dists[:r].contiguous())
        sub_odo = Odometry(rot1=odo4.rot1[:r], trans=odo4.trans[:r], rot2=odo4.rot2[:r])
        pk, lwk = fused(field.lut, 360, sub, sub_scans, motion=(
            seeds4[:r], motion_cuda.odometry_rows(sub_odo, dev), alphas), **wkw)
        for q in range(r):
            oq = motion_cuda.odometry_rows(host_odom(odo4, q), dev)
            p1, lw1 = fused(field.lut, 360, fleet._row(sub, q), robot_scan(sub_scans, q),
                            motion=(seeds4[q:q + 1], oq, alphas), **wkw)
            check(all(bits_equal(getattr(pk, f)[q], getattr(p1, f)) for f in ("x", "y", "theta"))
                  and bits_equal(lwk[q], lw1),
                  f"fleet kernel at R={r}: robot {q} != its one-robot launch")
    out["kernel_r1_r4_equal_one_robot_launches"] = True

    # Whole steps on the same generators: a fleet of 1 against mcl.step
    # (two steps), and fleets of 4 and 16 against as many independent
    # filters (three steps): poses, weights and the batched resampler's
    # indices, all equal bit for bit (the resampler's f64 prefix sum).
    fs1 = fleet.init_fleet(FLEET_SEED, 1, n,
                           Pose(x=poses4.x[:1], y=poses4.y[:1], theta=poses4.theta[:1]))
    ss = mcl_mod.init(mcl_mod.make_generator(fleet.fleet_seeds(FLEET_SEED, 1)[0], dev), n,
                      fleet._row(poses4, 0))
    sc1 = Scan(angles=scans4.angles[:1], dists=scans4.dists[:1])
    od1 = Odometry(rot1=odoms4.rot1[:1], trans=odoms4.trans[:1], rot2=odoms4.rot2[:1])
    for _ in range(2):
        fs1 = fleet.fleet_step(fs1, od1, sc1, field, alphas, cfg, rc)
        ss = mcl_mod.step(ss, odom0, alphas, robot_scan(scans4, 0), field, cfg, rc)
    vs = {"r1_two_steps_vs_mcl_step": share_differing(fleet.robot(fs1, 0), ss)}
    idx_share = {}
    for r, (pr, odr, scr) in ((4, (poses4, odoms4, scans4)),
                              (FLEET_CHECK_R, fb.fleet_inputs(blocked, FLEET_CHECK_R, lidar,
                                                              cfg, rng))):
        fs = fleet.init_fleet(FLEET_SEED, r, n, pr)
        singles = [mcl_mod.init(mcl_mod.make_generator(s, dev), n, fleet._row(pr, q))
                   for q, s in enumerate(fleet.fleet_seeds(FLEET_SEED, r))]
        for _ in range(3):
            fs = fleet.fleet_step(fs, odr, scr, field, alphas, cfg, rc)
            singles = [mcl_mod.step(s, host_odom(odr, q), alphas, robot_scan(scr, q), field,
                                    cfg, rc) for q, s in enumerate(singles)]
        vs[f"r{r}_three_steps_vs_{r}_filters"] = [
            share_differing(fleet.robot(fs, q), s) for q, s in enumerate(singles)]
        _, lw_r = fused(field.lut, 360, fs.particles.pose, scr, **wkw)
        u0 = torch.rand(r, generator=mcl_mod.make_generator(4, dev), device=dev)
        idx_b = resample_mod.systematic_indices(lw_r, u0=u0)
        idx_1 = torch.stack([resample_mod.systematic_indices(lw_r[q], u0=u0[q])
                             for q in range(r)])
        idx_share[r] = float((idx_b != idx_1).float().mean())
        del fs, singles
    worst = max(max(d.values()) for v in vs.values() for d in (v if isinstance(v, list) else [v]))
    out["fleet_vs_independent"] = {**vs, "resample_index_differing_share": idx_share,
                                   "worst_differing_share": worst}
    say("fleet", f"the kernel at R=1 and R=4 == one-robot launches bit for bit; "
        f"{json.dumps(out['fleet_vs_independent'])}")
    check(max(idx_share.values()) == 0.0,
          f"batched vs 1-D resampler indices differ: {idx_share}")
    check(worst == 0.0, f"fleet vs independent filters differ on {worst} of particles")

    # The route without the fused kernel (the direct likelihood field): one
    # K1 launch a step for every robot (4 particles a thread, 16 B rows),
    # against independent filters, whose K1 launches take one particle a
    # thread, bit for bit.
    from slam_tpu_torch.ops import edt as edtlib
    from slam_tpu_torch.ops.rayfield import RayField

    lf_cfg = dataclasses.replace(cfg, measurement="likelihood_field")
    lf = RayField(blocked=blocked, edt=edtlib.edt_capped(blocked, 5.0 * cfg.meas_stddev + 2.0))
    r = FLEET_CHECK_R
    pr, odr, scr = fb.fleet_inputs(blocked, r, lidar, cfg, rng)
    fs = fleet.init_fleet(FLEET_SEED, r, n, pr)
    singles = [mcl_mod.init(mcl_mod.make_generator(s_, dev), n, fleet._row(pr, q))
               for q, s_ in enumerate(fleet.fleet_seeds(FLEET_SEED, r))]
    steps_k1 = []
    for _ in range(3):
        reset_counts()
        fs = fleet.fleet_step(fs, odr, scr, lf, alphas, lf_cfg, rc)
        steps_k1.append(read_counts()["motion_odometry"])
        launches["motion_odometry"] += steps_k1[-1]
        singles = [mcl_mod.step(s_, host_odom(odr, q), alphas, robot_scan(scr, q), lf, lf_cfg, rc)
                   for q, s_ in enumerate(singles)]
    lf_vs = [share_differing(fleet.robot(fs, q), s_) for q, s_ in enumerate(singles)]
    lf_worst = max(max(d.values()) for d in lf_vs)
    cloud = fs.particles.pose
    seeds = torch.arange(r, dtype=torch.int64, device=dev) + 200
    k1_ms = own_kernel_ms(lambda: motion_cuda.launch(seeds, odr, cloud, alphas),
                          "motion_odometry_kernel")
    k1_bound = bound(r * n * 24, r * n * OPS_SAMPLE)
    out["k1_fleet"] = {"robots": r, "particles_total": r * n, "k1_launches_per_step": steps_k1,
                       "vs_independent_worst_differing_share": lf_worst, "ms": k1_ms,
                       "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
                       "bound_share": k1_bound[0] / k1_ms}
    say("fleet", f"likelihood-field route, {r} x {n}: {json.dumps(out['k1_fleet'])}")
    check(steps_k1 == [1, 1, 1], f"the fleet's K1 launches a step: {steps_k1} (one each)")
    check(lf_worst == 0.0, f"likelihood-field fleet vs independent filters differ on "
          f"{lf_worst} of particles")
    del fs, singles, cloud

    # The bench at R in FLEET_ROBOTS: one lut_weights launch a fleet step.
    out["bench"] = {}
    for r in FLEET_ROBOTS:
        poses, odoms, scans = fb.fleet_inputs(blocked, r, lidar, cfg, rng)
        fl = fleet.MCLFleet(r, cfg, rc, seed=0, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        ms, states = fb.time_fleet(fl, field, poses, odoms, scans, FLEET_ITERS)
        c = read_counts()
        steps = FLEET_ITERS + 3
        w = warmup_counts()  # MCLFleet.step replays a graph: one block, one warm-up
        check(c == {"gather_rows": 0, "motion_odometry": 0,
                    "lut_weights": steps + w["lut_weights"], "resample": steps + w["resample"],
                    "estimate": steps + w["estimate"], "rbpf_march": 0, "rbpf_write": 0}
              and w["lut_weights"] == 1 and w["resample"] == 1 and w["estimate"] == 1,
              f"fleet R={r}: launches {c} for {steps} fleet steps (warm-ups {w})")
        for k_ in launches:
            launches[k_] += c[k_]
        box = [states]

        def advance():
            box[0] = fl.step(box[0], odoms, scans, field, alphas)

        prof = step_profile(advance, iters=5, warmup=1)
        out["bench"][r] = {"metric": f"fleet_mcl_step_ms_r{r}", "ms_per_step": ms,
                           "particles_total": r * n, **prof}
        say("fleet", json.dumps(out["bench"][r]))

    # The kernel at R x N = max(FLEET_ROBOTS) x N, as the fleet step
    # launches it, against its plain version: robot q's poses == K1's with
    # seed q and its odometry bit for bit, its weights within a relative
    # LW_RTOL of the plain LUT weights of those poses (phase 6's
    # tolerance), the same best particle; timed beside its bound.
    r = max(FLEET_ROBOTS)
    poses, odoms, scans = fb.fleet_inputs(blocked, r, lidar, cfg, rng)
    st = fleet.fleet_step(fleet.init_fleet(1, r, n, poses), odoms, scans, field, alphas, cfg, rc)
    cloud = st.particles.pose
    seeds = torch.arange(r, dtype=torch.int64, device=dev) + 100
    motion_args = (seeds, motion_cuda.odometry_rows(odoms, dev), alphas)
    pk, lwk = fused(field.lut, 360, cloud, scans, motion=motion_args, **wkw)
    outside, max_diff, pidxs = 0, 0.0, []
    for q in range(r):
        p1 = motion_cuda.launch(seeds[q:q + 1], host_odom(odoms, q), fleet._row(cloud, q), alphas)
        check(all(bits_equal(getattr(pk, f)[q], getattr(p1, f)) for f in ("x", "y", "theta")),
              f"fleet kernel at R={r}: robot {q}'s poses != K1's")
        pidx, lwp = plain_lut_weights(field.lut, p1, robot_scan(scans, q), cfg, rc.max_dist)
        diff = (lwk[q] - lwp).abs()
        outside += int((diff > LW_RTOL * lwp.abs()).sum())
        max_diff = max(max_diff, float(diff.max()))
        pidxs.append(pidx)
        check(bool(torch.isfinite(lwk[q]).all()), f"fleet kernel at R={r}: robot {q} non-finite")
        check(int(torch.argmax(lwk[q])) == int(torch.argmax(lwp)),
              f"fleet kernel at R={r}: robot {q}'s best particle differs from plain")
    share = 1.0 - outside / (r * n)
    check(share >= LW_SHARE, f"fleet kernel at R={r}: {share} within {LW_RTOL} < {LW_SHARE}")
    n_beams = scans.angles.shape[-1]
    cells = int(torch.unique(torch.cat(pidxs)).numel())  # the robots share the table
    kb = bound(r * n * (12 + 12 + 4) + cells * n_beams * 2 + r * (n_beams * 8 + 8 + 24),
               r * n * (OPS_SAMPLE + OPS_LOCATE + n_beams * OPS_BEAM))
    # CUDA events around back-to-back launches: the kernel (~0.5 ms) far
    # outlasts the host's enqueue, so this is its device time.
    k_ms = cuda_ms(lambda: fused(field.lut, 360, cloud, scans, motion=motion_args, **wkw))
    gp = mcl_mod.make_generator(3, dev)
    odoms_q = [host_odom(odoms, q) for q in range(r)]

    def plain_fleet():
        """The plain version, looped over robots: the plain sampler, then
        the plain LUT weights."""
        for q in range(r):
            pq = motion.sample_motion_model_odometry(odoms_q[q], fleet._row(cloud, q), alphas,
                                                     generator=gp)
            plain_lut_weights(field.lut, pq, robot_scan(scans, q), cfg, rc.max_dist)

    plain_ms = device_ms(plain_fleet, iters=3, warmup=1)[0]
    out["kernel_fleet"] = {"robots": r, "particles_total": r * n, "distinct_cells": cells,
                           "within_rtol_share": share, "outside": outside,
                           "max_abs_diff": max_diff, "ms": k_ms, "plain_ms": plain_ms,
                           "bound_ms": kb[0], "bound_by": kb[1], "bound_share": kb[0] / k_ms}
    say("fleet", f"lut_weights at R x N = {r} x {n}: poses == K1's bit for bit per robot; "
        f"{json.dumps(out['kernel_fleet'])}")
    # The same launch on adversarial clouds of RAGGED_N particles a robot.
    out["kernel_fleet_adversarial"] = hold_adversarial(field.lut, scans, cfg, rc.max_dist, r,
                                                       f"fleet R={r} adversarial", 41)
    say("fleet", f"lut_weights at R x N = {r} x {RAGGED_N}, adversarial clouds: poses == K1's "
        f"bit for bit per robot; {json.dumps(out['kernel_fleet_adversarial'])}")

    # The fleet_localization app at its defaults on the plan's PNG.
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mean_ate = fleet_localization.main(["--map", map_png, "--out",
                                            f"{workdir}/fleet.png"])
    app_s = time.perf_counter() - t0
    c = read_counts()
    for k_ in launches:
        launches[k_] += c[k_]
    ates = [float(a) for a in re.findall(r"robot \d+: ATE ([0-9.]+)px", buf.getvalue())]
    out["fleet_localization"] = {"robots": len(ates), "ate_px": ates,
                                 "mean_ate_px": float(mean_ate),
                                 "seconds": app_s, "launches": c}
    check(len(ates) == 8 and mean_ate < FLEET_APP_ATE_PX,
          f"fleet_localization: ATEs {ates} (mean bound {FLEET_APP_ATE_PX} px)")
    w = warmup_counts()
    check(c["lut_weights"] == 100 + w["lut_weights"],
          f"fleet_localization launches {c} for 100 fleet steps + warm-ups {w}")
    say("fleet", f"fleet_localization (8 robots x 10k, 100 steps): {json.dumps(out['fleet_localization'])}")
    out["launches"] = launches
    return out


def apps_phase(dev, counts, map_png, workdir) -> dict:
    """Phase 22: the apps on the floor plan's PNG, as users run them:
    grid_slam at the README's quick start; a --checkpoint-dir run cut in
    two against an uninterrupted one (their last checkpoints bit for bit);
    slam_replan at its on-card configuration; the A*, HA*, RRT*,
    nearest-neighbour and regions apps once each, the planners' paths free
    of their inflated maps."""
    import contextlib
    import io
    import os

    from slam_tpu_torch.apps import (astar_planner, grid_slam, hastar_planner,
                                     nearest_neighbor, regions, rrt_planner, slam_replan)

    reset_counts, read_counts = counts
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    out = {}

    def run(fn, argv, **kw):
        """(return value, stdout, seconds, launches) of one app run."""
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            ret = fn(argv, **kw)
        secs = time.perf_counter() - t0
        c = read_counts()
        for k_ in launches:
            launches[k_] += c[k_]
        return ret, buf.getvalue(), secs, c

    gif = f"{workdir}/slam.gif"
    ate, _, secs, c = run(grid_slam.main, ["--map", map_png, "--particles", "1000", "--steps",
                                           "200", "--out", gif])
    out["grid_slam"] = {"particles": 1000, "steps": 200, "ate_px": ate, "seconds": secs,
                        "gif_bytes": os.path.getsize(gif), "launches": c}
    w = warmup_counts()
    check(ate < GRID_SLAM_ATE_PX and c["motion_odometry"] == 200 + w["motion_odometry"],
          f"grid_slam: ATE {ate} px (bound {GRID_SLAM_ATE_PX}), launches {c} (warm-ups {w})")
    say("apps", f"grid_slam quick start: {json.dumps(out['grid_slam'])}")

    # --checkpoint-dir: CKPT_STEPS steps in one run, and in two runs cut at
    # half; the last checkpoints of both must be equal bit for bit.
    common = ["--map", map_png, "--particles", "1000", "--checkpoint-every", "10",
              "--frame-every", "1000", "--out", f"{workdir}/ck.gif"]
    half = str(CKPT_STEPS // 2)
    run(grid_slam.main, common + ["--steps", str(CKPT_STEPS), "--checkpoint-dir", f"{workdir}/ckA"])
    run(grid_slam.main, common + ["--steps", half, "--checkpoint-dir", f"{workdir}/ckB"])
    _, resumed, _, _ = run(grid_slam.main, common + ["--steps", str(CKPT_STEPS),
                                                     "--checkpoint-dir", f"{workdir}/ckB"])
    check(f"resumed from step {int(half) - 1}" in resumed, "grid_slam did not resume")
    last = f"{CKPT_STEPS - 1}/state.pt"
    a = torch.load(f"{workdir}/ckA/{last}", weights_only=True)
    b = torch.load(f"{workdir}/ckB/{last}", weights_only=True)

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k_, v in tree.items():
                yield from leaves(v, path + (k_,))
        else:
            yield path, tree

    la, lb = dict(leaves(a)), dict(leaves(b))
    check(la.keys() == lb.keys(), "checkpoint layouts differ")
    diff = [p for p in la if (la[p].numpy().tobytes() != lb[p].numpy().tobytes()
                              if isinstance(la[p], torch.Tensor) else la[p] != lb[p])]
    out["checkpoint_resume"] = {"steps": CKPT_STEPS, "cut_at": int(half), "leaves": len(la),
                                "differing_leaves": ["/".join(p) for p in diff]}
    check(not diff, f"grid_slam resumed != uninterrupted: {diff}")
    say("apps", f"grid_slam --checkpoint-dir cut at step {half} of {CKPT_STEPS}: the last "
        f"checkpoint equals the uninterrupted run's bit for bit ({len(la)} leaves)")

    rc_, text, secs, c = run(slam_replan.main, ["--map", map_png, "--particles", "100000",
                                                "--replan-every", "10", "--n-rays", "90",
                                                "--out", f"{workdir}/replan.png"])
    rec = json.loads(text.strip().splitlines()[-1])
    out["slam_replan"] = {**rec, "seconds": secs, "launches": c}
    check(rec["steps"] > 0 and rec["n_replans"] >= 1, f"slam_replan: {rec}")
    say("apps", f"slam_replan (100k particles, replan every 10, 90 rays): {json.dumps(out['slam_replan'])}")

    h = 599
    (sx, sy), (gx, gy) = plan_poses(h)
    planners = (
        ("astar", astar_planner.main, ["--start", *map(str, PLAN_START_IJ), "--goal",
                                       *map(str, PLAN_GOAL_IJ), "--inflate", str(PLAN_INFLATE)]),
        ("hastar", hastar_planner.main, ["--start", str(sx), str(sy), "--goal", str(gx), str(gy)]),
        ("rrt", rrt_planner.main, ["--start", str(sx), str(sy), "--goal", str(gx), str(gy)]),
    )
    for name_, fn, extra in planners:
        res = {}
        ok, _, secs, _ = run(fn, ["--map", map_png, "--out", f"{workdir}/{name_}.png", *extra],
                             result=res)
        free = res["free"]
        if name_ == "rrt":  # world (x, y) nodes -> cells
            cells = [(int(math.floor(h - y - 1.0)), int(math.floor(x))) for x, y in res["path"]]
        else:
            cells = list(res["path"])
        blocked_cells = sum(not free[i, j] for i, j in cells)
        out[name_] = {"ok": bool(ok), "path_points": len(cells), "points_blocked": blocked_cells,
                      "seconds": secs}
        check(ok and cells and blocked_cells == 0, f"{name_} app: {out[name_]}")
        say("apps", f"{name_}: {json.dumps(out[name_])}")
    for name_, fn, argv in (("nearest_neighbor", nearest_neighbor.main, ["--check"]),
                            ("regions", regions.main, ["--check"])):
        _, text, secs, _ = run(fn, argv + ["--out", f"{workdir}/{name_}.png"])
        check("brute-force check OK" in text, f"{name_} app: {text}")
        out[name_] = {"checked": True, "seconds": secs}
    say("apps", f"nearest_neighbor and regions: brute-force checks OK "
        f"({out['nearest_neighbor']['seconds']:.2f} s, {out['regions']['seconds']:.2f} s)")
    out["launches"] = launches
    return out



def tools_phase(dev, counts) -> dict:
    """Phase 24: the port's `tools/rbpf_fidelity.py` and
    `benchmarks/maze_slam_bench.py` at their defaults (1000 RBPF maps of the
    synthetic floor plan x 120 steps; 10k-particle SLAM on the 1024 px
    fallback maze x 40 steps, likelihood field): their JSON lines, finite,
    with the launches of the kernels they ran."""
    import contextlib
    import io

    from slam_tpu_torch.tools import maze_slam_bench, rbpf_fidelity

    reset_counts, read_counts = counts
    out = {}
    for name_, fn, argv in (("rbpf_fidelity", rbpf_fidelity.main, ["--json"]),
                            ("maze_slam_bench", maze_slam_bench.main, [])):
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fn(argv)
        secs = time.perf_counter() - t0
        recs = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
        check(recs and all(math.isfinite(v) for r in recs for v in r.values()
                           if isinstance(v, (int, float))), f"{name_}: {buf.getvalue()[-500:]}")
        out[name_] = {"json": recs, "seconds": secs, "launches": read_counts()}
        say("tools", f"{name_}: {json.dumps(out[name_])}")
    out["launches"] = {k: out["rbpf_fidelity"]["launches"][k]
                       + out["maze_slam_bench"]["launches"][k]
                       for k in out["rbpf_fidelity"]["launches"]}
    return out


# ---------------------------------------------------------------------------
# 23. parallel/ on torch.distributed
# ---------------------------------------------------------------------------
# World sizes of the D-rank checks; they share the one card (gloo), so
# their times measure sharing, not multi-GPU scaling.
PAR_WORLDS = (2, 4)
# Wall clock of one world, its kernel loads and map builds included;
# ranks left then are killed.
PAR_WORLD_LIMIT_S = 240.0
PAR_SLAM_STEPS = 8
# The systematic resampler's bin-edge bound: the share of slots whose
# source may differ when the prefix sum's summation order changes.
PAR_RESAMPLE_SHARE = 1e-3
# Cloud estimates over the sharded axis: relative to max(1, |value|).
PAR_EST_RTOL = 1e-5
PAR_FLEET = (16, 100_000)
PAR_MAZE_PARTICLES = 10_000
# Phase 23(a)'s graph and eager routes of each engine: steps a timed turn
# (two turns a way) and steps profiled a way.
PAR_ROUTE_ITERS = 10
PAR_ROUTE_PROFILE = 3


def par_close(a, b, rtol=PAR_EST_RTOL) -> float:
    """Largest |a - b| / max(1, |b|) over the fields of two poses."""
    return max(abs(float(getattr(a, f)) - float(getattr(b, f))) / max(1.0, abs(float(getattr(b, f))))
               for f in ("x", "y", "theta"))


def par_mcl_setup(dev):
    """Phase 6's bench configuration at 1M particles on the floor plan's
    LUT: (blocked, field, rc, cfg, scan, start pose, odometry, alphas)."""
    from slam_tpu_torch.core.config import LidarConfig, MCLConfig, RaycastConfig
    from slam_tpu_torch.core.types import Odometry, Pose
    from slam_tpu_torch.models import fake_lidar
    from slam_tpu_torch.ops import measurement, rayfield
    from slam_tpu_torch.utils.maps import synthetic_floor_plan

    blocked = torch.from_numpy(synthetic_floor_plan()).to(dev)
    lidar = LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="lut")
    field = rayfield.make_ray_field(blocked, rc)
    cfg = MCLConfig(n_particles=SLAM_PARTICLES, meas_stddev=5.0,
                    scanner_offset=(0.0, 30.0, 0.0), lut_beam_stride=2)
    pose0 = Pose.create(400.0, 400.0, math.pi, device=dev)
    scan = fake_lidar.scan(blocked, measurement.sensor_pose(pose0, cfg.scanner_offset), lidar,
                           RaycastConfig(max_dist=500.0))
    return (blocked, field, rc, cfg, scan, pose0, Odometry.create(2.5, 0.02, 0.02),
            (0.0005, 0.0005, 0.01, 0.01))


def par_slam_setup(dev, blocked):
    """Phase 9's 1M SLAM configuration (shard_bench's): (cfg, odometry,
    the two alternating scans, start pose)."""
    from slam_tpu_torch.core.types import Odometry, Pose
    from slam_tpu_torch.models import fake_lidar
    from slam_tpu_torch.ops import measurement

    cfg = slam_config()
    scans = [fake_lidar.scan(blocked, measurement.sensor_pose(p, cfg.mcl.scanner_offset),
                             cfg.lidar, cfg.raycast)
             for p in (Pose.create(400.0, 400.0, math.pi, device=dev),
                       Pose.create(403.0, 403.0, math.pi + 0.05, device=dev))]
    return cfg, Odometry.create(0.02, 2.5, 0.02), scans, Pose.create(400.0, 400.0, math.pi,
                                                                    device=dev)


def par_timed(fn, iters: int) -> float:
    """ms per call of `fn` over `iters` calls, between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def par_equal_states(a, b) -> bool:
    """Bit-for-bit equality of two MCL / SLAM states' tensors."""
    ma, mb = getattr(a, "mcl", a), getattr(b, "mcl", b)
    pairs = [(ma.particles.pose.x, mb.particles.pose.x), (ma.particles.pose.y, mb.particles.pose.y),
             (ma.particles.pose.theta, mb.particles.pose.theta),
             (ma.particles.log_weight, mb.particles.log_weight)]
    for f in ("x", "y", "theta"):
        pairs += [(getattr(ma.best_pose, f), getattr(mb.best_pose, f)),
                  (getattr(ma.mode_pose, f), getattr(mb.mode_pose, f))]
    if hasattr(a, "grid"):
        pairs += [(a.grid, b.grid)] + [(getattr(a.est_pose, f), getattr(b.est_pose, f))
                                       for f in ("x", "y", "theta")]
    return all(torch.equal(x, y) for x, y in pairs)


def parallel_world1(dev, counts) -> dict:
    """(a) A world of one rank over NCCL in this process. With one shard
    the sharded engines run the single-device code (`mesh.particle_axis`
    and `beam_axis` are None at |p| = |b| = 1), so their bit-for-bit
    equality with the unsharded engines shows the hooks leave that code as
    it was, not that the collectives are right. The sharded reductions are
    therefore also called directly over the world-1 NCCL axes at 1M and
    held to the single-device functions: the reduce-scatter resampler,
    `estimate_sharded` (with the ESS), the sharded `adaptive_emas`, the
    beam psum `_beam_sum` and the cloud means `_cloud_means`."""
    import shutil
    import tempfile

    from slam_tpu_torch.core.types import Particles, Pose
    from slam_tpu_torch.models import mcl as mcl_mod
    from slam_tpu_torch.models import slam as slam_mod
    from slam_tpu_torch.core.config import AdaptiveConfig
    from slam_tpu_torch.ops import measurement
    from slam_tpu_torch.ops import resample as resample_mod
    from slam_tpu_torch.parallel import ShardedGridSLAM, ShardedMCL, _collectives, distributed
    from slam_tpu_torch.parallel import make_mesh, shard_state
    from slam_tpu_torch.parallel.resample import systematic_resample_sharded

    reset_counts, read_counts = counts
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    distributed.initialize(f"file://{store}/store", 1, 0, backend="nccl", device=dev)
    out = {"backend": "nccl", "world": 1}
    launches = {}
    try:
        mesh = make_mesh()
        blocked, field, rc, cfg, scan, pose0, odom, alphas = par_mcl_setup(dev)
        n = cfg.n_particles

        # ShardedMCL through the fused route vs mcl.step, 4 steps.
        m = ShardedMCL(mesh, cfg, rc)
        st = shard_state(mcl_mod.init(mcl_mod.make_generator(0, dev), n, pose0), mesh, n)
        one = mcl_mod.init(mcl_mod.make_generator(0, dev), n, pose0)
        reset_counts()
        for _ in range(4):
            st = m.step(st, odom, alphas, scan, field)
        torch.cuda.synchronize()
        for k, v in read_counts().items():
            launches[k] = launches.get(k, 0) + v
        for _ in range(4):
            one = mcl_mod.step(one, odom, alphas, scan, field, cfg, rc)
        check(par_equal_states(st, one), "world 1: ShardedMCL != MCL.step bit for bit")
        out["mcl_step_ms"] = par_timed(lambda: m.step(st, odom, alphas, scan, field), 10)
        out["mcl_unsharded_step_ms"] = par_timed(
            lambda: mcl_mod.step(one, odom, alphas, scan, field, cfg, rc), 10)

        # ShardedGridSLAM vs GridSLAM, PAR_SLAM_STEPS steps.
        scfg, sodom, scans, spose = par_slam_setup(dev, blocked)
        eng = ShardedGridSLAM(mesh, scfg)
        ref = slam_mod.GridSLAM(scfg, seed=0, device=dev)
        s1, s0 = eng.init(spose), ref.init(spose)
        reset_counts()
        for k in range(PAR_SLAM_STEPS):
            s1 = eng.step(s1, sodom, scans[k % 2])
        torch.cuda.synchronize()
        for k, v in read_counts().items():
            launches[k] = launches.get(k, 0) + v
        for k in range(PAR_SLAM_STEPS):
            s0 = ref.step(s0, sodom, scans[k % 2])
        check(par_equal_states(s1, s0), "world 1: ShardedGridSLAM != GridSLAM bit for bit")
        out["slam_step_ms"] = par_timed(lambda: eng.step(s1, sodom, scans[0]), 8)
        out["slam_unsharded_step_ms"] = par_timed(lambda: ref.step(s0, sodom, scans[0]), 8)

        # The sharded resampler itself at 1M, one rank, vs the plain one.
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        lw = torch.randn(n, generator=g, device=dev) * 6.0
        ar = torch.arange(n, dtype=torch.float32, device=dev)
        p = Particles(pose=Pose(x=ar, y=ar * 0.0, theta=ar * 0.0), log_weight=lw)
        u0 = torch.tensor(0.37, device=dev)
        _collectives.reset_counts()
        got = systematic_resample_sharded(mesh, p, u0=u0)
        coll = _collectives.counts()
        want = resample_mod.resample(p, u0=u0)
        share = float((got.pose.x != want.pose.x).float().mean())
        check(share <= PAR_RESAMPLE_SHARE, f"world 1: sharded resampler differs on {share}")
        out["resample_1m"] = {"differing_share": share, "collectives": coll,
                              "ms": par_timed(lambda: systematic_resample_sharded(mesh, p, u0=u0), 5),
                              "plain_ms": par_timed(lambda: resample_mod.resample(p, u0=u0), 5)}

        # The sharded reductions over the NCCL axes, against the
        # single-device functions on the same 1M cloud.
        pax, bax = mesh.axis("p"), mesh.axis("b")
        pp = Pose(x=torch.rand(n, generator=g, device=dev) * 800,
                  y=torch.rand(n, generator=g, device=dev) * 800,
                  theta=(torch.rand(n, generator=g, device=dev) * 2 - 1) * math.pi)
        lw_meas = torch.randn(n, generator=g, device=dev) * 3.0
        _collectives.reset_counts()
        best_s, mode_s, ess_s = mcl_mod.estimate_sharded(pp, lw, lw_meas, cfg.mode_tau, pax)
        best_u, mode_u = mcl_mod.estimate(pp, lw, lw_meas, cfg.mode_tau)
        # The ESS against an f64 reference: the plain f32 `effective_sample_size`
        # (squares of normalized weights) may round further from it at 1M
        # than the sharded sums do, so both are read against f64.
        w64 = torch.softmax(lw.double(), dim=0)
        ess_ref = float(1.0 / torch.sum(w64 * w64))
        ess_u = resample_mod.effective_sample_size(lw)
        nan = torch.tensor(float("nan"), device=dev)
        ema_s = mcl_mod.adaptive_emas(nan, nan, lw_meas, AdaptiveConfig(), pax)
        ema_u = mcl_mod.adaptive_emas(nan, nan, lw_meas, AdaptiveConfig())
        beams = torch.randn(n // 16, 90, generator=g, device=dev)
        beam_s = measurement._beam_sum(beams, bax)
        means_s = measurement._cloud_means([pp.x, pp.y], pax)
        means_u = measurement._cloud_means([pp.x, pp.y], None)
        red = {
            "collectives": _collectives.counts(),
            "best_pose_rel_err": par_close(best_s, best_u),
            "mode_pose_rel_err": par_close(mode_s, mode_u),
            "ess_rel_err": abs(float(ess_s) - ess_ref) / ess_ref,
            "ess_plain_rel_err": abs(float(ess_u) - ess_ref) / ess_ref,
            "ema_abs_err": max(abs(float(a) - float(b)) for a, b in zip(ema_s, ema_u)),
            "beam_sum_bitwise": bool(torch.equal(beam_s, torch.sum(beams, dim=-1))),
            "means_rel_err": max(abs(float(a) - float(b)) / abs(float(b))
                                 for a, b in zip(means_s, means_u)),
        }
        check(red["collectives"]["calls"] > 0 and red["best_pose_rel_err"] == 0.0
              and max(red["mode_pose_rel_err"], red["ess_rel_err"], red["means_rel_err"])
              <= PAR_EST_RTOL and red["ema_abs_err"] <= PAR_EST_RTOL
              and red["beam_sum_bitwise"],
              f"world 1: a sharded reduction over NCCL differs from its plain one: {red}")
        out["reductions_1m"] = red
        out["graph_routes"], route_launches = par_graph_routes(dev, mesh, counts)
        for k, v in route_launches.items():
            launches[k] = launches.get(k, 0) + v
        out["cond_collective_probe"] = par_cond_probe(dev, mesh)
    finally:
        distributed.shutdown()
        shutil.rmtree(store, ignore_errors=True)
    out["launches"] = launches
    return out


def par_graph_routes(dev, mesh, counts):
    """(a) Each sharded engine over the world-1 NCCL mesh through its
    `StepGraphs` (one CUDA graph replay a step, every warm-up and replay
    under set_sync_debug_mode("error")) against the eager free functions
    from the same start, PAR_SLAM_STEPS steps with a new odometry and scan
    at each: equal bit for bit after every step (tensors, counters,
    generators) with the same collectives counted (a replay adds what its
    capture recorded); then ms a step each way in turns, and the profile
    of PAR_ROUTE_PROFILE steps a way (device ms, kernels and host-issued
    calls a step). Returns (the cases, the launches of the compared
    steps)."""
    from slam_tpu_torch.entry import clone_state, state_difference
    from slam_tpu_torch.models import fleet as fleet_mod
    from slam_tpu_torch.models import mcl as mcl_mod
    from slam_tpu_torch.models import slam as slam_mod
    from slam_tpu_torch.core.types import Odometry, Scan
    from slam_tpu_torch.parallel import ShardedGridSLAM, ShardedMCL, ShardedMCLFleet
    from slam_tpu_torch.parallel import _collectives, shard_state
    from slam_tpu_torch.parallel.mapshard import MapShardedGridSLAM
    from slam_tpu_torch.parallel.sharded import _resample_fn
    from slam_tpu_torch.tools import fleet_bench

    reset_counts, read_counts = counts
    blocked, field, rc, cfg, scan, pose0, odom, alphas = par_mcl_setup(dev)
    n = cfg.n_particles
    scfg, sodom, scans, spose = par_slam_setup(dev, blocked)
    steps = PAR_SLAM_STEPS
    mcl_odom = [Odometry.create(2.5 + 0.001 * k, 0.02, 0.02) for k in range(steps)]
    slam_odom = [Odometry.create(0.02 + 0.001 * k, 2.5, 0.02) for k in range(steps)]
    m = ShardedMCL(mesh, cfg, rc)
    eng = ShardedGridSLAM(mesh, scfg)
    ms = MapShardedGridSLAM(mesh, scfg)
    s_rfn = _resample_fn(mesh, scfg.mcl)
    r_all, n_fl = PAR_FLEET
    lidar_f, rc_f, cfg_f = fleet_bench.configs(n_fl)
    poses, fodoms, fscans = fleet_bench.fleet_inputs(blocked, r_all, lidar_f, cfg_f,
                                                     np.random.default_rng(7))
    sf = ShardedMCLFleet(mesh, r_all, cfg_f, rc_f, seed=0)
    f_odom = [Odometry(*(v + 0.001 * k for v in (fodoms.rot1, fodoms.trans, fodoms.rot2)))
              for k in range(steps)]
    f_scans = [Scan(angles=fscans.angles, dists=torch.roll(fscans.dists, k, 0))
               for k in range(steps)]
    cases = {
        "ShardedMCL_1m_fused": dict(
            graphs=m.graphs,
            init=lambda: shard_state(mcl_mod.init(mcl_mod.make_generator(0, dev), n, pose0),
                                     mesh, n),
            graph=lambda s, k: m.step(s, mcl_odom[k], alphas, scan, field),
            eager=lambda s, k: mcl_mod.step(s, mcl_odom[k], alphas, scan, field, cfg, rc,
                                            ray_sharding=m.sharding, resample_fn=m._rfn)),
        "ShardedGridSLAM_1m": dict(
            graphs=eng.graphs, init=lambda: eng.init(spose),
            graph=lambda s, k: eng.step(s, slam_odom[k], scans[k % 2]),
            eager=lambda s, k: slam_mod.step(s, slam_odom[k], scans[k % 2], scfg,
                                             ray_sharding=eng.sharding, resample_fn=s_rfn)),
        "MapShardedGridSLAM_1m": dict(
            graphs=ms.graphs, init=lambda: ms.init(spose),
            graph=lambda s, k: ms.step(s, slam_odom[k], scans[k % 2]),
            eager=lambda s, k: ms.eager_step(s, slam_odom[k], scans[k % 2])),
        f"ShardedMCLFleet_{r_all}x{n_fl // 1000}k": dict(
            graphs=sf.graphs, init=lambda: sf.init(poses),
            graph=lambda s, k: sf.step(s, f_odom[k], f_scans[k], field, fleet_bench.ALPHAS),
            eager=lambda s, k: fleet_mod.fleet_step(s, f_odom[k], f_scans[k], field,
                                                    fleet_bench.ALPHAS, cfg_f, rc_f)),
    }
    out, launches = {}, {}
    for name, c in cases.items():
        g = c["graphs"]
        g.guard = sync_error
        a = c["init"]()
        b = clone_state(a)
        reset_counts()
        per_step = []
        for k in range(steps):
            _collectives.reset_counts()
            made = len(g.cache.blocks)
            a = c["graph"](a, k)
            ca = _collectives.counts()
            # A step that made a block ran its warm-up (one eager step) too.
            runs = 1 + len(g.cache.blocks) - made
            _collectives.reset_counts()
            b = c["eager"](b, k)
            cb = _collectives.counts()
            diff = state_difference(a, b)
            check(diff is None, f"world 1: {name} step {k}: graph != eager ({diff})")
            want = {key: v if key == "largest_all_gather" else runs * v for key, v in cb.items()}
            check(ca == want, f"world 1: {name} step {k}: collectives graph {ca} != "
                  f"{runs} x eager {cb}")
            per_step.append(cb)
        box = {"graph": [a, 0], "eager": [b, 0]}

        def advance(way):
            bx = box[way]
            bx[0] = c[way](bx[0], bx[1] % steps)
            bx[1] += 1

        ms_ = {"graph": [], "eager": []}
        for _ in range(2):
            for way in ("graph", "eager"):
                torch.cuda.synchronize()
                ms_[way].append(event_ms(lambda: [advance(way) for _ in range(PAR_ROUTE_ITERS)])
                                / PAR_ROUTE_ITERS)
        res = {}
        for way in ("graph", "eager"):
            prof = planner_profile(lambda: [advance(way) for _ in range(PAR_ROUTE_PROFILE)])
            res[way] = {"ms_per_step": spread(ms_[way]),
                        "device_ms_per_step": prof["device_ms_per_solve"] / PAR_ROUTE_PROFILE,
                        "kernels_per_step": prof["launches_per_solve"] / PAR_ROUTE_PROFILE,
                        "host_issued_per_step":
                            prof["host_issued_per_solve"] / PAR_ROUTE_PROFILE}
        torch.cuda.synchronize()
        for k, v in read_counts().items():  # the compared, timed and profiled steps
            launches[k] = launches.get(k, 0) + v
        stats = g.stats()
        res.update(graph_equals_eager=True, steps=steps, collectives_per_step=per_step[-1],
                   capture_ms=sum(b_["capture_ms"] for b_ in stats["blocks"].values()),
                   pool_bytes=sum(b_["pool_bytes"] for b_ in stats["blocks"].values()),
                   blocks=len(stats["blocks"]))
        g.guard = contextlib.nullcontext
        out[name] = res
        say("parallel", f"world 1 NCCL {name}: graph == eager bit for bit over {steps} steps; "
            f"{json.dumps(res)}")
        del a, b, box
        torch.cuda.empty_cache()
    return out, launches


def par_cond_probe(dev, mesh) -> dict:
    """(a) A collective inside a CUDA graph conditional body over NCCL (the
    sharded auto tier's shape: `mcl._weigh`'s cond, whose table branch
    reduces over the mesh): a block whose `cond` sums over 'p' on one
    branch, captured and replayed twice with the branch taken and once
    with it skipped. The sums are right, and the collectives counted
    (the warm-up's on the host, the body's on the device) are the ones
    that ran."""
    from slam_tpu_torch.core import graph as graphlib
    from slam_tpu_torch.parallel import _collectives

    pax = mesh.axis("p")
    x = torch.arange(1024, dtype=torch.float32, device=dev)

    def fn(v):
        return {"x": graphlib.cond(v["p"], lambda a: pax.psum(a) * 2, lambda a: a - 1, v["x"])}

    blk = graphlib.Block(fn, {"x": x.clone(), "p": torch.ones((), dtype=torch.bool, device=dev)},
                         guard=sync_error)
    _collectives.reset_counts()
    blk.run()
    blk.run()
    blk.static["p"].fill_(False)
    blk.run()
    torch.cuda.synchronize()
    got = _collectives.counts()
    right = bool(torch.equal(blk.static["x"], x * 4 - 1))
    # The warm-up ran both branches (one psum), the two replays the branch.
    check(right and got["calls"] == 3 and got["all_reduce"] == 3 * 1024 and blk.if_nodes == 2,
          f"world 1: a psum inside an IF body: values right {right}, counted {got}, "
          f"{blk.if_nodes} IF nodes")
    return {"accepted": True, "values_right": right, "if_nodes": blk.if_nodes,
            "collectives_counted": got, "backend": mesh.backend, "world": 1}


def par_rank_main(outdir: str) -> None:
    """(b) One rank of a D-rank world on the one card over gloo: prints one
    JSON line of its checks and times."""
    import dataclasses as dc

    from slam_tpu_torch.core.config import HybridAStarConfig, MapConfig, MCLConfig
    from slam_tpu_torch.core.config import RaycastConfig, SLAMConfig, LidarConfig
    from slam_tpu_torch.core import grid as gridlib
    from slam_tpu_torch.core.types import Particles, Pose
    from slam_tpu_torch.models import fake_lidar
    from slam_tpu_torch.models import fleet as fleet_mod
    from slam_tpu_torch.models import mcl as mcl_mod
    from slam_tpu_torch.models import slam as slam_mod
    from slam_tpu_torch.ops import edt as edtlib
    from slam_tpu_torch.ops import lut_weights_cuda, measurement, motion_cuda, pano_cuda
    from slam_tpu_torch.ops import resample as resample_mod
    from slam_tpu_torch.ops import estimate_cuda, resample_cuda
    from slam_tpu_torch.ops.raycast import raycast_march
    from slam_tpu_torch.parallel import ShardedGridSLAM, ShardedMCL, ShardedMCLFleet
    from slam_tpu_torch.parallel import _collectives, distributed, make_mesh, shard_state
    from slam_tpu_torch.parallel import edt as pedt
    from slam_tpu_torch.parallel import mapshard
    from slam_tpu_torch.parallel.resample import systematic_resample_sharded
    from slam_tpu_torch.parallel.sharded import gather_particles, particle_sharding
    from slam_tpu_torch.planners import HybridAStar
    from slam_tpu_torch.tools import fleet_bench
    from slam_tpu_torch.tools.maze_bench import find_start, procedural_maze

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    distributed.initialize(f"file://{outdir}/store", world, rank, backend="gloo", device=dev)
    gather = pano_cuda.gather_rows
    sampler = motion_cuda.sample_motion_model_odometry_fused
    fused = lut_weights_cuda.launch
    chain = resample_cuda.launch
    estimator = estimate_cuda.launch
    launches = dict.fromkeys(KERNEL_NAMES, 0)

    def counted(fn):
        """Run a main-path call with the launch counts zeroed; add its."""
        gather.launches = sampler.launches = fused.launches = chain.launches = estimator.launches = 0
        r = fn()
        for k, v in (("gather_rows", gather.launches), ("motion_odometry", sampler.launches),
                     ("lut_weights", fused.launches), ("resample", chain.launches),
                     ("estimate", estimator.launches)):
            launches[k] += v
        return r

    res = {"rank": rank, "world": world, "backend": "gloo"}
    mesh = make_mesh()
    pax = mesh.axis("p")
    blocked, field, rc, cfg, scan, pose0, odom, alphas = par_mcl_setup(dev)
    n = cfg.n_particles
    l = n // world
    sl = slice(rank * l, (rank + 1) * l)

    # The fused kernel with i0 on a uniform free-space cloud.
    rng = np.random.default_rng(0)
    free = np.argwhere(~blocked.cpu().numpy())
    pick = free[rng.integers(0, len(free), n)]
    h = blocked.shape[0]
    cloud = Pose(x=torch.tensor(pick[:, 1] + 0.5, dtype=torch.float32, device=dev),
                 y=torch.tensor(h - pick[:, 0] - 0.5, dtype=torch.float32, device=dev),
                 theta=torch.tensor(rng.uniform(-math.pi, math.pi, n), dtype=torch.float32,
                                    device=dev))
    seed = torch.tensor([12345], dtype=torch.int64, device=dev)
    full_pose, full_lw = mcl_mod.predict_weigh(cloud, scan, field, cfg, rc, seed, odom, alphas)
    part = Pose(*(getattr(cloud, f)[sl].contiguous() for f in ("x", "y", "theta")))
    part_pose, part_lw = mcl_mod.predict_weigh(part, scan, field, cfg, rc, seed, odom, alphas,
                                               i0=rank * l)
    check(all(torch.equal(getattr(part_pose, f), getattr(full_pose, f)[sl])
              for f in ("x", "y", "theta")) and torch.equal(part_lw, full_lw[sl]),
          f"rank {rank}: the fused kernel with i0 != slice of the whole launch")
    res["fused_i0_bitwise"] = True

    # ShardedMCL at 1M, beam_axis 1: one step without resampling vs the
    # unsharded step on this rank.
    cfg0 = dc.replace(cfg, ess_threshold=0.0)
    one = mcl_mod.step(mcl_mod.init(mcl_mod.make_generator(0, dev), n, pose0), odom, alphas,
                       scan, field, cfg0, rc)
    m0 = ShardedMCL(mesh, cfg0, rc)
    st = shard_state(mcl_mod.init(mcl_mod.make_generator(0, dev), n, pose0), mesh, n)
    _collectives.reset_counts()
    st = counted(lambda: m0.step(st, odom, alphas, scan, field))
    res["mcl_collectives_per_step_no_resample"] = _collectives.counts()
    p, q = st.particles, one.particles
    check(all(torch.equal(getattr(p.pose, f), getattr(q.pose, f)[sl]) for f in ("x", "y", "theta"))
          and torch.equal(p.log_weight, q.log_weight[sl]),
          f"rank {rank}: ShardedMCL poses / log weights != world 1")
    est = max(par_close(st.best_pose, one.best_pose), par_close(st.mode_pose, one.mode_pose))
    check(est <= PAR_EST_RTOL, f"rank {rank}: ShardedMCL estimate off by {est}")
    res["mcl_estimate_rel_err"] = est
    # The sharded resampler on this step's weights (poses = global index)
    # vs the plain one on the whole cloud.
    ar = torch.arange(n, dtype=torch.float32, device=dev)
    u0 = torch.tensor(0.37, device=dev)
    got = systematic_resample_sharded(mesh, Particles(
        pose=Pose(x=ar[sl].contiguous(), y=ar[sl] * 0.0, theta=ar[sl] * 0.0),
        log_weight=p.log_weight), u0=u0)
    got_x = pax.all_gather(got.pose.x).reshape(-1)
    want_x = resample_mod.resample(Particles(pose=Pose(x=ar, y=ar * 0.0, theta=ar * 0.0),
                                             log_weight=q.log_weight), u0=u0).pose.x
    share = float((got_x != want_x).float().mean())
    check(share <= PAR_RESAMPLE_SHARE, f"rank {rank}: resampled slots differ on {share}")
    res["mcl_resample_differing_share"] = share
    m = ShardedMCL(mesh, cfg, rc)
    st = shard_state(mcl_mod.init(mcl_mod.make_generator(0, dev), n, pose0), mesh, n)
    for _ in range(2):
        st = counted(lambda: m.step(st, odom, alphas, scan, field))
    _collectives.reset_counts()
    st = counted(lambda: m.step(st, odom, alphas, scan, field))
    res["mcl_collectives_per_step"] = _collectives.counts()

    def mcl_step():
        nonlocal st
        st = counted(lambda: m.step(st, odom, alphas, scan, field))

    res["mcl_step_ms"] = par_timed(mcl_step, 10)

    # ShardedGridSLAM at 1M: one step vs world 1, then PAR_SLAM_STEPS.
    scfg, sodom, scans, spose = par_slam_setup(dev, blocked)
    ref = slam_mod.GridSLAM(scfg, seed=0, device=dev)
    r1 = ref.step(ref.init(spose), sodom, scans[0])
    eng = ShardedGridSLAM(mesh, scfg)
    s = eng.init(spose)
    _collectives.reset_counts()
    s = counted(lambda: eng.step(s, sodom, scans[0]))
    coll = _collectives.counts()
    check(coll["largest_all_gather"] <= world * 16,
          f"rank {rank}: an all-gather of {coll['largest_all_gather']} elements in the step")
    res["slam_collectives_step1"] = coll
    # The map follows the mode estimate, a sum over the shards whose
    # rounding differs from one rank's: a beam on a cell edge may map
    # another cell.
    grid_differ = float((s.grid != r1.grid).float().mean())
    check(grid_differ <= PAR_RESAMPLE_SHARE,
          f"rank {rank}: SLAM grid after step 1 differs from world 1 on {grid_differ}")
    est = max(par_close(s.est_pose, r1.est_pose), par_close(s.mcl.mode_pose, r1.mcl.mode_pose))
    check(est <= PAR_EST_RTOL, f"rank {rank}: SLAM estimate off by {est}")
    whole = gather_particles(mesh, s)
    rp = r1.mcl.particles
    differ = float(((whole[0] != rp.pose.x) | (whole[1] != rp.pose.y)).float().mean())
    check(differ <= PAR_RESAMPLE_SHARE, f"rank {rank}: SLAM particles differ on {differ}")
    res["slam_step1"] = {"estimate_rel_err": est, "differing_particles": differ,
                         "differing_grid_cells": grid_differ}
    t_steps = []
    for k in range(1, PAR_SLAM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = counted(lambda: eng.step(s, sodom, scans[k % 2]))
        torch.cuda.synchronize()
        t_steps.append((time.perf_counter() - t0) * 1e3)
    grids = pax.all_gather(s.grid)
    check(all(torch.equal(grids[k], s.grid) for k in range(world)),
          f"rank {rank}: the replicated grids differ between ranks")
    res["slam_step_ms"] = statistics.median(t_steps)
    res["slam_grids_identical"] = True

    # MapShardedGridSLAM on the 2400 px maze, the map in row blocks.
    maze_np = procedural_maze(2400, 40)
    maze = torch.from_numpy(maze_np).to(dev)
    mesh_b = make_mesh(beam_axis=world)  # every rank a row block
    rows = mapshard.grid_rows(mesh_b, 2400)
    mcfg = SLAMConfig(
        mcl=MCLConfig(n_particles=PAR_MAZE_PARTICLES, meas_stddev=5.0,
                      measurement="likelihood_field_table", lf_table_box=128),
        map=MapConfig(height=2400, width=2400),
        lidar=LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90),
        raycast=RaycastConfig(step=0.5, max_dist=500.0, backend="sdf"))
    cap = 5.0 * mcfg.mcl.meas_stddev + 2.0
    _collectives.reset_counts()
    e_sh = pedt.edt_capped_sharded(mesh_b, maze[rows], max_dist=cap, full_shape=(2400, 2400))
    halo = _collectives.counts()
    e_rep = edtlib.edt_capped(maze, cap)
    check(torch.equal(e_sh, e_rep[rows]), f"rank {rank}: sharded capped EDT != replicated")
    g2 = torch.Generator(device=dev)
    g2.manual_seed(1)
    rays = [torch.rand(100_000, generator=g2, device=dev) * 2400,
            torch.rand(100_000, generator=g2, device=dev) * 2400,
            (torch.rand(100_000, generator=g2, device=dev) * 2 - 1) * math.pi]
    d_sh, h_sh = mapshard.raycast_march_sharded(mesh_b, maze[rows], *rays, full_h=2400,
                                                step=0.5, max_dist=500.0)
    d_rep, h_rep = raycast_march(maze, *rays, step=0.5, max_dist=500.0)
    check(torch.equal(h_sh, h_rep) and torch.equal(torch.where(h_rep, d_sh, 0.0),
                                                   torch.where(h_rep, d_rep, 0.0)),
          f"rank {rank}: sharded march != replicated")
    sx, sy = find_start(maze_np, dev)
    mpose = Pose.create(sx, sy, 0.0, device=dev)
    mscan = fake_lidar.scan(maze, measurement.sensor_pose(mpose, mcfg.mcl.scanner_offset),
                            mcfg.lidar, mcfg.raycast)
    full_grid = torch.where(maze, mcfg.map.l_max, mcfg.map.l_min).to(torch.float32)
    mref = slam_mod.GridSLAM(mcfg, seed=0, device=dev)
    r0 = mref.init(mpose)
    r0 = mref.step(r0.replace(grid=full_grid.clone()), sodom, mscan)
    meng = mapshard.MapShardedGridSLAM(mesh_b, mcfg)
    ms = meng.init(mpose)
    ms = ms.replace(grid=full_grid[rows].contiguous())
    ms = counted(lambda: meng.step(ms, sodom, mscan))
    grid_all = mesh_b.axis("b").all_gather(ms.grid).reshape(2400, 2400)
    mp, rp = ms.mcl.particles, r0.mcl.particles
    lw_err = float((mp.log_weight - rp.log_weight).abs().max())
    differ = float(((mp.pose.x != rp.pose.x) | (mp.pose.y != rp.pose.y)).float().mean())
    check(torch.equal(grid_all, r0.grid), f"rank {rank}: map-sharded grid != GridSLAM")
    check(differ <= PAR_RESAMPLE_SHARE and par_close(ms.est_pose, r0.est_pose) <= PAR_EST_RTOL,
          f"rank {rank}: map-sharded step differs from GridSLAM ({differ}, {lw_err})")
    res["maze"] = {"edt_bitwise": True, "edt_halo_collectives": halo,
                   "march_bitwise": True, "step_lw_max_abs": lw_err,
                   "step_differing_particles": differ,
                   "step_ms": par_timed(lambda: meng.step(ms, sodom, mscan), 5)}

    # ShardedMCLFleet: robots over the ranks == MCLFleet bit for bit.
    r_all, n_fl = PAR_FLEET
    lidar_f, rc_f, cfg_f = fleet_bench.configs(n_fl)
    poses, odoms, fscans = fleet_bench.fleet_inputs(blocked, r_all, lidar_f, cfg_f,
                                                    np.random.default_rng(7))
    fl = fleet_mod.MCLFleet(r_all, cfg_f, rc_f, seed=0, device=dev)
    fs = fl.init(poses)
    sf = ShardedMCLFleet(mesh, r_all, cfg_f, rc_f, seed=0)
    ss = sf.init(poses)
    _collectives.reset_counts()
    for _ in range(2):
        fs = fl.step(fs, odoms, fscans, field, fleet_bench.ALPHAS)
        ss = counted(lambda: sf.step(ss, odoms, fscans, field, fleet_bench.ALPHAS))
    check(_collectives.counts()["calls"] == 0, f"rank {rank}: the fleet step called a collective")
    mine = sf.robots
    check(all(torch.equal(getattr(ss.particles.pose, f), getattr(fs.particles.pose, f)[mine])
              for f in ("x", "y", "theta"))
          and torch.equal(ss.particles.log_weight, fs.particles.log_weight[mine]),
          f"rank {rank}: ShardedMCLFleet != MCLFleet")

    def fleet_step():
        nonlocal ss
        ss = counted(lambda: sf.step(ss, odoms, fscans, field, fleet_bench.ALPHAS))

    res["fleet"] = {"robots": r_all, "particles": n_fl, "robots_per_rank": r_all // world,
                    "bitwise": True, "step_ms": par_timed(fleet_step, 5)}

    # Lattice HA* queries spread over the ranks.
    free_w = np.ones((64, 64), bool)
    free_w[:, 31:33] = False
    free_w[28:38, 31:33] = True
    hcfg = HybridAStarConfig(velocity=4.0, length=4.0 / math.tan(40 * math.pi / 180) * 2,
                             theta_res=12, branching_factor=3, tol=4.0, batch=64,
                             mode="lattice")
    qs = [((10.0, 32.0, 0.0), (54.0, 32.0, 0.0)), ((10.0, 10.0, 0.0), (50.0, 50.0, 0.0)),
          ((54.0, 10.0, 0.0), (10.0, 50.0, 0.0)), ((50.0, 50.0, 0.0), (10.0, 12.0, 0.0))]
    queries = [(Pose.create(*a, device=dev), Pose.create(*b, device=dev)) for a, b in qs]
    hp = HybridAStar(free_w, queries[0][0], queries[0][1], hcfg, device=dev)
    want = hp.solve_many(queries, 400)
    want_paths = [hp.recover_path_for(k) for k in range(len(qs))]
    t0 = time.perf_counter()
    got = hp.solve_many(queries, 400, query_sharding=particle_sharding(mesh))
    hs = (time.perf_counter() - t0) * 1e3
    check(got == want and all(hp.recover_path_for(k) == want_paths[k] for k in range(len(qs))),
          f"rank {rank}: sharded solve_many != unsharded")
    res["hastar"] = {"queries": len(qs), "solved": sum(a for a, _ in got), "paths_equal": True,
                     "sharded_ms": hs}
    res["launches"] = launches
    print(json.dumps(res), flush=True)
    distributed.shutdown()


def parallel_phase(dev, counts) -> dict:
    """Phase 23: (a) world 1 over NCCL here, (b) D = 2 and 4 ranks sharing
    the card over gloo, each world in subprocesses under a wall-clock
    limit, every rank's exit code checked."""
    import shutil
    import tempfile

    from slam_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    out = {"world1": parallel_world1(dev, counts)}
    launches = dict(out["world1"]["launches"])
    for d in PAR_WORLDS:
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_d{d}_")
        try:
            rcs, outs, errs, secs = distributed.launch_world(
                [sys.executable, os.path.abspath(__file__), "--parallel-rank", tmp], d,
                timeout_s=PAR_WORLD_LIMIT_S)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if rcs != [0] * d:
            for r, (rc, e) in enumerate(zip(rcs, errs)):
                if rc != 0:
                    print(f"[parallel] world {d} rank {r} rc {rc}:\n{e[-4000:]}", flush=True)
            check(False, f"world of {d} ranks: exit codes {rcs}")
        ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        for r in ranks:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        r0 = ranks[0]
        out[f"world{d}"] = {
            "label": f"{d} ranks sharing one card (gloo); not a multi-GPU result",
            "seconds": secs, "backend": r0["backend"],
            # Bytes copied through the host: only gloo's ppermute (the EDT
            # halo) stages a CUDA buffer; every other collective runs on the card.
            "staged_bytes": {"mcl_step": r0["mcl_collectives_per_step"]["staged_bytes"],
                             "slam_step": r0["slam_collectives_step1"]["staged_bytes"],
                             "maze_edt_halo": r0["maze"]["edt_halo_collectives"]["staged_bytes"]},
            **{k: r0[k] for k in ("mcl_step_ms", "slam_step_ms", "mcl_estimate_rel_err",
                                  "mcl_resample_differing_share", "slam_step1",
                                  "slam_collectives_step1", "mcl_collectives_per_step",
                                  "maze", "fleet", "hastar")},
            "mcl_step_ms_per_rank": [r["mcl_step_ms"] for r in ranks],
            "slam_step_ms_per_rank": [r["slam_step_ms"] for r in ranks],
        }
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out


def warmup_counts() -> dict:
    """The kernel wrappers' launches made by graph warm-ups since the last
    reset (a block's one eager run before its capture; `core/graph.py`)."""
    from slam_tpu_torch.ops import (
        estimate_cuda, lut_weights_cuda, motion_cuda, pano_cuda, rbpf_fidelity_cuda,
        resample_cuda,
    )

    return {"gather_rows": pano_cuda.gather_rows.warmup_launches,
            "motion_odometry": motion_cuda.sample_motion_model_odometry_fused.warmup_launches,
            "lut_weights": lut_weights_cuda.launch.warmup_launches,
            "resample": resample_cuda.launch.warmup_launches,
            "estimate": estimate_cuda.launch.warmup_launches,
            "rbpf_march": rbpf_fidelity_cuda.march.warmup_launches,
            "rbpf_write": rbpf_fidelity_cuda.write.warmup_launches}


def capture_gc_check(dev) -> dict:
    """A block's capture runs with the garbage collector off, and turns it
    back on after: a collection that frees an earlier block's graph during
    a capture (an engine left in a reference cycle) destroys that graph, a
    call the capture under way refuses, and the capture is lost. The block
    here (a `cond`) records the collector's state while it is captured; an
    earlier block, left as cyclic garbage across the capture, is collected
    after it."""
    import gc
    import weakref

    from slam_tpu_torch.core import graph as graphlib

    seen = []

    def make():
        def fn(v):
            if graphlib._CAPTURE is not None:
                seen.append(gc.isenabled())
            return {"x": graphlib.cond(v["p"], lambda x: x + 1, lambda x: x - 1, v["x"])}
        return graphlib.Block(fn, {"x": torch.zeros(1024, device=dev),
                                   "p": torch.ones((), dtype=torch.bool, device=dev)})

    old = make()
    old.run()
    old.cycle = old
    gone = weakref.ref(old)
    del old
    seen.clear()
    new = make()
    new.run()
    new.run()
    torch.cuda.synchronize()
    check(seen == [False], f"capture_gc: the collector's state during the capture: {seen}")
    check(gc.isenabled(), "capture_gc: the collector stayed off after the capture")
    check(bool((new.static["x"] == 2).all()), "capture_gc: the captured cond computed a wrong x")
    gc.collect()
    check(gone() is None, "capture_gc: the earlier block's graph was not collected")
    return {"collector_during_capture": seen[0], "collector_after": gc.isenabled(),
            "if_nodes": new.if_nodes, "earlier_graph_collected_after": True}


def graphs_phase(dev, blocked_np, field, maze, counts) -> dict:
    """Phase 25: each filter step through its entry point's CUDA graph
    (`models/_graph.py`, one replay a step) against the eager free
    function, at the full widths of phases 7-21: the 100k MCL step
    (`MCL.step`, the fused route), global localization at 1M (`MCL.step`
    from init_uniform), the 1M SLAM step and the scan-matched one
    (`GridSLAM.step`, a block per resample-gate phase), the fleet of 16 x
    100k (`MCLFleet.step`), the 2400 px maze's 10k step through the
    CDDT and the dense u8 table (`MCL.step`), and `apps/grid_slam.py`'s
    SLAM step (1000 particles, the beam model sphere-traced: the graph
    traces the whole count, eager stops early). Per case, GRAPH_STEPS steps
    with a new odometry and scan at each, every replay under
    set_sync_debug_mode("error"): graph == eager bit for bit after every
    step (every tensor of the state, the counters, the generators'
    states), and the graph's kernel launches == eager's plus its
    warm-ups; then graph and eager timed in turns (CUDA events), each
    profiled (device ms, kernels and host-issued launches a step; the
    runs of each
    hand-written kernel the profiler saw == the launches its wrapper
    counted over the same steps, which under graphs it counts from the
    capture's tally at each replay), the blocks' capture ms and pool
    memory, the state copies a step."""
    from slam_tpu_torch.core.config import (
        LidarConfig, MapConfig, MCLConfig, MotionConfig, RaycastConfig, ScanMatchConfig,
        SLAMConfig, beam_bin_stride,
    )
    from slam_tpu_torch.core.types import Odometry, Pose, Scan
    from slam_tpu_torch.entry import state_difference
    from slam_tpu_torch.models import fake_lidar, fleet
    from slam_tpu_torch.models import mcl as mcl_mod
    from slam_tpu_torch.models import slam as slam_mod
    from slam_tpu_torch.models.simulate import forward_arc_commands
    from slam_tpu_torch.ops import measurement
    from slam_tpu_torch.tools import fleet_bench as fb
    from slam_tpu_torch.tools import global_loc_bench as glb
    from slam_tpu_torch.tools import maze_bench as mb

    reset_counts, read_counts = counts
    blocked = torch.from_numpy(blocked_np).to(dev)
    n_in = GRAPH_STEPS

    def scans_along(b, truths, offset, lidar):
        return [fake_lidar.scan(b, measurement.sensor_pose(Pose.create(*t, device=dev), offset),
                                lidar, RaycastConfig(max_dist=500.0)) for t in truths]

    def odoms(base, dk):
        return [Odometry.create(base[0] + dk[0] * k, base[1] + dk[1] * k, base[2] + dk[2] * k)
                for k in range(n_in)]

    cases = {}
    # The 100k MCL step: phase 6-7's configuration.
    lidar = LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="lut")
    cfg = MCLConfig(n_particles=N_PARTICLES, meas_stddev=5.0, scanner_offset=(0.0, 30.0, 0.0),
                    lut_beam_stride=beam_bin_stride(lidar, rc))
    mcl_scans = scans_along(blocked, [(400.0 + k, 400.0, math.pi + 0.01 * k)
                                      for k in range(n_in)], cfg.scanner_offset, lidar)
    mcl_odom = odoms((2.5, 0.02, 0.02), (0.001, 0.001, 0.0))
    bench_alphas = (0.0005, 0.0005, 0.01, 0.01)
    eng = mcl_mod.MCL(cfg, rc, device=dev)
    pose0 = Pose.create(400.0, 400.0, math.pi, device=dev)
    cases["mcl_100k"] = dict(
        graphs=eng.graphs,
        init=lambda: mcl_mod.init(mcl_mod.make_generator(0, dev), N_PARTICLES, pose0),
        graph=lambda st, k, e=eng: e.step(st, mcl_odom[k], bench_alphas, mcl_scans[k], field),
        eager=lambda st, k: mcl_mod.step(st, mcl_odom[k], bench_alphas, mcl_scans[k], field,
                                         cfg, rc))

    # Global localization at 1M: phase 15's configuration, seed 0's scans.
    gl_lidar, gl_rc, gl_scan_rc, gl_cfg = glb.configs(GL_PARTICLES)
    cmds = forward_arc_commands(n_in, trans=2.5, rot=0.04)
    _, gl_scans = glb.truth_and_scans(blocked, gl_lidar, gl_scan_rc, gl_cfg, 0, cmds)
    gl_odom = [Odometry.create(float(c.rot1) + 0.001 * k, float(c.trans), float(c.rot2))
               for k, c in enumerate(cmds)]
    gl_eng = mcl_mod.MCL(gl_cfg, gl_rc, device=dev)
    cases["globalloc_1m"] = dict(
        graphs=gl_eng.graphs,
        init=lambda: mcl_mod.init_uniform(mcl_mod.make_generator(0, dev), GL_PARTICLES, blocked),
        graph=lambda st, k: gl_eng.step(st, gl_odom[k], glb.ALPHAS, gl_scans[k], field),
        eager=lambda st, k: mcl_mod.step(st, gl_odom[k], glb.ALPHAS, gl_scans[k], field,
                                         gl_cfg, gl_rc))

    # The 1M SLAM step and the scan-matched one: phases 9 and 18.
    slam_truths = [(400.0 - 2.5 * k, 400.0 + 0.1 * k, math.pi + 0.005 * k) for k in range(n_in)]
    for name, scfg in (("slam_1m", slam_config()),
                       ("scanmatch_slam_1m", dataclasses.replace(
                           slam_config(), scanmatch=ScanMatchConfig()))):
        s_eng = slam_mod.GridSLAM(scfg, seed=0, device=dev)
        s_scans = scans_along(blocked, slam_truths, scfg.mcl.scanner_offset, scfg.lidar)
        s_odom = odoms((0.02, 2.5, 0.02), (0.001, 0.0, -0.001))
        start = Pose.create(400.0, 400.0, math.pi, device=dev)
        cases[name] = dict(
            graphs=s_eng.graphs,
            init=lambda e=s_eng, p=start: e.init(p),
            graph=lambda st, k, e=s_eng, z=s_scans, o=s_odom: e.step(st, o[k], z[k]),
            eager=lambda st, k, c=scfg, z=s_scans, o=s_odom: slam_mod.step(st, o[k], z[k], c))

    # The fleet of 16 x 100k: phase 21's configuration; robot q's scan at
    # step k is robot (q - k)'s start scan.
    f_lidar, f_rc, f_cfg = fb.configs(FLEET_N)
    r = FLEET_CHECK_R
    f_poses, _, f_scans0 = fb.fleet_inputs(blocked, r, f_lidar, f_cfg,
                                           np.random.default_rng(FLEET_SEED))
    f_odom = [Odometry.create(*(np.float32(v) + np.float32(0.001 * k)
                                + np.float32(0.0005) * np.arange(r, dtype=np.float32)
                                for v in fb.ODOM)) for k in range(n_in)]
    f_scans = [Scan(angles=f_scans0.angles, dists=torch.roll(f_scans0.dists, k, 0))
               for k in range(n_in)]
    fl = fleet.MCLFleet(r, f_cfg, f_rc, seed=0, device=dev)
    cases["fleet_16x100k"] = dict(
        graphs=fl.graphs, init=lambda: fl.init(f_poses),
        graph=lambda st, k: fl.step(st, f_odom[k], f_scans[k], field, fb.ALPHAS),
        eager=lambda st, k: fleet.fleet_step(st, f_odom[k], f_scans[k], field, fb.ALPHAS,
                                             f_cfg, f_rc))

    # The 2400 px maze's 10k step through both tables: phase 20's.
    for backend in ("cddt", "lut"):
        m_lidar, m_rc, m_cfg = mb.configs(backend, MAZE_PARTICLES)
        m_field = maze["fields"][backend]
        sx, sy, sth = maze["start"]
        m_truths = [(sx + 0.2 * k, sy + 0.2 * k, sth + 0.03 * k) for k in range(n_in)]
        m_scans = [fake_lidar.scan(m_field.blocked, Pose.create(*t, device=dev), m_lidar,
                                   RaycastConfig(max_dist=500.0)) for t in m_truths]
        m_odom = odoms((0.05, 1.0, 0.05), (0.001, 0.01, 0.0))
        m_eng = mcl_mod.MCL(m_cfg, m_rc, device=dev)
        m_start = Pose.create(sx, sy, sth, device=dev)
        name = "maze_cddt_10k" if backend == "cddt" else "maze_u8_10k"
        cases[name] = dict(
            graphs=m_eng.graphs,
            init=lambda p=m_start: mcl_mod.init(mcl_mod.make_generator(0, dev), MAZE_PARTICLES,
                                                p),
            graph=lambda st, k, e=m_eng, f=m_field, z=m_scans, o=m_odom: e.step(
                st, o[k], mb.ALPHAS, z[k], f),
            eager=lambda st, k, c=m_cfg, rc_=m_rc, f=m_field, z=m_scans, o=m_odom: mcl_mod.step(
                st, o[k], mb.ALPHAS, z[k], f, c, rc_))

    # `apps/grid_slam.py`'s SLAM step at phase 22's 1000 particles on the
    # plan: its defaults (the beam model, 60 rays to 200 px, sphere-traced
    # over the EDT rebuilt each step).
    h, w = blocked_np.shape
    a_cfg = SLAMConfig(
        mcl=MCLConfig(n_particles=1000, meas_stddev=5.0, measurement="beam"),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(n_rays=60, max_dist=200.0, stddev=5.0),
        motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
        raycast=RaycastConfig(step=1.0, max_dist=200.0, backend="sdf"))
    a_eng = slam_mod.GridSLAM(a_cfg, seed=0, device=dev)
    a_start = Pose.create(w / 2.0, h / 2.0, math.pi / 2, device=dev)
    a_scans = [fake_lidar.scan(blocked, Pose.create(w / 2.0 + 0.5 * k, h / 2.0 + 2.0 * k,
                                                    math.pi / 2 + 0.01 * k, device=dev),
                               a_cfg.lidar, RaycastConfig(step=1.0, max_dist=200.0))
               for k in range(n_in)]
    a_odom = odoms((0.01, 2.0, 0.0), (0.0005, 0.0, 0.0))
    cases["grid_slam_sdf_1k"] = dict(
        graphs=a_eng.graphs, init=lambda: a_eng.init(a_start),
        graph=lambda st, k: a_eng.step(st, a_odom[k], a_scans[k]),
        eager=lambda st, k: slam_mod.step(st, a_odom[k], a_scans[k], a_cfg))

    # The device control flow (`core/graph.py:cond`, CUDA graph IF nodes
    # through `csrc/graph_cond.cu`): the `edt_box` SLAM step at 1M (phase
    # 10's, box 512), first standing still on one scan from its start (every
    # particle at one pose and no motion noise, so the map pose and each
    # cell's update repeat and no cell flips after the first map update:
    # the no-flip branch), then on alternating scans (window and full);
    # the maze SLAM tool's `likelihood_field_table:128:e1024` at 10k on the
    # 2400 px maze, whose refresh window is smaller than the map; the
    # auto-tier `MCL.step` at 1M on a converged cloud and on a dispersed one
    # kept dispersed (ess_threshold 0: no resample); the fleet's auto step
    # at 16 x 100k, odd robots dispersed; and phase 7's tracking step at 1M
    # with ess_threshold 0.5 (the gate keeps the cloud while its weights
    # stay flat). `observe` records what each step chose, from the eager
    # states, outside the sync check.
    from slam_tpu_torch.core import grid as gridlib
    from slam_tpu_torch.ops import edt as edtlib
    from slam_tpu_torch.ops.rayfield import RayField
    from slam_tpu_torch.tools import maze_slam_bench as msb

    def refresh_branch(scfg):
        reach = edtlib.edt_capped_reach(5.0 * scfg.mcl.meas_stddev + 2.0)

        def observe(before, after, seen):
            a_, f_, _, _ = edtlib._refresh_plan(gridlib.blocked_from_logodds(before.grid),
                                                gridlib.blocked_from_logodds(after.grid),
                                                reach=reach, box=scfg.edt_box)
            key = "no flip" if not bool(a_) else "window" if bool(f_) else "full"
            seen[key] = seen.get(key, 0) + 1
        return observe

    e_cfg = slam_config(edt_box=512)
    e_eng = slam_mod.GridSLAM(e_cfg, seed=0, device=dev)
    e_ab = scans_along(blocked, slam_truths[:2], e_cfg.mcl.scanner_offset, e_cfg.lidar)
    still = Odometry.create(0.0, 0.0, 0.0)
    e_scans = [e_ab[0] if k < EDT_STILL else e_ab[k % 2] for k in range(n_in)]
    e_odom = [still if k < EDT_STILL else o
              for k, o in enumerate(odoms((0.02, 2.5, 0.02), (0.0, 0.0, 0.0)))]
    e_start = Pose.create(400.0, 400.0, math.pi, device=dev)
    cases["slam_edt512_1m"] = dict(
        graphs=e_eng.graphs, init=lambda: e_eng.init(e_start),
        graph=lambda st, k: e_eng.step(st, e_odom[k], e_scans[k]),
        eager=lambda st, k: slam_mod.step(st, e_odom[k], e_scans[k], e_cfg),
        observe=refresh_branch(e_cfg))

    mz_blocked = maze["fields"]["cddt"].blocked
    mz_cfg = msb.tier_config(tuple(mz_blocked.shape), "likelihood_field_table:128:e1024",
                             MAZE_PARTICLES)
    mz_eng = slam_mod.GridSLAM(mz_cfg, seed=0, device=dev)
    msx, msy, msth = maze["start"]
    mz_truths = [(msx + 0.5 * k * math.cos(msth), msy + 0.5 * k * math.sin(msth),
                  msth + 0.01 * k) for k in range(n_in)]
    mz_scans = [fake_lidar.scan(mz_blocked, measurement.sensor_pose(
        Pose.create(*t, device=dev), mz_cfg.mcl.scanner_offset), mz_cfg.lidar,
        RaycastConfig(max_dist=500.0)) for t in mz_truths]
    mz_odom = odoms((0.01, 0.5, 0.0), (0.0, 0.0, 0.0))
    mz_start = Pose.create(msx, msy, msth, device=dev)
    cases["maze_slam_e1024_10k"] = dict(
        graphs=mz_eng.graphs, init=lambda: mz_eng.init(mz_start),
        graph=lambda st, k: mz_eng.step(st, mz_odom[k], mz_scans[k]),
        eager=lambda st, k: slam_mod.step(st, mz_odom[k], mz_scans[k], mz_cfg),
        observe=refresh_branch(mz_cfg))

    # The auto tier on the plan's capped EDT: phase 16's MCL configuration.
    au_slam = slam_config()
    au_cfg = dataclasses.replace(au_slam.mcl, measurement="likelihood_field_auto")
    lf_field = RayField(blocked=blocked, edt=edtlib.edt_capped(
        blocked, 5.0 * au_cfg.meas_stddev + 2.0))
    au_scans = scans_along(blocked, slam_truths, au_cfg.scanner_offset, au_slam.lidar)
    au_odom = odoms((0.02, 2.5, 0.02), (0.001, 0.0, -0.001))

    def tier_seen(cfg_):
        def observe(before, after, seen):  # the predicate of the cloud a step starts from
            pp = before.particles.pose
            rows = [pp] if pp.x.dim() == 1 else [fleet._row(pp, q) for q in range(pp.x.shape[0])]
            for p_ in rows:
                key = "table" if bool(mcl_mod.auto_converged(p_, lf_field, cfg_)) else "direct"
                seen[key] = seen.get(key, 0) + 1
        return observe

    for label, a_cfg_, make in (
            ("converged", au_cfg,
             lambda: mcl_mod.init(mcl_mod.make_generator(0, dev), SLAM_PARTICLES,
                                  Pose.create(400.0, 400.0, math.pi, device=dev))),
            ("dispersed", dataclasses.replace(au_cfg, ess_threshold=0.0),
             lambda: mcl_mod.init_uniform(mcl_mod.make_generator(0, dev), SLAM_PARTICLES,
                                          blocked))):
        au_eng = mcl_mod.MCL(a_cfg_, au_slam.raycast, device=dev)
        cases[f"auto_step_1m_{label}"] = dict(
            graphs=au_eng.graphs, init=make,
            graph=lambda st, k, e=au_eng: e.step(st, au_odom[k], au_slam.motion.alphas,
                                                 au_scans[k], lf_field),
            eager=lambda st, k, c_=a_cfg_: mcl_mod.step(st, au_odom[k], au_slam.motion.alphas,
                                                        au_scans[k], lf_field, c_,
                                                        au_slam.raycast),
            observe=tier_seen(a_cfg_))

    fa_cfg = dataclasses.replace(f_cfg, measurement="likelihood_field_auto", lf_table_box=128)
    fa_rc = au_slam.raycast
    fa = fleet.MCLFleet(r, fa_cfg, fa_rc, seed=0, device=dev)

    def fa_init():
        st = fa.init(f_poses)
        p_ = st.particles.pose
        x, y, th = p_.x.clone(), p_.y.clone(), p_.theta.clone()
        for q in range(1, r, 2):  # the odd robots woke up lost
            u = mcl_mod.init_uniform(mcl_mod.make_generator(100 + q, dev), FLEET_N, blocked)
            x[q], y[q], th[q] = u.particles.pose.x, u.particles.pose.y, u.particles.pose.theta
        return st.replace(particles=st.particles.replace(pose=Pose(x=x, y=y, theta=th)))

    cases["fleet_auto_16x100k"] = dict(
        graphs=fa.graphs, init=fa_init,
        graph=lambda st, k: fa.step(st, f_odom[k], f_scans[k], lf_field, fb.ALPHAS),
        eager=lambda st, k: fleet.fleet_step(st, f_odom[k], f_scans[k], lf_field, fb.ALPHAS,
                                             fa_cfg, fa_rc),
        observe=tier_seen(fa_cfg))

    es_cfg = dataclasses.replace(cfg, n_particles=SLAM_PARTICLES, ess_threshold=0.5)
    es_eng = mcl_mod.MCL(es_cfg, rc, device=dev)

    def resampled(before, after, seen):
        lw = after.particles.log_weight
        key = "resampled" if bool((lw == lw[0]).all()) else "kept"
        seen[key] = seen.get(key, 0) + 1

    cases["ess05_mcl_1m"] = dict(
        graphs=es_eng.graphs,
        init=lambda: mcl_mod.init(mcl_mod.make_generator(0, dev), SLAM_PARTICLES, pose0),
        graph=lambda st, k: es_eng.step(st, mcl_odom[k], bench_alphas, mcl_scans[k], field),
        eager=lambda st, k: mcl_mod.step(st, mcl_odom[k], bench_alphas, mcl_scans[k], field,
                                         es_cfg, rc),
        observe=resampled)

    # The RBPF at phase 19's RBPF_PARTICLES maps of the plan (777 MB of u8
    # maps), along a wander whose odometry changes at each step.
    from slam_tpu_torch.models import rbpf

    rb_cfg, rb_rc, rb_lidar = rbpf_config()
    rb_xy, _ = rbpf_start(blocked_np)
    rb_odom = odoms((0.01, 2.5, 0.01), (0.001, 0.0, -0.0005))
    gt, rb_scans = [*rb_xy, math.pi / 2], []
    for o in rb_odom:
        th1 = gt[2] + float(o.rot1)
        gt = [gt[0] + float(o.trans) * math.cos(th1), gt[1] + float(o.trans) * math.sin(th1),
              th1 + float(o.rot2)]
        rb_scans.append(fake_lidar.scan(blocked, measurement.sensor_pose(
            Pose.create(*gt, device=dev), rb_cfg.scanner_offset), rb_lidar, rb_rc))
    rb_eng = rbpf.RBPF(rb_cfg, rb_rc, seed=0, device=dev)
    cases["rbpf_1000"] = dict(
        graphs=rb_eng.graphs,
        init=lambda: rb_eng.init(Pose.create(*rb_xy, math.pi / 2), blocked_np.shape),
        graph=lambda st, k: rb_eng.step(st, rb_odom[k], rb_scans[k]),
        eager=lambda st, k: rbpf.step(st, rb_odom[k], rb_scans[k], rb_cfg, rb_rc))

    # torch's own IF-node API decides the route: where it is missing (torch
    # 2.11) the conditional nodes go through `csrc/graph_cond.cu`.
    import importlib.util

    cond_module = importlib.util.find_spec(
        "torch._higher_order_ops.cudagraph_conditional_nodes") is not None
    out = {"steps": n_in, "cases": {}, "torch": torch.__version__, "conditional_nodes": {
        "CUDAGraph.begin_capture_to_if_node": hasattr(torch.cuda.CUDAGraph,
                                                      "begin_capture_to_if_node"),
        "cudagraph_conditional_nodes module": cond_module,
        "route": "csrc/graph_cond.cu"}, "capture_gc": capture_gc_check(dev)}
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for name, c in cases.items():
        g = c["graphs"]
        g.guard = sync_error  # the warm-up and every replay
        torch.cuda.synchronize()
        reset_counts()
        sg, se = c["init"](), c["init"]()
        n_graph = dict.fromkeys(launches, 0)
        n_eager = dict.fromkeys(launches, 0)
        seen = {}
        for k in range(n_in):
            before = read_counts()
            sg = c["graph"](sg, k)
            mid = read_counts()
            se_before = se
            se = c["eager"](se, k)
            after = read_counts()
            for k_ in launches:
                n_graph[k_] += mid[k_] - before[k_]
                n_eager[k_] += after[k_] - mid[k_]
            diff = state_difference(sg, se)
            check(diff is None, f"graphs {name}: step {k}: graph != eager on the card ({diff})")
            if "observe" in c:
                c["observe"](se_before, se, seen)
        del se_before
        warm = warmup_counts()
        for k_ in launches:
            check(n_graph[k_] == n_eager[k_] + warm[k_],
                  f"graphs {name}: the graph path launched {n_graph} kernels, eager {n_eager} "
                  f"(+ warm-ups {warm})")
        check(sum(n_graph.values()) > 0, f"graphs {name}: no hand-written kernel launched")
        check(n_eager["resample"] > 0, f"graphs {name}: the resampler's chain never launched")
        if name == "fleet_auto_16x100k":  # every robot's predict in one K1 launch
            check(n_eager["motion_odometry"] == n_in,
                  f"graphs {name}: {n_eager['motion_odometry']} K1 launches in {n_in} steps")
        stats = g.stats()
        if_nodes = sum(b["if_nodes"] for b in stats["blocks"].values())
        check(if_nodes == GRAPH_IF_NODES.get(name, 0),
              f"graphs {name}: {if_nodes} IF nodes, not {GRAPH_IF_NODES.get(name, 0)}")
        copies0, bytes0 = g.copies, g.copy_bytes

        # Timed in turns from the compared states, inputs cycling.
        box = {"graph": [sg, 0], "eager": [se, 0]}

        def advance(way):
            b = box[way]
            b[0] = c[way](b[0], b[1] % n_in)
            b[1] += 1

        ms = {"graph": [], "eager": []}
        for _ in range(2):
            for way in ("graph", "eager"):
                torch.cuda.synchronize()
                ms[way].append(event_ms(lambda: [advance(way) for _ in range(GRAPH_ITERS)])
                               / GRAPH_ITERS)
        # Profiled over GRAPH_PROFILE steps a way; the wrappers' counts over
        # the same steps (under graphs, the capture's tally added at each
        # replay) held to the runs of their kernels in the trace.
        prof, ran = {}, {}
        for way in ("graph", "eager"):
            counts_at = {}

            def counted_steps():
                counts_at["before"] = read_counts()
                for _ in range(GRAPH_PROFILE):
                    advance(way)
                counts_at["after"] = read_counts()

            prof[way] = planner_profile(counted_steps)
            runs = prof[way]["hand_written_kernels_ran"]
            counted = {k_: counts_at["after"][k_] - counts_at["before"][k_] for k_ in launches}
            ran[way] = {"counted": counted, "profiled": runs}
            check(runs == counted,
                  f"graphs {name}: {way}: the profiler saw {runs} runs of the hand-written "
                  f"kernels, their wrappers counted {counted}")
        n_prof = GRAPH_PROFILE
        res = {way: {"ms_per_step": spread(ms[way]),
                     "device_ms_per_step": prof[way]["device_ms_per_solve"] / n_prof,
                     "kernels_per_step": prof[way]["launches_per_solve"] / n_prof,
                     "host_issued_per_step": prof[way]["host_issued_per_solve"] / n_prof,
                     "host_issued": {k_: v / n_prof for k_, v in prof[way]["host_issued"].items()},
                     "top": [[k_, ms_ / n_prof, n_ / n_prof]
                             for k_, ms_, n_ in prof[way]["top"][:4]]}
               for way in ("graph", "eager")}
        steps_timed = box["graph"][1]
        c_after = read_counts()
        for k_ in launches:
            launches[k_] += c_after[k_]
        res.update(blocks=stats["blocks"],
                   pool_bytes=sum(b["pool_bytes"] for b in stats["blocks"].values()),
                   capture_ms=sum(b["capture_ms"] for b in stats["blocks"].values()),
                   state_copies_per_step=(g.copies - copies0) / steps_timed,
                   state_copy_bytes_per_step=(g.copy_bytes - bytes0) / steps_timed,
                   launches_compared={"graph": n_graph, "eager": n_eager, "warm_ups": warm},
                   kernels_profiled=ran,
                   if_nodes=if_nodes,
                   graph_equals_eager=True, **({"chose": seen} if seen else {}))
        out["cases"][name] = res
        say("graphs", f"{name}: graph == eager bit for bit over {n_in} steps; "
            f"{json.dumps(res)}")
        g.guard = contextlib.nullcontext
        del sg, se, box
        c.clear()
        torch.cuda.empty_cache()
    branches = {}
    for name in ("slam_edt512_1m", "maze_slam_e1024_10k"):
        for key, n_ in out["cases"][name]["chose"].items():
            branches[key] = branches.get(key, 0) + n_
    check(set(branches) == {"no flip", "window", "full"},
          f"graphs: the edt_box steps took the refresh branches {branches}: all three must run")
    tiers = out["cases"]["auto_step_1m_dispersed"]["chose"]
    check(set(tiers) | set(out["cases"]["auto_step_1m_converged"]["chose"]) == {"table", "direct"},
          f"graphs: the auto steps took tiers {tiers}: both must run")
    out["edt_refresh_branches"] = branches
    rb = out["cases"]["rbpf_1000"]["graph"]["host_issued_per_step"]
    check(rb <= RBPF_HOST_CALLS, f"graphs rbpf_1000: {rb} host-issued calls a step > "
          f"{RBPF_HOST_CALLS}")
    out["launches"] = launches
    return out


def entry_phase(dev, counts) -> dict:
    """Phase 26: `slam_tpu_torch/entry.py`, the counterpart of
    `__graft_entry__.py`. `entry()` on the card: ENTRY_STEPS chained steps
    of its step function through `StepGraphs` (one CUDA graph replay a
    step, every warm-up and replay under set_sync_debug_mode("error"))
    against the eager step from a cloned state, equal bit for bit after
    every step; then `dryrun_multichip(2)` and `dryrun_multichip(4)` at
    once, as ranks sharing the card (gloo), each rank one process: every
    rank exits 0 with finite states, the ranks of a world report the same
    HA* results, and the two worlds agree on their common queries."""
    import concurrent.futures

    from slam_tpu_torch import entry as entry_mod
    from slam_tpu_torch.models._graph import StepGraphs

    reset_counts, read_counts = counts
    t0 = time.perf_counter()
    reset_counts()
    fn, (state, odom, scan) = entry_mod.entry()
    graphs = StepGraphs()
    graphs.guard = sync_error
    a, b = state, entry_mod.clone_state(state)
    for k in range(ENTRY_STEPS):
        a = graphs.run(fn, a, odom, scan)
        b = fn(b, odom, scan)
        diff = entry_mod.state_difference(a, b)
        check(diff is None, f"entry: step {k}: graph != eager on the card ({diff})")
    torch.cuda.synchronize()
    launches = read_counts()
    box = {"graph": a, "eager": b}

    def advance(way):
        box[way] = (graphs.run(fn, box[way], odom, scan) if way == "graph"
                    else fn(box[way], odom, scan))

    ms = {"graph": [], "eager": []}
    for _ in range(2):
        for way in ("graph", "eager"):
            torch.cuda.synchronize()
            ms[way].append(event_ms(lambda: [advance(way) for _ in range(GRAPH_ITERS)])
                           / GRAPH_ITERS)
    graphs.guard = contextlib.nullcontext
    out = {"steps": ENTRY_STEPS, "graph_equals_eager": True,
           "ms_per_step": {w: spread(v) for w, v in ms.items()},
           "capture_ms": sum(blk["capture_ms"] for blk in graphs.stats()["blocks"].values())}
    with concurrent.futures.ThreadPoolExecutor(len(ENTRY_WORLDS)) as pool:
        runs = {n: pool.submit(entry_mod.dryrun_multichip, n, timeout_s=ENTRY_DRYRUN_LIMIT_S)
                for n in ENTRY_WORLDS}
        worlds = {n: r.result() for n, r in runs.items()}
    for n, r in worlds.items():
        for rank in r["ranks"]:
            check([tuple(v) for v in rank["hastar"]] == r["hastar"],
                  f"entry: dryrun world {n}: rank {rank['rank']}'s HA* results differ")
        out[f"dryrun_{n}"] = {"label": f"{n} ranks sharing one card ({r['ranks'][0]['backend']})",
                              "seconds": r["seconds"], "hastar": r["hastar"],
                              "layouts": sorted(r["ranks"][0]["finite"]),
                              "every_rank_exit_0": True}
    small, large = (worlds[n]["hastar"] for n in ENTRY_WORLDS)
    check(large[:len(small)] == small, f"entry: the dryrun worlds' HA* results differ: "
          f"{small} vs {large}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out


def padded_phase(dev, field, field_u8, clouds, scan, cfg, rc, odom, alphas, counts) -> dict:
    """Phase 27: the port's public names on the card, and both kernels on
    row-padded tables (`lut.pad_lut_rows`: the floor plan's 360-bin bf16
    table in rows of 512, its u8 table in rows of 384) against the same
    tables unpadded. K2 on the padded rows == rows[idx] exactly and the
    panorama rows of the bench cloud == the unpadded table's; the fused
    kernel's poses and weights == its launch on the unpadded table bit for
    bit on the bench cloud, 100k poses over free space, step 1 of the 1M
    uniform cloud and phase 6's adversarial clouds (the table's last cell,
    off the map, wrapping segments, a shard at i0 != 0); both kernels timed
    padded against unpadded in turns beside their bounds (K2 also beside
    `index_select`); `MCL.step` through its CUDA graph with the padded bf16
    field == with the unpadded field over PAD_STEPS steps (states and
    generators) and the earlier panorama-row route (K1, K2, plain weights)
    likewise, then graphed ms/step both ways in turns; `MCL.update(state,
    scan, blocked=<bool grid>)` == the call with the mask's RayField. The
    launch counts are the padded steps' (the slice's main path)."""
    import slam_tpu_torch
    from slam_tpu_torch import Pose as TopPose
    from slam_tpu_torch.core.config import RaycastConfig
    from slam_tpu_torch.core.types import Odometry, Pose
    from slam_tpu_torch.entry import _bits, clone_state, state_difference
    from slam_tpu_torch.models import mcl as mcl_mod
    from slam_tpu_torch.models.simulate import forward_arc_commands
    from slam_tpu_torch.ops import lut as lutlib
    from slam_tpu_torch.ops import lut_weights_cuda, measurement, motion_cuda, pano_cuda, rayfield
    from slam_tpu_torch.tools import _ab
    from slam_tpu_torch.tools import global_loc_bench as glb

    reset_counts, read_counts = counts
    t_phase = time.perf_counter()
    gather, fused = pano_cuda.gather_rows, lut_weights_cuda.launch
    h, w = field.blocked.shape
    n_bins = field.lut_bins
    out = {}

    # The names a user reaches from the package.
    check(TopPose is Pose, "from slam_tpu_torch import Pose is not core.types.Pose")
    check(slam_tpu_torch.ops.lut.pad_lut_rows is lutlib.pad_lut_rows,
          "slam_tpu_torch.ops.lut.pad_lut_rows does not resolve")
    check(slam_tpu_torch.ops.edt.edt_jfa_refresh is slam_tpu_torch.ops.edt.edt_refresh,
          "slam_tpu_torch.ops.edt.edt_jfa_refresh is not edt_refresh")

    # The padded tables.
    tables = {"bf16": field.lut, "u8": field_u8.lut}
    padded = {k: lutlib.pad_lut_rows(v) for k, v in tables.items()}
    out["tables"] = {}
    for k, t in tables.items():
        p = padded[k]
        width = lutlib.padded_bins(n_bins, t.dtype)
        check(p.shape == (h, w, width) and width > n_bins and p.is_contiguous(),
              f"pad_lut_rows {k}: shape {tuple(p.shape)}")
        check(torch.equal(_bits(p[..., :n_bins]), _bits(t)) and not bool(_bits(p[..., n_bins:])
                                                                        .any()),
              f"pad_lut_rows {k}: the rows or the zero pad differ")
        out["tables"][k] = {"cells": h * w, "row_bins": width,
                            "row_bytes": width * p.element_size(),
                            "mb": p.numel() * p.element_size() / 1e6,
                            "unpadded_mb": t.numel() * t.element_size() / 1e6}
    say("padded", f"pad_lut_rows on the card: {json.dumps(out['tables'])}")

    # K2 on the padded rows: exact, and the panorama rows of the bench
    # cloud == the unpadded table's (the pad bins sliced off).
    g = torch.Generator(device=dev)
    g.manual_seed(27)
    ridx = torch.randint(0, h * w, (N_PARTICLES,), generator=g, device=dev, dtype=torch.int32)
    edge = torch.tensor([0, h * w - 1, h * w - 1, 0, 7, h * w - 2], dtype=torch.int32,
                        device=dev)
    rows = {f"{k}_{t.shape[-1]}": t.reshape(h * w, t.shape[-1])
            for k in tables for t in (tables[k], padded[k])}
    vectors = {}
    for name, r in rows.items():
        for ix in (ridx, edge):
            got = gather(r, ix)
            check(torch.equal(_bits(got), _bits(r[ix.long()])), f"K2 {name} != rows[idx]")
        vectors[name] = pano_cuda.vector_bytes(r.shape[1] * r.element_size(), r.data_ptr(),
                                               got.data_ptr())
    bench = clouds[0][1]
    sp = measurement.sensor_pose(bench, cfg.scanner_offset)
    for k in tables:
        a, ia = lutlib.panorama_rows(tables[k], sp.x, sp.y, n_bins)
        b, ib = lutlib.panorama_rows(padded[k], sp.x, sp.y, n_bins)
        check(b.shape == a.shape and torch.equal(_bits(a), _bits(b)) and torch.equal(ia, ib),
              f"panorama_rows on the padded {k} table != unpadded")
    bench_idx = lutlib.panorama_index((h, w), sp.x, sp.y)[0].contiguous()
    idx_sets = {"random_100k": ridx, "bench": bench_idx}
    k2_fns = {}
    for rn, r in rows.items():
        for iname, ix in idx_sets.items():
            k2_fns[f"{rn}_{iname}"] = lambda r=r, ix=ix: gather(r, ix)
        k2_fns[f"{rn}_random_100k_index_select"] = lambda r=r: torch.index_select(r, 0, ridx)
    k2_ms = _ab.in_turns(list(k2_fns), lambda name: k2_fns[name], ridx, PAD_ROUNDS)
    k2 = {}
    for rn, r in rows.items():
        rb = r.shape[1] * r.element_size()
        for iname, ix in idx_sets.items():
            b_ = bound(ix.numel() * (rb + 4) + int(torch.unique(ix).numel()) * rb, 0)
            ms = k2_ms[f"{rn}_{iname}"]["median"]
            k2[f"{rn}_{iname}"] = {"ms": ms, "ms_spread": k2_ms[f"{rn}_{iname}"],
                                   "bound_ms": b_[0], "bound_by": b_[1],
                                   "bound_share": b_[0] / ms, "vector_bytes": vectors[rn]}
        k2[f"{rn}_random_100k"]["library_ms"] = k2_ms[f"{rn}_random_100k_index_select"]["median"]
    out["k2"] = k2
    say("padded", f"K2 on rows of 360 and 512 bf16, 360 and 384 u8: == rows[idx] exactly on "
        f"{N_PARTICLES} random and the edge indices; panorama rows of the bench cloud padded "
        f"== unpadded; device ms in turns ({PAD_ROUNDS} rounds) {json.dumps(k2)}")

    # The fused kernel: padded == unpadded bit for bit on four clouds.
    n_beams = scan.angles.shape[0]
    wkw = dict(beam_stride=cfg.lut_beam_stride,
               displacement=measurement.scanner_displacement(cfg.scanner_offset),
               max_dist=rc.max_dist, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon)
    seed = torch.tensor([12], dtype=torch.int64, device=dev)
    motion = (seed, motion_cuda.odometry_rows(odom, dev), alphas)
    lidar_g, rc_g, scan_rc_g, cfg_g = glb.configs(GL_PARTICLES)
    cmds = forward_arc_commands(1, trans=2.5, rot=0.04)
    _, scans_g = glb.truth_and_scans(field.blocked, lidar_g, scan_rc_g, cfg_g, 0, cmds)
    cloud_1m = mcl_mod.init_uniform(mcl_mod.make_generator(0, dev), GL_PARTICLES,
                                    field.blocked).particles.pose
    gkw = dict(beam_stride=cfg_g.lut_beam_stride,
               displacement=measurement.scanner_displacement(cfg_g.scanner_offset),
               max_dist=rc_g.max_dist, stddev=cfg_g.meas_stddev, eps=cfg_g.meas_epsilon)
    span = cfg.lut_beam_stride * (n_beams - 1) + 1
    xyz, kinds = adversarial_poses(h, w, n_bins, RAGGED_N, span, wkw["displacement"],
                                   float(scan.angles[0]), np.random.default_rng(271))
    adv = Pose(*(torch.from_numpy(v).to(dev) for v in xyz))
    zero = (torch.tensor([31], dtype=torch.int64, device=dev),
            motion_cuda.odometry_rows(Odometry.create(0.0, 0.0, 0.0), dev), alphas)
    cases = {"bench": (bench, scan, cfg, wkw, motion),
             "free_space": (clouds[1][1], scan, cfg, wkw, motion),
             "uniform_1m": (cloud_1m, scans_g[0], cfg_g, gkw,
                            (torch.tensor([13], dtype=torch.int64, device=dev),
                             motion_cuda.odometry_rows(cmds[0], dev), glb.ALPHAS)),
             "adversarial": (adv, scan, cfg, wkw, zero)}
    lw = {}
    i0 = RAGGED_N // 3
    luts = {f"{k}_{t.shape[-1]}": t for k in tables for t in (tables[k], padded[k])}
    names = list(luts)
    for case, (poses, z, cfg_c, kw, mo) in cases.items():
        for k in tables:
            ref = fused(tables[k], n_bins, poses, z, motion=mo, **kw)
            got = fused(padded[k], n_bins, poses, z, motion=mo, **kw)
            only = fused(padded[k], n_bins, ref[0], z, **kw)[1]
            for f in ("x", "y", "theta"):
                check(torch.equal(_bits(getattr(ref[0], f)), _bits(getattr(got[0], f))),
                      f"lut_weights {case} {k}: padded poses != unpadded ({f})")
            check(torch.equal(_bits(ref[1]), _bits(got[1])) and torch.equal(
                _bits(ref[1]), _bits(only)), f"lut_weights {case} {k}: padded weights != unpadded")
            check(bool(torch.isfinite(got[1]).all()), f"lut_weights {case} {k}: non-finite")
            if case == "adversarial":
                part = Pose(*(v[i0:].contiguous() for v in (poses.x, poses.y, poses.theta)))
                ps, lws = fused(padded[k], n_bins, part, z, motion=mo, i0=i0, **kw)
                check(torch.equal(_bits(ps.x), _bits(got[0].x[i0:])) and torch.equal(
                    _bits(lws), _bits(got[1][i0:])),
                    f"lut_weights {case} {k}: the padded shard at i0 = {i0} != the slice")
            spk = measurement.sensor_pose(got[0], cfg_c.scanner_offset)
            pidx, inb = lutlib.panorama_index((h, w), spk.x, spk.y)
            n = poses.x.numel()
            b_ = bound(n * (12 + 12 + 4) + int(torch.unique(pidx).numel()) * z.angles.shape[0]
                       * tables[k].element_size() + z.angles.shape[0] * 8 + 8,
                       n * (OPS_SAMPLE + OPS_LOCATE + z.angles.shape[0] * OPS_BEAM))
            lw[f"{case}_{k}"] = {"particles": n, "off_map": int((~inb).sum()),
                                 "distinct_cells": int(torch.unique(pidx).numel()),
                                 "bound_ms": b_[0], "bound_by": b_[1]}
        ms = _ab.in_turns(names, lambda name: lambda: fused(luts[name], n_bins, poses, z,
                                                            motion=mo, **kw),
                          poses.x, PAD_ROUNDS)
        for k in tables:
            rec = lw[f"{case}_{k}"]
            for name in names:
                if name.startswith(k):
                    tag = "padded" if luts[name].shape[-1] > n_bins else "unpadded"
                    rec[f"ms_{tag}"] = ms[name]["median"]
                    rec[f"ms_{tag}_spread"] = ms[name]
                    rec[f"bound_share_{tag}"] = rec["bound_ms"] / ms[name]["median"]
            rec["padded_over_unpadded"] = rec["ms_padded"] / rec["ms_unpadded"]
        say("padded", f"lut_weights {case}: padded == unpadded bit for bit (poses, weights, "
            f"weigh-only{'; the shard at i0 = %d == the slice' % i0 if case == 'adversarial' else ''}"
            f"), bf16 and u8; {json.dumps({k: lw[f'{case}_{k}'] for k in tables})}")
    out["adversarial_kinds"] = {name: int((kinds == i).sum())
                                for i, name in enumerate(ADVERSARIAL_KINDS)}
    out["lut_weights"] = lw
    del cloud_1m

    # MCL.step through its CUDA graph with the padded bf16 field: the
    # slice's main path, counted; then the unpadded field's steps == it.
    pose0 = Pose.create(400.0, 400.0, math.pi, device=dev)
    fields = {"padded": rayfield.RayField(blocked=field.blocked, lut=padded["bf16"],
                                          lut_bins=n_bins), "unpadded": field}
    engines = {name: mcl_mod.MCL(cfg, rc, device=dev) for name in fields}
    for e in engines.values():
        e.graphs.guard = sync_error

    def init():
        return mcl_mod.init(mcl_mod.make_generator(0, dev), N_PARTICLES, pose0)

    def k2_route(st, f):
        st = mcl_mod.predict(st, odom, alphas)
        sp_ = measurement.sensor_pose(st.particles.pose, cfg.scanner_offset)
        pano, inb_ = lutlib.panorama_rows(f.lut, sp_.x, sp_.y, f.lut_bins)
        lw_ = measurement.pano_log_weights(
            pano, inb_, sp_.theta, scan, n_bins=n_bins, beam_stride=cfg.lut_beam_stride,
            lut_dtype=f.lut.dtype, max_dist=rc.max_dist, stddev=cfg.meas_stddev,
            eps=cfg.meas_epsilon)
        return mcl_mod._finish(st, lw_, cfg)

    reset_counts()
    st, saved = init(), []
    for _ in range(PAD_STEPS):
        st = engines["padded"].step(st, odom, alphas, scan, fields["padded"])
        saved.append(clone_state(st))
    k2_st, k2_saved = init(), []
    for _ in range(PAD_K2_STEPS):
        k2_st = k2_route(k2_st, fields["padded"])
        k2_saved.append(clone_state(k2_st))
    torch.cuda.synchronize()
    launches, warm = read_counts(), warmup_counts()
    check(launches["lut_weights"] >= PAD_STEPS and launches["gather_rows"] == PAD_K2_STEPS
          and launches["motion_odometry"] == PAD_K2_STEPS,
          f"padded path launches {launches} (warm-ups {warm})")
    box = {"padded": st}
    st = init()
    for k in range(PAD_STEPS):
        st = engines["unpadded"].step(st, odom, alphas, scan, fields["unpadded"])
        diff = state_difference(saved[k], st)
        check(diff is None, f"MCL.step padded != unpadded after step {k} ({diff})")
    box["unpadded"] = st
    st = init()
    for k in range(PAD_K2_STEPS):
        st = k2_route(st, fields["unpadded"])
        diff = state_difference(k2_saved[k], st)
        check(diff is None, f"panorama-row route padded != unpadded after step {k} ({diff})")
    del saved, k2_saved

    def advance(name):
        box[name] = engines[name].step(box[name], odom, alphas, scan, fields[name])

    step_ms = {name: [] for name in fields}
    for r in range(PAD_ROUNDS):
        for name in (list(fields) if r % 2 == 0 else list(fields)[::-1]):
            torch.cuda.synchronize()
            step_ms[name].append(event_ms(lambda: [advance(name) for _ in range(PAD_STEPS)])
                                 / PAD_STEPS)
    out["mcl_step"] = {"steps_equal": PAD_STEPS, "k2_route_steps_equal": PAD_K2_STEPS,
                       "graph_ms_per_step": {n_: spread(v) for n_, v in step_ms.items()}}
    say("padded", f"MCL.step through its graph, padded bf16 field == unpadded bit for bit over "
        f"{PAD_STEPS} steps (states, generators), the panorama-row route over {PAD_K2_STEPS}; "
        f"{json.dumps(out['mcl_step'])}; launches {launches} (warm-ups {warm})")

    # MCL.update under JAX's keyword, on a raw bool grid (the march).
    rc_m = RaycastConfig(step=0.5, max_dist=rc.max_dist, backend="march")
    cfg_m = dataclasses.replace(cfg, n_particles=PAD_MARCH_N, lut_beam_stride=None)
    st = init()
    st = st.replace(particles=st.particles.replace(
        pose=Pose(*(v[:PAD_MARCH_N].contiguous() for v in (bench.x, bench.y, bench.theta))),
        log_weight=st.particles.log_weight[:PAD_MARCH_N].contiguous()))
    a = mcl_mod.MCL(cfg_m, rc_m, device=dev).update(clone_state(st), scan,
                                                     blocked=field.blocked)
    b = mcl_mod.MCL(cfg_m, rc_m, device=dev).update(
        clone_state(st), scan, blocked=rayfield.make_ray_field(field.blocked, rc_m))
    diff = state_difference(a, b)
    check(diff is None and bool(torch.isfinite(a.particles.log_weight).all()),
          f"MCL.update(blocked=<bool grid>) != the RayField call ({diff})")
    out["update_blocked_equal"] = True
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


def resample_phase(dev, counts) -> dict:
    """Phase 28: the systematic resampler's kernel chain
    (`csrc/resample.cu`, `ops/resample_cuda.py`) against the plain path
    (`ops/resample.py:systematic_ends` + `indices_from_ends`, then the
    packed gather) on the card, both from the same torch.softmax weights
    and draws. Clouds: 1M dispersed weights (relocalize's kind), 1M
    collapsed on one particle (a random one, the first, the last), 100k,
    100,003 (not a multiple of the 4096-particle tile), 1000 (the one-tile
    form), N = 1, 16 rows of 100k with the gate off on every third, and 4
    rows of 100k with -inf log weights on every fifth particle of row 2.
    Per cloud: the indices == the plain path's but where the plain draw
    lies within RESAMPLE_EDGE of a bin edge (their count, expected 0), the
    same bits from a second launch, non-decreasing in range; the poses ==
    the packed gather of the kernel's indices bit for bit and the log
    weights -log(n); a gated-off row == its particles and log weights. The
    launch makes no host sync and counts one launch a call. Timed at
    RESAMPLE_TIMED: the chain's device ms (its kernels, from the profiler)
    beside its 32 N bytes bound and the plain chain's device ms, and the
    public `resample.resample` (softmax + chain) beside the previous public
    path (softmax + plain chain)."""
    from slam_tpu_torch.core.types import Particles, Pose, log_f32
    from slam_tpu_torch.ops import resample as res
    from slam_tpu_torch.ops import resample_cuda

    reset_counts, read_counts = counts
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(RESAMPLE_SEED)

    def randn(*shape, scale=6.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def collapsed(at):
        lw = torch.full((SLAM_PARTICLES,), -math.inf, device=dev)
        lw[at] = 0.0
        return lw

    inf_rows = randn(4, N_PARTICLES)
    inf_rows[2, ::5] = -math.inf
    clouds = {
        "dispersed_1m": (randn(SLAM_PARTICLES), None),
        "collapsed_random_1m": (collapsed(int(torch.randint(
            0, SLAM_PARTICLES, (), generator=g, device=dev))), None),
        "collapsed_first_1m": (collapsed(0), None),
        "collapsed_last_1m": (collapsed(SLAM_PARTICLES - 1), None),
        "dispersed_100k": (randn(N_PARTICLES), None),
        "ragged_100003": (randn(RAGGED_N), None),
        "one_tile_1000": (randn(1000), None),
        "one_particle": (randn(1), None),
        "rows_16x100k": (randn(16, N_PARTICLES),
                         torch.arange(16, device=dev) % 3 != 0),
        "minus_inf_4x100k": (inf_rows, None),
    }
    out = {"clouds": {}}
    reset_counts()
    calls = 0
    for name, (lw, gate) in clouds.items():
        rows, n = (1, lw.shape[0]) if lw.dim() == 1 else lw.shape
        w = torch.softmax(lw, dim=-1)
        u0 = torch.rand(lw.shape[:-1], generator=g, device=dev)
        ar = torch.arange(rows * n, dtype=torch.float32, device=dev).reshape(lw.shape)
        pose = Pose(x=ar, y=ar * 0.5 + 1.0, theta=ar * -0.25)
        want = res.indices_from_ends(res.systematic_ends(w, u0))
        with sync_error():
            got = resample_cuda.launch(w, u0)
            again = resample_cuda.launch(w, u0)
            new_pose, new_lw = resample_cuda.launch(w, u0, gate=gate, pose=pose, log_weight=lw)
        calls += 3
        check(torch.equal(got, again), f"resample {name}: two launches differ")
        g2 = got.reshape(rows, n)
        check(bool((g2[:, 1:] >= g2[:, :-1]).all()) and int(got.min()) >= 0
              and int(got.max()) < n, f"resample {name}: indices not non-decreasing in [0, n)")
        differ = torch.nonzero((got != want).reshape(rows, n))
        check(differ.shape[0] <= 1000, f"resample {name}: {differ.shape[0]} slots differ from "
              f"the plain path")
        # The plain draw's distance from the bin edge between the two owners.
        c = torch.cumsum(w.reshape(rows, n), dim=-1, dtype=torch.float64)
        c = c / c[:, -1:]
        gaps = []
        for r_, k in differ.tolist():
            edge = min(int(g2[r_, k]), int(want.reshape(rows, n)[r_, k]))
            gaps.append(abs(float(c[r_, edge]) * n - float(u0.reshape(rows)[r_]) - k) / n)
        check(all(gp <= RESAMPLE_EDGE for gp in gaps),
              f"resample {name}: {len(gaps)} slots differ from the plain path, draws "
              f"{max(gaps, default=0.0)} from an edge")
        on = torch.ones(rows, dtype=torch.bool, device=dev) if gate is None else gate
        packed = res.gather_pose_packed(pose, got)
        full = torch.full_like(lw, -log_f32(n))
        for field_, a, b in (("x", new_pose.x, packed.x), ("y", new_pose.y, packed.y),
                             ("theta", new_pose.theta, packed.theta), ("log_weight", new_lw, full)):
            a2, b2 = a.reshape(rows, n), b.reshape(rows, n)
            check(torch.equal(a2[on], b2[on]), f"resample {name}: {field_} != the gather of "
                  f"its indices")
        for a, b in ((new_pose.x, pose.x), (new_pose.theta, pose.theta), (new_lw, lw)):
            check(torch.equal(a.reshape(rows, n)[~on], b.reshape(rows, n)[~on]),
                  f"resample {name}: a gated-off row changed")
        out["clouds"][name] = {"rows": rows, "particles": n,
                               "gate_off_rows": int((~on).sum()),
                               "slots_differing": len(gaps), "widest_edge_gap": max(gaps, default=0.0),
                               "survivors": int(torch.unique_consecutive(got).numel())}
        say("resample", f"{name}: {json.dumps(out['clouds'][name])}")
    c_ = read_counts()
    check(c_["resample"] == calls, f"resample: {c_['resample']} launches counted for {calls} calls")

    times = {}
    for name in RESAMPLE_TIMED:
        lw = clouds[name][0]
        n = lw.numel()
        w = torch.softmax(lw, dim=-1)
        u0 = torch.rand(lw.shape[:-1], generator=g, device=dev)
        ar = torch.arange(n, dtype=torch.float32, device=dev).reshape(lw.shape)
        pose = Pose(x=ar, y=ar * 0.5, theta=ar * 0.25)
        p_ = Particles(pose=pose, log_weight=lw)

        def chain():
            resample_cuda.launch(w, u0, pose=pose, log_weight=lw)

        def plain():
            res.gather_pose_packed(pose, res.indices_from_ends(res.systematic_ends(w, u0)))
            torch.full_like(lw, -log_f32(lw.shape[-1]))

        def public_plain():
            w_ = torch.softmax(lw, dim=-1)
            res.gather_pose_packed(pose, res.indices_from_ends(res.systematic_ends(w_, u0)))
            torch.full_like(lw, -log_f32(lw.shape[-1]))

        rows_ = kernel_profile(chain)
        ms = sum(r[0] for k, r in rows_.items() if "resample_" in k)
        launches_ = sum(r[1] for k, r in rows_.items() if "resample_" in k)
        b_ms, b_by = bound(32.0 * n, 0.0)
        times[name] = {
            "ms": ms, "kernels_per_call": launches_, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms, "plain_ms": device_ms(plain)[0],
            "public_ms": device_ms(lambda: res.resample(p_, "systematic", u0=u0))[0],
            "public_plain_ms": device_ms(public_plain)[0],
            "softmax_ms": device_ms(lambda: torch.softmax(lw, dim=-1))[0]}
        say("resample", f"timed {name}: {json.dumps(times[name])}")
    out["timed"] = times
    out["seconds"] = time.perf_counter() - t_phase
    return out


def estimate_phase(dev, counts) -> dict:
    """Phase 29: the estimate's kernel chain (`csrc/estimate.cu`,
    `ops/estimate_cuda.py`) against the plain estimate
    (`models/mcl.py:plain_estimate`) on the card, from the same particles.
    Clouds: dispersed at 256 (the one-block form), 4097 (the smallest
    chain), 100k, 1M and 16 rows of 100k; every measurement score equal (a
    majority tie: the best pose is the mode) at 256 and 100k; equal maxima
    of the log weights in different blocks and within one at 1M; -inf on
    every third particle at 1M; two NaNs at 1M (the first wins, the mode is
    NaN); exactly half the scores tied at 82 and 90,002 particles, where
    PyTorch's CUDA mean rounds the share below 0.5; every log weight -inf;
    and 4 rows of 4097 mixing these. Per cloud: the best index == the
    first maximum (torch.argmax), the tie share == the plain path's mean
    and so the informative flag, bit for bit; the best pose == the plain
    best pose bit for bit where informative, else == the kernel's own mode;
    the mode within ESTIMATE_RTOL (x, y) and ESTIMATE_RAD (theta) of the
    plain mode (both NaN where it is). A second launch gives the same bits,
    a CUDA graph's replay the eager call's; the launch makes no host sync;
    one launch is counted a call, `mcl.estimate` among them. Timed at
    ESTIMATE_TIMED: the chain's device ms (its kernels, from the profiler)
    beside its 20 N bytes bound and the plain estimate's device ms."""
    from slam_tpu_torch.core.config import MCLConfig
    from slam_tpu_torch.core.types import Pose
    from slam_tpu_torch.models import mcl as mcl_mod
    from slam_tpu_torch.ops import estimate_cuda

    reset_counts, read_counts = counts
    t_phase = time.perf_counter()
    tau = MCLConfig().mode_tau
    g = torch.Generator(device=dev)
    g.manual_seed(ESTIMATE_SEED)

    def cloud(shape):
        """Poses over the floor plan's extent, a prior and a measurement."""
        u = lambda: torch.rand(shape, generator=g, device=dev)  # noqa: E731
        pose = Pose(x=u() * 1297.0, y=u() * 599.0, theta=(u() * 2.0 - 1.0) * math.pi)
        prior = torch.randn(shape, generator=g, device=dev) * 5.0
        lw = torch.randn(shape, generator=g, device=dev) * 30.0
        return pose, prior, lw

    def planted(shape, edit):
        pose, prior, lw = cloud(shape)
        edit(prior, lw)
        return pose, prior + lw, lw

    def plain(shape):
        pose, prior, lw = cloud(shape)
        return pose, prior + lw, lw

    def equal_scores(prior, lw):
        lw.fill_(-3.5)

    def maxima_apart(prior, lw):
        prior.zero_()
        for i in (700_001, 1000, 1023, 1024, 4096):  # tiles 683, 0, 0, 1, 4: blocks 171, 0, 1, 4
            lw[i] = 900.0

    def minus_inf(prior, lw):
        lw[::3] = -math.inf

    def nans(prior, lw):
        lw[777_777] = math.nan
        lw[333_333] = math.nan

    def half_tied(prior, lw):
        n = lw.shape[-1]
        lw[..., : n // 2] = 40.0
        lw[..., n // 2:] = -40.0

    def all_minus_inf(prior, lw):
        lw.fill_(-math.inf)

    def mixed_rows(prior, lw):
        equal_scores(prior, lw[0])
        lw[1, 17] = math.nan
        lw[2, ::3] = -math.inf
        prior[3].zero_()
        lw[3, 5] = lw[3, 4096] = 900.0  # equal maxima in the row's two blocks

    clouds = {
        "dispersed_256": plain((256,)),
        "dispersed_4097": plain((4097,)),
        "dispersed_100k": plain((N_PARTICLES,)),
        "dispersed_1m": plain((SLAM_PARTICLES,)),
        "rows_16x100k": plain((16, N_PARTICLES)),
        "equal_scores_256": planted((256,), equal_scores),
        "equal_scores_100k": planted((N_PARTICLES,), equal_scores),
        "maxima_apart_1m": planted((SLAM_PARTICLES,), maxima_apart),
        "minus_inf_1m": planted((SLAM_PARTICLES,), minus_inf),
        "nan_1m": planted((SLAM_PARTICLES,), nans),
        "half_tied_82": planted((82,), half_tied),
        "half_tied_90002": planted((90_002,), half_tied),
        "all_minus_inf_4097": planted((4097,), all_minus_inf),
        "mixed_rows_4x4097": planted((4, 4097), mixed_rows),
    }

    def bits(t):
        return t.contiguous().view(torch.int32)

    def same_bits(a, b):
        return torch.equal(bits(a), bits(b))

    def wrapped(a, b):
        d = torch.remainder(a.double() - b.double() + math.pi, 2.0 * math.pi) - math.pi
        return torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d.abs())

    def rel(a, b):
        d = (a.double() - b.double()).abs() / b.double().abs().clamp(min=1.0)
        return torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)

    out = {"mode_tau": tau, "clouds": {}}
    reset_counts()
    calls = 0
    for name, (pose, log_weight, lw) in clouds.items():
        want_best, want_mode = mcl_mod.plain_estimate(pose, log_weight, lw, tau)
        want_idx = torch.argmax(log_weight, dim=-1)
        max_lw = torch.amax(lw, dim=-1, keepdim=True)
        tie_tol = torch.clamp(1e-6 * torch.abs(max_lw), min=1e-6)
        want_share = torch.mean(((max_lw - lw) < tie_tol).to(torch.float32), dim=-1)
        with sync_error():
            best, mode, share, idx = estimate_cuda.launch(pose, log_weight, lw, tau)
            again = estimate_cuda.launch(pose, log_weight, lw, tau)
            routed = mcl_mod.estimate(pose, log_weight, lw, tau)
        calls += 3
        check(all(same_bits(a, b) for a, b in zip(
            (best.x, best.y, best.theta, mode.x, mode.y, mode.theta, share, idx),
            (again[0].x, again[0].y, again[0].theta, again[1].x, again[1].y, again[1].theta,
             again[2], again[3]))), f"estimate {name}: two launches differ")
        check(all(same_bits(a, b) for a, b in zip(
            (best.x, best.y, best.theta, mode.x, mode.y, mode.theta),
            (routed[0].x, routed[0].y, routed[0].theta, routed[1].x, routed[1].y,
             routed[1].theta))), f"estimate {name}: mcl.estimate != the launch")
        check(torch.equal(idx.long(), want_idx), f"estimate {name}: best index {idx.tolist()} "
              f"!= torch.argmax {want_idx.tolist()}")
        check(same_bits(share, want_share), f"estimate {name}: tie share {share.tolist()} != "
              f"the plain mean {want_share.tolist()}")
        informative = want_share < 0.5
        check(torch.equal(share < 0.5, informative), f"estimate {name}: informative differs")
        for field_, a, b, m in (("x", best.x, want_best.x, mode.x),
                                ("y", best.y, want_best.y, mode.y),
                                ("theta", best.theta, want_best.theta, mode.theta)):
            check(same_bits(torch.where(informative, a, a.new_zeros(())),
                            torch.where(informative, b, b.new_zeros(()))),
                  f"estimate {name}: best {field_} != the plain best where informative")
            check(same_bits(torch.where(informative, m, a), m),
                  f"estimate {name}: best {field_} != the mode where uninformative")
        gap_xy = max(float(rel(mode.x, want_mode.x).max()), float(rel(mode.y, want_mode.y).max()))
        gap_th = float(wrapped(mode.theta, want_mode.theta).max())
        nan_mode = torch.isnan(mode.x) | torch.isnan(mode.y) | torch.isnan(mode.theta)
        want_nan = (torch.isnan(want_mode.x) | torch.isnan(want_mode.y)
                    | torch.isnan(want_mode.theta))
        check(torch.equal(nan_mode, want_nan), f"estimate {name}: NaN modes differ")
        check(gap_xy <= ESTIMATE_RTOL and gap_th <= ESTIMATE_RAD,
              f"estimate {name}: mode {gap_xy} relative, {gap_th} rad from the plain mode")
        rows, n = (1, log_weight.shape[0]) if log_weight.dim() == 1 else log_weight.shape
        out["clouds"][name] = {
            "rows": rows, "particles": n, "informative_rows": int(informative.sum()),
            "share": share.reshape(-1)[:4].tolist(), "best_index": idx.reshape(-1)[:4].tolist(),
            "mode_gap_rel": gap_xy, "mode_gap_rad": gap_th, "nan_mode_rows": int(nan_mode.sum())}
        say("estimate", f"{name}: {json.dumps(out['clouds'][name])}")
    c_ = read_counts()
    check(c_["estimate"] == calls, f"estimate: {c_['estimate']} launches counted for {calls} "
          f"calls")

    # A CUDA graph's replay == the eager launch, bit for bit.
    for name in ("dispersed_256", "dispersed_1m", "rows_16x100k", "nan_1m"):
        pose, log_weight, lw = clouds[name]
        eager = estimate_cuda.launch(pose, log_weight, lw, tau)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = estimate_cuda.launch(pose, log_weight, lw, tau)
        for _ in range(2):
            graph.replay()
        torch.cuda.synchronize()
        check(all(same_bits(a, b) for a, b in zip(
            (static[0].x, static[0].y, static[0].theta, static[1].x, static[1].y,
             static[1].theta, static[2], static[3]),
            (eager[0].x, eager[0].y, eager[0].theta, eager[1].x, eager[1].y, eager[1].theta,
             eager[2], eager[3]))), f"estimate {name}: the graph's replay != eager")
        del graph, static
    out["graph_equals_eager"] = True

    times = {}
    for name in ESTIMATE_TIMED:
        pose, log_weight, lw = clouds[name]
        n = log_weight.numel()
        rows_ = kernel_profile(lambda: estimate_cuda.launch(pose, log_weight, lw, tau))
        ms = sum(r[0] for k, r in rows_.items() if "estimate_" in k)
        b_ms, b_by = bound(20.0 * n, 0.0)
        times[name] = {
            "ms": ms, "kernels_per_call": sum(r[1] for k, r in rows_.items() if "estimate_" in k),
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
            "plain_ms": device_ms(lambda: mcl_mod.plain_estimate(pose, log_weight, lw, tau))[0],
            "softmax_ms": device_ms(lambda: torch.softmax(log_weight * tau, dim=-1))[0]}
        say("estimate", f"timed {name}: {json.dumps(times[name])}")
    out["timed"] = times
    out["seconds"] = time.perf_counter() - t_phase
    return out


def plain_fidelity(fn):
    """`fn()` with `ops/mapping.py`'s fidelity update on its plain path
    (`_fidelity_chunk` and `last_lanes`) on the card too."""
    from slam_tpu_torch.ops import mapping

    saved = mapping._kernels
    mapping._kernels = lambda dev: False
    try:
        return fn()
    finally:
        mapping._kernels = saved


def hold_rbpf_fidelity(maps, pose, scan, kw, what: str = "rbpf_fidelity") -> dict:
    """The fidelity update (`mapping.fidelity_measurement_and_mapping(maps,
    pose, scan, **kw)`) through the kernels of `ops/rbpf_fidelity_cuda.py`
    against its plain path, both on the card: the log weights and maps bit
    for bit, one launch of each kernel a chunk (`mapping._fidelity_spans`)
    and none on the plain path, and the first chunk's hits and their
    distances against `_fidelity_chunk`'s. Returns the kernels' log
    weights ("lw"), maps ("maps") and first chunk's hits ("hit_any"), and
    the chunks ("spans")."""
    from slam_tpu_torch.ops import mapping, rbpf_fidelity_cuda

    n, h, w = maps.shape
    step, max_dist = kw["step"], kw["max_dist"]
    k_total = int(math.ceil(max_dist / step))
    spans_ = mapping._fidelity_spans(n, scan.angles.shape[0], k_total)
    kernels = (rbpf_fidelity_cuda.march, rbpf_fidelity_cuda.write)
    before = [k.launches for k in kernels]
    lw, new = mapping.fidelity_measurement_and_mapping(maps, pose, scan, **kw)
    launched = [k.launches - b for k, b in zip(kernels, before)]
    check(launched == [len(spans_)] * 2,
          f"{what}: launches {launched} != one of each a chunk ({len(spans_)})")
    plw, pnew = plain_fidelity(
        lambda: mapping.fidelity_measurement_and_mapping(maps, pose, scan, **kw))
    check([k.launches - b for k, b in zip(kernels, before)] == launched,
          f"{what}: the plain path launched a kernel")
    check(torch.equal(lw, plw), f"{what}: log weights != the plain path's")
    check(torch.equal(new, pnew), f"{what}: maps != the plain path's")
    del plw, pnew
    sp = mapping._fidelity_sensors(pose, kw["scanner_offset"])
    n0, n1 = spans_[0]
    hd, ha = rbpf_fidelity_cuda.march(*mapping._fidelity_rays(maps, sp, scan, n0, n1),
                                      step=step, k_total=k_total)
    phd, pha = mapping._fidelity_chunk(maps.reshape(-1), n0, n1, (h, w), sp, scan, step=step,
                                       max_dist=max_dist)[:2]
    check(torch.equal(hd, phd) and torch.equal(ha, pha),
          f"{what}: the first chunk's hits != the plain path's")
    return {"lw": lw, "maps": new, "hit_any": ha, "spans": spans_}


def rbpf_fidelity_phase(dev, blocked_np) -> dict:
    """Phase 30: the RBPF's march and map write kernels
    (`ops/rbpf_fidelity_cuda.py`, `csrc/rbpf_fidelity.cu`) against the
    plain path (`ops/mapping.py:_fidelity_chunk` with `last_lanes`, run on
    the card) at phase 19's shapes (`hold_rbpf_fidelity`), along
    RBPF_FIDELITY_FRAMES frames of its wander from maps at 128. Then the
    last frame with every second beam cut to RBPF_POST_PX, so that beams of
    one particle write one cell with both updates: held the same way, and
    the first writer's maps (the plain path with `portbench/faults_rbpf.py`'s
    `first_lane`, on CPU copies of RBPF_POST_FEW particles) differ. On the
    last frame: each kernel's device ms over the step's chunks beside the
    plain path's march (`_fidelity_chunk`) and write (`_plain_write`) over
    the same chunks, the whole update both ways, the steps the beams
    marched against K and the cells written, which give each kernel's
    least-time bound."""
    from portbench import faults_rbpf
    from slam_tpu_torch.core.types import Pose, Scan
    from slam_tpu_torch.models import fake_lidar
    from slam_tpu_torch.ops import mapping, rbpf_fidelity_cuda
    from slam_tpu_torch.ops.measurement import sensor_pose

    t0 = time.perf_counter()
    cfg, rc, lidar = rbpf_config()
    blocked = torch.from_numpy(blocked_np).to(dev)
    h, w = blocked_np.shape
    n, b_n, step = RBPF_PARTICLES, lidar.n_rays, rc.step
    k_total = int(math.ceil(rc.max_dist / step))
    kw = dict(scanner_offset=cfg.scanner_offset, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon,
              max_dist=rc.max_dist, step=step)
    spans_ = mapping._fidelity_spans(n, b_n, k_total)
    g = torch.Generator(device=dev).manual_seed(30)
    start_xy, _ = rbpf_start(blocked_np)
    gt = [*start_xy, math.pi / 2]
    maps = torch.full((n, h, w), 128, dtype=torch.uint8, device=dev)

    frames = []
    for _ in range(RBPF_FIDELITY_FRAMES):
        th1 = gt[2] + 0.01
        gt = [gt[0] + 2.5 * math.cos(th1), gt[1] + 2.5 * math.sin(th1), th1 + 0.01]
        scan = fake_lidar.scan(blocked, sensor_pose(Pose.create(*gt, device=dev),
                                                    cfg.scanner_offset), lidar, rc)
        pose = Pose(*(v + s * torch.randn(n, generator=g, device=dev) for v, s in
                      ((gt[0], RBPF_FIDELITY_SPREAD), (gt[1], RBPF_FIDELITY_SPREAD),
                       (gt[2], 0.02))))
        held = hold_rbpf_fidelity(maps, pose, scan, kw)
        frames.append({"hit_share": float(held["hit_any"].float().mean()),
                       "cells_changed": int((held["maps"] != maps).sum())})
        maps = held["maps"]
    check(frames[0]["hit_share"] == 0.0 and frames[-1]["hit_share"] > 0.0,
          f"rbpf_fidelity: hit shares {[f['hit_share'] for f in frames]}: none at first, some "
          "after the walls are written")

    # The last-lane rule: cells that beams of one particle write with both
    # updates, which the wander's frames never make.
    cut = scan.dists.clone()
    cut[1::2] = RBPF_POST_PX
    posts = Scan(angles=scan.angles, dists=cut)
    held = hold_rbpf_fidelity(maps, pose, posts, kw, "rbpf_fidelity posts")
    few = slice(0, RBPF_POST_FEW)
    with faults_rbpf.planted("first_lane"):
        _, first = mapping.fidelity_measurement_and_mapping(
            maps[few].cpu(), Pose(*(v[few].cpu() for v in (pose.x, pose.y, pose.theta))),
            posts.to("cpu"), **kw)
    posts_out = {"cells_changed": int((held["maps"] != maps).sum()),
                 "first_writer_cells_differ": int((first != held["maps"][few].cpu()).sum())}
    check(posts_out["first_writer_cells_differ"] > 0,
          "rbpf_fidelity posts: the first writer's maps equal the last writer's, so the frame "
          "does not test the last-lane rule")
    del held, first

    # The last frame's scan and particles, timed.
    sp = mapping._fidelity_sensors(pose, cfg.scanner_offset)
    ray = [mapping._fidelity_rays(maps, sp, scan, a, b) for a, b in spans_]
    steps = [torch.empty((b - a, b_n), dtype=torch.int32, device=dev) for a, b in spans_]
    for r, s in zip(ray, steps):
        rbpf_fidelity_cuda.march(*r, step=step, k_total=k_total, steps=s)
    marched = int(torch.cat(steps).sum(dtype=torch.int64))
    out = maps.clone()
    dists = scan.dists.contiguous()
    wkw = dict(step=step, k_total=k_total, max_dist=rc.max_dist,
               occ_scale=mapping._u8_scale(mapping._LOCC / mapping._L0),
               free_scale=mapping._u8_scale(mapping._LFREE / mapping._L0))
    march_ms = cuda_ms(lambda: [rbpf_fidelity_cuda.march(*r, step=step, k_total=k_total)
                                for r in ray])
    write_ms = cuda_ms(lambda: [rbpf_fidelity_cuda.write(*r, dists, out[a:b], **wkw)
                                for r, (a, b) in zip(ray, spans_)])
    update_ms = cuda_ms(lambda: mapping.fidelity_measurement_and_mapping(maps, pose, scan, **kw))
    plain_ms = plain_fidelity(lambda: cuda_ms(
        lambda: mapping.fidelity_measurement_and_mapping(maps, pose, scan, **kw),
        iters=3, warmup=1))

    def plain_chunks():
        return [mapping._fidelity_chunk(maps.reshape(-1), a, b, (h, w), sp, scan, step=step,
                                        max_dist=rc.max_dist) for a, b in spans_]

    plain_march_ms = cuda_ms(plain_chunks, iters=3, warmup=1)
    lanes = [c[2:] for c in plain_chunks()]  # (flat, updated, write) a chunk
    written = sum(int(torch.unique(f.reshape(-1)[wr.reshape(-1)]).numel()) for f, _, wr in lanes)
    plain_write_ms = cuda_ms(lambda: [mapping._plain_write(out, a, b, *c)
                                      for (a, b), c in zip(spans_, lanes)], iters=3, warmup=1)
    del lanes, out
    # Least bytes: a byte each step marched reads, the rays' inputs and the
    # hits (c, s, x, y; hit_dist, hit_any); each written cell's code read
    # and written, the rays and ranges.
    march_bound = bound(marched + n * b_n * 13 + n * 8, marched * OPS_RAY_STEP)
    write_bound = bound(2 * written + n * b_n * 8 + n * 8 + b_n * 4, written * OPS_RAY_STEP)
    return {"particles": n, "beams": b_n, "k": k_total, "chunks": len(spans_),
            "frames": frames, "posts": posts_out, "march_ms": march_ms, "write_ms": write_ms,
            "plain_march_ms": plain_march_ms, "plain_write_ms": plain_write_ms,
            "update_ms": update_ms, "plain_update_ms": plain_ms,
            "steps_marched": marched, "mean_steps_marched": marched / (n * b_n),
            "mean_steps_share_of_k": marched / (n * b_n * k_total), "cells_written": written,
            "march_bound_ms": march_bound[0], "march_bound_by": march_bound[1],
            "write_bound_ms": write_bound[0], "write_bound_by": write_bound[1],
            "seconds": time.perf_counter() - t0}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

    from slam_tpu_torch.core.config import (
        LidarConfig,
        MCLConfig,
        RaycastConfig,
        beam_bin_stride,
    )
    from slam_tpu_torch.core.types import Odometry, Pose, Scan
    from slam_tpu_torch.models import fake_lidar
    from slam_tpu_torch.models import mcl as mcl_mod
    from slam_tpu_torch.ops import _build, lut_weights_cuda, measurement, motion, motion_cuda
    from slam_tpu_torch.ops import lut as lutlib
    from slam_tpu_torch.ops import estimate_cuda, pano_cuda, rayfield, rbpf_fidelity_cuda
    from slam_tpu_torch.ops import resample as resample_mod
    from slam_tpu_torch.ops import resample_cuda
    from slam_tpu_torch.ops.raycast import raycast_march
    from slam_tpu_torch.utils.maps import synthetic_floor_plan

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    gather = pano_cuda.gather_rows
    sampler = motion_cuda.sample_motion_model_odometry_fused
    fused = lut_weights_cuda.launch
    chain = resample_cuda.launch
    estimator = estimate_cuda.launch
    rbpf_march, rbpf_write = rbpf_fidelity_cuda.march, rbpf_fidelity_cuda.write
    wrappers = (gather, sampler, fused, chain, estimator, rbpf_march, rbpf_write)

    def reset_counts():
        for wrapper in wrappers:
            wrapper.launches = wrapper.warmup_launches = 0

    def read_counts():
        return {"gather_rows": gather.launches, "motion_odometry": sampler.launches,
                "lut_weights": fused.launches, "resample": chain.launches,
                "estimate": estimator.launches, "rbpf_march": rbpf_march.launches,
                "rbpf_write": rbpf_write.launches}

    # 1. device -------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say("device", f"{name}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"devices {torch.cuda.device_count()}")
    print(smi, flush=True)

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _lib, info = _build.library()
    say("build", f"{'built' if info['built'] else 'loaded'} {info['path']} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {info['build_s']:.2f} s)")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "stack frame" in line:
            say("build", "ptxas: " + line.strip())

    # 3. K2: exact row gather ----------------------------------------------
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    r_rows, c_cols = 500, 360
    idx = torch.randint(0, r_rows, (777,), generator=g, device=dev, dtype=torch.int32)
    edge = torch.tensor([0, r_rows - 1, r_rows - 1, 0, 7, 7, 7, 1], dtype=torch.int32,
                        device=dev)
    for dt in (torch.float32, torch.bfloat16, torch.uint8):
        for cols in (c_cols, c_cols + 1, c_cols + 4):  # 16/8, 1/4 B vector paths
            rows = torch.randint(0, 256, (r_rows, cols), generator=g, device=dev).to(dt)
            for ix in (idx, edge):
                out = gather(rows, ix)
                torch.cuda.synchronize()
                check(torch.equal(out, rows[ix.long()]), f"K2 {dt} C={cols} != rows[idx]")
            vec = pano_cuda.vector_bytes(cols * rows.element_size(), rows.data_ptr(),
                                         out.data_ptr())
            say("K2", f"{dt} R={r_rows} C={cols} ({vec} B vectors): exact on N=777 "
                "and the edge indices")

    # 4. K1: motion sampler moments ------------------------------------------
    n = 65536
    pose = Pose.create(torch.full((n,), 10.0), torch.full((n,), 20.0),
                       torch.full((n,), 0.5), device=dev)
    odom = Odometry.create(0.1, 2.0, 0.2)
    alphas = (0.01, 0.01, 0.01, 0.01)

    def seed(s):
        return torch.tensor([s], dtype=torch.int64, device=dev)

    out = motion_cuda.launch(seed(7), odom, pose, alphas)
    torch.cuda.synchronize()
    th = out.theta.double().cpu().numpy()
    sr1 = math.sqrt(0.01 * 0.1**2 + 0.01 * 2.0**2)
    sr2 = math.sqrt(0.01 * 0.2**2 + 0.01 * 2.0**2)
    want_std = math.sqrt(sr1**2 + sr2**2)
    check(abs(th.mean() - 0.8) < 5 * want_std / math.sqrt(n), f"K1 theta mean {th.mean()}")
    check(abs(th.std() / want_std - 1.0) < 0.05, f"K1 theta std {th.std()} vs {want_std}")
    out_b = motion_cuda.launch(seed(8), odom, pose, alphas)
    out_c = motion_cuda.launch(seed(7), odom, pose, alphas)
    torch.cuda.synchronize()
    check(not torch.allclose(out_b.x, out.x), "K1 seeds 7 and 8 agree")
    check(torch.equal(out_c.x, out.x) and torch.equal(out_c.theta, out.theta),
          "K1 seed 7 does not reproduce")
    plain = motion.sample_motion_model_odometry(odom, pose, alphas, generator=g)
    k1_err = moment_gap(pose, out, plain, "N=65536")
    # Unequal stddevs (rot1 0.112, trans 1.0, rot2 0), through the wrapper:
    # a swapped or dropped stddev term moves some displacement moment.
    odd_odom, odd_alphas = Odometry.create(0.5, 10.0, 0.0), (0.05, 0.0, 0.01, 0.0)
    k1_err = max(k1_err, moment_gap(
        pose, sampler(odd_odom, pose, odd_alphas, generator=g),
        motion.sample_motion_model_odometry(odd_odom, pose, odd_alphas, generator=g),
        "unequal stddevs"))
    ragged = Pose.create(torch.linspace(0, 1, 100_003), torch.zeros(100_003),
                         torch.zeros(100_003), device=dev)
    out_r = motion_cuda.launch(seed(3), odom, ragged, alphas)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_r.x).all()) and out_r.x.shape == (100_003,),
          "K1 ragged N")
    check(bool((out_r.x[-5:] != ragged.x[-5:]).all()), "K1 ragged tail untouched")
    check(float(out_r.theta.abs().max()) <= math.pi, "K1 theta not wrapped")
    # K1 reads its odometry from device memory: device fields give the
    # host fields' poses, and the fused kernel's prologue gives K1's poses
    # for the same seed and device odometry, bit for bit (a weigh-free use
    # of the fused kernel: a blank 8 x 8 table, two beams).
    tiny_lut = torch.zeros((8, 8, 360), dtype=torch.bfloat16, device=dev)
    tiny_scan = Scan(angles=torch.zeros(2, device=dev), dists=torch.ones(2, device=dev))
    for od, al in ((odom, alphas), (odd_odom, odd_alphas)):
        for poses in (pose, ragged):
            rows = motion_cuda.odometry_rows(od, dev)
            k1_host = motion_cuda.launch(seed(7), od, poses, al)
            k1_dev = motion_cuda.launch(seed(7), Odometry(rot1=rows[0, 0], trans=rows[0, 1],
                                                          rot2=rows[0, 2]), poses, al)
            pf, _ = fused(tiny_lut, 360, poses, tiny_scan, beam_stride=1,
                          displacement=(0.0, 0.0, 0.0), max_dist=10.0, stddev=1.0, eps=0.1,
                          motion=(seed(7), rows, al))
            for f in ("x", "y", "theta"):
                a, b, c = (getattr(q, f).view(torch.int32) for q in (k1_host, k1_dev, pf))
                check(torch.equal(a, b), f"K1 with device odometry != host odometry ({f})")
                check(torch.equal(a, c), f"K1 != the fused kernel's prologue ({f}, N="
                      f"{poses.x.numel()})")
    # K1's normals take branch-free forms of libdevice's logf, sqrtf, sincosf
    # and cosf: equal to them on all 2^24 uniforms it can draw.
    math_bad = motion_cuda.math_mismatches(dev)
    check(not any(math_bad.values()),
          f"K1's branch-free math differs from libdevice's on {math_bad} of 2^24 uniforms")
    # The robot axis: R = K1_ROBOTS rows of RAGGED_N particles (row q starts
    # 12 q B off a 16 B boundary; 4 particles a thread, 16 B vectors between
    # each row's head and tail) == one-robot launches (one particle a
    # thread) with each row's seed and odometry, bit for bit; a shard at
    # i0 = K1_SHARD_I0 of every row == the whole launch's slice; and a 1M
    # cloud's shard at i0 = K1_SHARD_I0_1M (8 B off 16 B: 4 particles a
    # thread, strided) == its slice.
    rng_k1 = np.random.default_rng(44)

    def k1_cloud(shape):
        return Pose(*(torch.from_numpy(v).to(dev) for v in (
            rng_k1.uniform(0, 1000, shape).astype(np.float32),
            rng_k1.uniform(0, 1000, shape).astype(np.float32),
            rng_k1.uniform(-math.pi, math.pi, shape).astype(np.float32))))

    rows = k1_cloud((K1_ROBOTS, RAGGED_N))
    odo_np = np.stack([rng_k1.uniform(-0.1, 0.1, K1_ROBOTS), rng_k1.uniform(0.5, 3.0, K1_ROBOTS),
                       rng_k1.uniform(-0.1, 0.1, K1_ROBOTS)], axis=1).astype(np.float32)
    odo_r = Odometry.create(*(odo_np[:, k].tolist() for k in range(3)))
    seeds_r = torch.arange(K1_ROBOTS, dtype=torch.int64, device=dev) + 300
    whole = motion_cuda.launch(seeds_r, odo_r, rows, alphas)
    for q in range(K1_ROBOTS):
        one = motion_cuda.launch(seeds_r[q:q + 1], Odometry.create(*odo_np[q].tolist()),
                                 Pose(x=rows.x[q], y=rows.y[q], theta=rows.theta[q]), alphas)
        for f in ("x", "y", "theta"):
            check(torch.equal(getattr(whole, f)[q].view(torch.int32),
                              getattr(one, f).view(torch.int32)),
                  f"K1 robot axis: row {q} != its one-robot launch ({f})")
    part = motion_cuda.launch(seeds_r, odo_r, Pose(*(v[:, K1_SHARD_I0:].contiguous() for v in (
        rows.x, rows.y, rows.theta))), alphas, i0=K1_SHARD_I0)
    cloud_1m = k1_cloud((SLAM_PARTICLES,))
    whole_1m = motion_cuda.launch(seed(9), odom, cloud_1m, alphas)
    i0_1m = K1_SHARD_I0_1M
    part_1m = motion_cuda.launch(seed(9), odom, Pose(*(v[i0_1m:] for v in (
        cloud_1m.x, cloud_1m.y, cloud_1m.theta))), alphas, i0=i0_1m)
    for f in ("x", "y", "theta"):
        check(torch.equal(getattr(whole, f)[:, K1_SHARD_I0:].view(torch.int32),
                          getattr(part, f).view(torch.int32)),
              f"K1 robot axis: the shard at i0 = {K1_SHARD_I0} != the slice ({f})")
        check(torch.equal(getattr(whole_1m, f)[i0_1m:].view(torch.int32),
                          getattr(part_1m, f).view(torch.int32)),
              f"K1: the 1M cloud's shard at i0 = {i0_1m} != the slice ({f})")
    say("K1", f"branch-free math == libdevice's on all 2^24 uniforms {math_bad}; robot axis "
        f"{K1_ROBOTS} x {RAGGED_N}: each row == its one-robot launch, the shard at i0 = "
        f"{K1_SHARD_I0} == the slice, bit for bit; the 1M shard at i0 = {i0_1m} == the slice")
    del rows, whole, part, cloud_1m, whole_1m, part_1m
    say("K1", f"theta mean {th.mean():.6f} (want 0.8 +- {5 * want_std / math.sqrt(n):.6f}), "
        f"std/want {th.std() / want_std:.4f}; seed 7 reproduces, 8 differs; "
        f"N=100003 ok; max moment diff vs plain {k1_err:.3e}; the odometry read on the "
        "device: poses == the fused kernel's prologue bit for bit (two odometries, N=65536 "
        "and 100003)")

    big = Pose.create(torch.full((N_PARTICLES,), 400.0), torch.full((N_PARTICLES,), 400.0),
                      torch.full((N_PARTICLES,), math.pi), device=dev)
    bench_odom = Odometry.create(2.5, 0.02, 0.02)
    bench_alphas = (0.0005, 0.0005, 0.01, 0.01)
    seed1 = seed(1)
    def k1():
        return motion_cuda.launch(seed1, bench_odom, big, bench_alphas)

    def k1_plain():
        return motion.sample_motion_model_odometry(bench_odom, big, bench_alphas, generator=g)

    # The kernel alone: the launch also stages its odometry row (a 12 B copy).
    k1_ms = own_kernel_ms(k1, "motion_odometry_kernel")
    k1_plain_ms, k1_plain_n = device_ms(k1_plain)
    say("K1", f"N={N_PARTICLES}: device time kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms "
        f"({k1_plain_n:.0f} kernels); per call incl. host {cuda_ms(k1):.4f} ms vs "
        f"{cuda_ms(k1_plain):.4f} ms")

    # 5. LUT ------------------------------------------------------------------
    blocked_np = synthetic_floor_plan()
    blocked = torch.from_numpy(blocked_np).to(dev)
    h, w = blocked.shape
    lidar = LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="lut")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field = rayfield.make_ray_field(blocked, rc)
    torch.cuda.synchronize()
    lut_s = time.perf_counter() - t0
    lut = field.lut
    check(lut.shape == (h, w, 360) and lut.dtype == torch.bfloat16, "LUT shape/dtype")
    say("LUT", f"{h}x{w}x360 bf16 ({lut.numel() * 2 / 2**20:.1f} MiB) built in {lut_s:.3f} s")

    free = np.argwhere(~blocked_np)
    rng = np.random.default_rng(0)
    pick = free[rng.integers(0, len(free), 4096)]
    xs = torch.tensor(pick[:, 1] + 0.5, dtype=torch.float32, device=dev)
    ys = torch.tensor(h - pick[:, 0] - 0.5, dtype=torch.float32, device=dev)
    binw = 2 * math.pi / 360
    ths = torch.round(torch.tensor(rng.uniform(-math.pi, math.pi, 4096), device=dev,
                                   dtype=torch.float32) / binw) * binw
    d0, h0 = raycast_march(blocked, xs, ys, ths, step=0.5, max_dist=500.0)
    d1, h1 = lutlib.raycast_lut(lut, xs, ys, ths, max_dist=500.0)
    both = h0 & h1
    err = (d0 - d1).abs()[both]
    med = float(err.median())
    check(float(both.float().mean()) > 0.8, "LUT: too few rays hit")
    check(med < 1.5, f"LUT vs march median error {med} px")
    say("LUT", f"raycast_lut vs raycast_march on 4096 rays: {float(both.float().mean()):.3f} "
        f"both hit, median |err| {med:.3f} px, p95 {float(err.quantile(0.95)):.3f} px")

    rows = lut.reshape(h * w, 360)
    ridx = torch.randint(0, h * w, (N_PARTICLES,), generator=g, device=dev,
                         dtype=torch.int32)
    check(torch.equal(gather(rows, ridx), rows[ridx]), "K2 on LUT rows")
    k2_rand_ms, _ = device_ms(lambda: gather(rows, ridx))
    k2_rand_plain_ms, _ = device_ms(lambda: rows[ridx])
    say("K2", f"LUT rows [{h * w}, 360] bf16, {N_PARTICLES} uniform-random indices: exact; "
        f"device time kernel {k2_rand_ms:.4f} ms, plain {k2_rand_plain_ms:.4f} ms")

    # 6. weights: K1 by moments, K2 bit for bit, the fused kernel -------------
    cfg = MCLConfig(
        n_particles=N_PARTICLES, meas_stddev=5.0, scanner_offset=(0.0, 30.0, 0.0),
        lut_beam_stride=beam_bin_stride(lidar, rc),
    )
    check(cfg.lut_beam_stride == 2, "beam stride")
    pose0 = Pose.create(400.0, 400.0, math.pi, device=dev)
    sensor = mcl_mod.MCL.sensor_position(pose0, cfg.scanner_offset)
    scan = fake_lidar.scan(blocked, sensor, lidar, RaycastConfig(max_dist=500.0))
    n_beams = scan.angles.shape[0]
    state = mcl_mod.init(mcl_mod.make_generator(0, dev), N_PARTICLES, pose0)

    def step(st):
        st = mcl_mod.predict(st, bench_odom, bench_alphas)
        return mcl_mod.update(st, scan, field, cfg, rc)

    def pano_weights(lut_, poses, rows_fn):
        """(panorama rows, cell indices, weights) of `poses` through the plain
        route: sensor_pose, panorama_index, rows_fn(rows, idx) and
        pano_log_weights."""
        sp = measurement.sensor_pose(poses, cfg.scanner_offset)
        pidx, inb = lutlib.panorama_index((h, w), sp.x, sp.y)
        pano = rows_fn(lut_.reshape(h * w, 360), pidx)
        return pano, pidx, measurement.pano_log_weights(
            pano, inb, sp.theta, scan, n_bins=360, beam_stride=2, lut_dtype=lut_.dtype,
            max_dist=rc.max_dist, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon)

    def plain_rows(rows_, idx_):
        return rows_[idx_.long()]

    for _ in range(3):
        state = step(state)
    pick = free[rng.integers(0, len(free), N_PARTICLES)]
    spread_pose = Pose(
        x=torch.tensor(pick[:, 1] + rng.uniform(0, 1, N_PARTICLES), dtype=torch.float32,
                       device=dev),
        y=torch.tensor(h - pick[:, 0] - rng.uniform(0, 1, N_PARTICLES),
                       dtype=torch.float32, device=dev),
        theta=torch.tensor(rng.uniform(-math.pi, math.pi, N_PARTICLES),
                           dtype=torch.float32, device=dev),
    )
    clouds = (("bench cloud", state.particles.pose), ("free-space", spread_pose))
    # K1 at the main path's shape and arguments, through the wrapper that
    # predict calls (seed drawn on the device from the generator).
    for label, poses in clouds:
        k1_out = sampler(bench_odom, poses, bench_alphas, generator=g)
        plain = motion.sample_motion_model_odometry(bench_odom, poses, bench_alphas,
                                                    generator=g)
        gap = moment_gap(poses, k1_out, plain, label)
        k1_err = max(k1_err, gap)
        check(all(bool(torch.isfinite(v).all()) for v in (k1_out.x, k1_out.y, k1_out.theta)),
              f"K1 non-finite poses ({label})")
        check(float(k1_out.theta.abs().max()) <= math.pi, f"K1 theta not wrapped ({label})")
        say("K1", f"{label}, N={N_PARTICLES}, bench odometry and alphas, through the "
            f"wrapper: displacement moments match the plain version (max gap {gap:.3e})")

    k2_err = 0.0
    for label, poses in clouds:
        pano_k, _, lw_k = pano_weights(lut, poses, gather)
        pano_p, _, lw_p = pano_weights(lut, poses, plain_rows)
        k2_err = max(k2_err, float((pano_k.float() - pano_p.float()).abs().max()))
        check(torch.equal(pano_k, pano_p), f"K2 panorama rows ({label})")
        check(torch.equal(lw_k, lw_p), f"LUT weights through K2 != plain ({label})")
        check(bool(torch.isfinite(lw_k).all()), f"non-finite weights ({label})")
        say("weights", f"{label}: {N_PARTICLES} LUT weights through K2's rows equal the "
            f"plain-indexing weights bit for bit (range {float(lw_k.min()):.2f} .. "
            f"{float(lw_k.max()):.2f})")
    cloud = measurement.sensor_pose(state.particles.pose, cfg.scanner_offset)
    cloud_idx, _ = lutlib.panorama_index((h, w), cloud.x, cloud.y)
    k2_ms, _ = device_ms(lambda: gather(rows, cloud_idx))
    k2_plain_ms, _ = device_ms(lambda: rows[cloud_idx])
    k2_library_ms, _ = device_ms(lambda: torch.index_select(rows, 0, cloud_idx))
    k2_bound = bound(N_PARTICLES * (720 + 4) + int(torch.unique(cloud_idx).numel()) * 720, 0)
    say("K2", f"bench cloud ({N_PARTICLES} rows of 720 B): device time kernel {k2_ms:.4f} ms, "
        f"plain {k2_plain_ms:.4f} ms, index_select {k2_library_ms:.4f} ms, bound "
        f"{k2_bound[0]:.4f} ms ({k2_bound[1]}); per call incl. host "
        f"{cuda_ms(lambda: gather(rows, cloud_idx)):.4f} ms vs "
        f"{cuda_ms(lambda: rows[cloud_idx]):.4f} ms")

    # The fused kernel: K1's sampler, then the weights, in one launch.
    t0 = time.perf_counter()
    field_u8 = rayfield.make_ray_field(blocked, dataclasses.replace(rc, lut_dtype="u8"))
    torch.cuda.synchronize()
    say("LUT", f"{h}x{w}x360 u8 ({field_u8.lut.numel() / 2**20:.1f} MiB) built in "
        f"{time.perf_counter() - t0:.3f} s")
    # The card's two tables against the CPU's build bit for bit (each bin's
    # sin and cos taken on the host, `ops/lut.py:build_beam_lut`): one f32
    # build on the CPU, encoded to bf16 and u8 by the build's own encoder;
    # and `raycast_lut` on the 4096 rays, card against CPU.
    t0 = time.perf_counter()
    cpu32 = lutlib.build_beam_lut(torch.from_numpy(blocked_np), 360, rc.max_dist,
                                  torch.float32)
    lut_cpu_s = time.perf_counter() - t0
    lut_cpu = {"cpu_f32_build_s": lut_cpu_s}
    for tname, card, dt in (("bf16", lut, torch.bfloat16), ("u8", field_u8.lut, torch.uint8)):
        want = lutlib.encode_capped(cpu32, dt, rc.max_dist)
        got = card.cpu()
        if dt == torch.bfloat16:
            differ = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        else:
            differ = int((got != want).sum())
        dq, hq = lutlib.raycast_lut(want, xs.cpu(), ys.cpu(), ths.cpu(), max_dist=500.0)
        dd, hd = lutlib.raycast_lut(card, xs, ys, ths, max_dist=500.0)
        q_differ = int(((dd.cpu().view(torch.int32) != dq.view(torch.int32))
                        | (hd.cpu() != hq)).sum())
        lut_cpu[tname] = {"entries_differ": differ, "queries_differ": q_differ}
        check(differ == 0, f"LUT {tname}: {differ} entries of the card's table != the CPU's")
        check(q_differ == 0, f"LUT {tname}: raycast_lut card != CPU on {q_differ} rays")
    del cpu32, want, got
    say("LUT", f"the card's 360-bin bf16 and u8 tables == the CPU's build bit for bit; "
        f"raycast_lut card == CPU on 4096 rays; {json.dumps(lut_cpu)}")
    rr = np.random.default_rng(5)
    off_map = Pose(*(torch.tensor(v, dtype=torch.float32, device=dev) for v in (
        rr.uniform(-w / 2, 1.5 * w, RAGGED_N), rr.uniform(-h / 2, 1.5 * h, RAGGED_N),
        rr.uniform(-math.pi, math.pi, RAGGED_N))))
    wkw = dict(beam_stride=2, displacement=measurement.scanner_displacement(cfg.scanner_offset),
               max_dist=rc.max_dist, stddev=cfg.meas_stddev, eps=cfg.meas_epsilon)
    bench_motion = (motion_cuda.odometry_rows(bench_odom, dev), bench_alphas)
    lw_err = 0.0
    for tname, lut_ in (("bf16", lut), ("u8", field_u8.lut)):
        for label, poses in (*clouds, (f"N={RAGGED_N}, a third off the map", off_map)):
            sd = seed(11)
            pk, lwk = fused(lut_, 360, poses, scan, motion=(sd, *bench_motion), **wkw)
            p1 = motion_cuda.launch(sd, bench_odom, poses, bench_alphas)
            for f in ("x", "y", "theta"):
                check(torch.equal(getattr(pk, f).view(torch.int32),
                                  getattr(p1, f).view(torch.int32)),
                      f"lut_weights poses != K1's for the same seed ({f}; {tname}, {label})")
            _, lw_only = fused(lut_, 360, p1, scan, **wkw)
            check(torch.equal(lw_only, lwk), f"lut_weights with / without predict ({label})")
            _, pidx, lwp = pano_weights(lut_, p1, plain_rows)
            # The kernel's log_normal is logf bit for bit: its weights equal
            # PyTorch's terms summed in its order.
            same = order_held(lwk, lut_, p1, scan, cfg, rc.max_dist, f"{tname}, {label}")
            check(bool(torch.isfinite(lwk).all()), f"lut_weights non-finite ({tname}, {label})")
            diff = (lwk - lwp).abs()
            close = diff <= LW_RTOL * lwp.abs()
            share = float(close.float().mean())
            n_far = int((~close).sum())
            arg_k, arg_p = int(torch.argmax(lwk)), int(torch.argmax(lwp))
            lw_err = max(lw_err, float(diff.max()))
            sp1 = measurement.sensor_pose(p1, cfg.scanner_offset)
            off = int((~lutlib.panorama_index((h, w), sp1.x, sp1.y)[1]).sum())
            check(share >= LW_SHARE, f"lut_weights: {share} of weights within a relative "
                  f"{LW_RTOL} < {LW_SHARE} ({tname}, {label})")
            check(arg_k == arg_p, f"lut_weights best particle {arg_k} != plain {arg_p} "
                  f"({tname}, {label})")
            say("lut_weights", f"{tname}, {label}: poses == K1's bit for bit (seed 11); "
                f"{poses.x.numel() - n_far} of {poses.x.numel()} weights within a relative "
                f"{LW_RTOL} of the plain composition ({n_far} outside), max |diff| "
                f"{float(diff.max()):.3e}, within {float(diff[close].max()):.3e}; best "
                f"particle {arg_k} in both; {off} sensors off the map; weigh-only launch "
                f"equal bit for bit; {same} of weights == PyTorch's terms summed in the "
                "kernel's order bit for bit")

    # The adversarial clouds (the table's last cell and off its edge,
    # wrapping segments, u8 rows 8 B off 16 B, N = RAGGED_N, a shard at
    # i0 != 0): the floor plan's 599 x 1297 cells are odd, so the u8
    # table ends 8 B off a 16 B boundary and its last row's copies clamp.
    adversarial = {}
    for tname, lut_ in (("bf16", lut), ("u8", field_u8.lut)):
        adversarial[tname] = hold_adversarial(lut_, scan, cfg, rc.max_dist, 1,
                                              f"{tname} adversarial", 31)
        lw_err = max(lw_err, adversarial[tname]["max_abs_diff"])
        say("lut_weights", f"{tname}, adversarial clouds: poses == K1's bit for bit, the shard "
            f"== the whole launch's slice; {json.dumps(adversarial[tname])}")

    # Scans of more than 96 beams take the kernel's wider builds (6 and 12
    # beams a lane): 180 and 360 beams over 2 pi, on the bench cloud (sums
    # of 360 terms round further apart: its best weights may tie).
    wide = {}
    for n_rays in (180, 360):
        lid = LidarConfig(start=0.0, stop=2 * math.pi, max_dist=500.0, n_rays=n_rays)
        cfg_w = dataclasses.replace(cfg, lut_beam_stride=beam_bin_stride(lid, rc))
        scan_w = fake_lidar.scan(blocked, sensor, lid, RaycastConfig(max_dist=500.0))
        for tname, lut_ in (("bf16", lut), ("u8", field_u8.lut)):
            wide[f"{n_rays}_{tname}"] = hold_fused_to_plain(
                lut_, state.particles.pose, scan_w, cfg_w, rc.max_dist, seed(11), bench_odom,
                bench_alphas, f"{tname}, {n_rays} beams", ties=True)
            lw_err = max(lw_err, wide[f"{n_rays}_{tname}"]["max_abs_diff"])
    say("lut_weights", f"180 and 360 beams over 2 pi (6 and 12 a lane), bench cloud: poses == "
        f"K1's bit for bit; {json.dumps(wide)}")

    # A scan of more than 384 beams runs in chunks of 384 (12 beams a lane
    # a chunk): 720 beams over 2 pi on 720-bin tables at stride 1, so every
    # segment is a whole row and wraps, on the bench cloud and on the
    # adversarial clouds. And an eps that is not a normal float (1e-40, a
    # denormal f32) takes the kernel's other log, logf itself.
    rc720 = dataclasses.replace(rc, lut_bins=720)
    lid720 = LidarConfig(start=0.0, stop=2 * math.pi, max_dist=500.0, n_rays=720)
    cfg720 = dataclasses.replace(cfg, lut_beam_stride=beam_bin_stride(lid720, rc720))
    check(cfg720.lut_beam_stride == 1, f"720 beams on 720 bins at stride {cfg720.lut_beam_stride}")
    scan720 = fake_lidar.scan(blocked, sensor, lid720, RaycastConfig(max_dist=500.0))
    cfg_eps = dataclasses.replace(cfg, meas_epsilon=1e-40)
    other = {}
    for tname, lut_ in (("bf16", lut), ("u8", field_u8.lut)):
        lut720 = rayfield.make_ray_field(blocked, dataclasses.replace(rc720, lut_dtype=tname)).lut
        other[f"720_{tname}"] = hold_fused_to_plain(
            lut720, state.particles.pose, scan720, cfg720, rc.max_dist, seed(11), bench_odom,
            bench_alphas, f"{tname}, 720 beams", ties=True)
        other[f"720_{tname}_adversarial"] = hold_adversarial(
            lut720, scan720, cfg720, rc.max_dist, 1, f"{tname}, 720 beams adversarial", 37)
        del lut720
        other[f"eps_1e-40_{tname}"] = hold_fused_to_plain(
            lut_, state.particles.pose, scan, cfg_eps, rc.max_dist, seed(11), bench_odom,
            bench_alphas, f"{tname}, eps 1e-40", ties=True)
        lw_err = max(lw_err, *(v["max_abs_diff"] for v in other.values()))
    say("lut_weights", f"720 beams on 720 bins (chunks of 384), bench and adversarial clouds, and "
        f"eps 1e-40 (logf): poses == K1's bit for bit; {json.dumps(other)}")

    def plain_predict_weigh(poses):
        p_ = motion.sample_motion_model_odometry(bench_odom, poses, bench_alphas, generator=g)
        return pano_weights(lut, p_, plain_rows)

    sd = seed(12)
    lw_times = {}
    for label, poses in clouds:
        _, pidx, _ = plain_predict_weigh(poses)
        cells = int(torch.unique(pidx).numel())
        lw_bound = bound(N_PARTICLES * (12 + 12 + 4) + cells * n_beams * 2 + n_beams * 8 + 8,
                         N_PARTICLES * (OPS_SAMPLE + OPS_LOCATE + n_beams * OPS_BEAM))
        lw_times[label] = {
            "ms": device_ms(lambda: fused(lut, 360, poses, scan,
                                          motion=(sd, *bench_motion), **wkw))[0],
            "weigh_only_ms": device_ms(lambda: fused(lut, 360, poses, scan, **wkw))[0],
            "plain_ms": device_ms(lambda: plain_predict_weigh(poses))[0],
            "bound_ms": lw_bound[0], "bound_by": lw_bound[1], "distinct_cells": cells}
        lw_times[label]["bound_share"] = lw_bound[0] / lw_times[label]["ms"]
        say("lut_weights", f"{label}, bf16, N={N_PARTICLES}: device time {json.dumps(lw_times[label])}")

    # 7. main path: bench.py's configuration through mcl.step -----------------
    iters, blocks = 20, 5

    def fused_step(st):
        return mcl_mod.step(st, bench_odom, bench_alphas, scan, field, cfg, rc)

    def k2_route_step(st):
        st = mcl_mod.predict(st, bench_odom, bench_alphas)
        return mcl_mod._finish(st, pano_weights(lut, st.particles.pose, gather)[2], cfg)

    def run_path(fn):
        """init, 3 warm-up steps, `blocks` x `iters` steps under the sync
        check; the launch counts of those steps, ms/step, device ms and
        launches per step, host enqueue, busy share, the largest kernels."""
        reset_counts()
        st = mcl_mod.init(mcl_mod.make_generator(0, dev), N_PARTICLES, pose0)
        for _ in range(3):
            st = fn(st)
        torch.cuda.synchronize()
        ms = []
        for _ in range(blocks):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda.set_sync_debug_mode("error")  # a host sync in the step raises
            try:
                for _ in range(iters):
                    st = fn(st)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            stop.record()
            stop.synchronize()
            ms.append(start.elapsed_time(stop) / iters)
        counts = read_counts()
        p_ = st.particles
        for v in (p_.pose.x, p_.pose.y, p_.pose.theta, p_.log_weight, st.best_pose.x,
                  st.best_pose.y, st.best_pose.theta):
            check(bool(torch.isfinite(v).all()), "main path produced non-finite values")
        box = [st]

        def advance():
            box[0] = fn(box[0])

        prof = kernel_profile(advance, iters=iters)
        dev_ms, kernels = sum(r[0] for r in prof.values()), sum(r[1] for r in prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:8]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            advance()
        enqueue = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        med = statistics.median(ms)
        return box[0], counts, {
            "ms_per_step": {"median": med, "min": min(ms), "max": max(ms), "repeats": blocks,
                            "iters": iters},
            "device_ms_per_step": dev_ms, "launches_per_step": kernels,
            "host_enqueue_ms_per_step": enqueue, "device_busy_share": dev_ms / med,
            "top": [[k[:90], round(v[0], 4), round(v[1], 2)] for k, v in top]}

    steps = 3 + iters * blocks
    state, launches, main = run_path(fused_step)
    check(launches["lut_weights"] == steps, f"lut_weights launches {launches} != {steps} steps")
    check(launches["motion_odometry"] == 0, f"K1 launched on the mcl.step path: {launches}")
    check(launches["gather_rows"] == 0, f"K2 launched on the mcl.step path: {launches}")
    # The same call's other paths, in turns: predict -> update (K1, then the
    # weigh-only kernel) and the earlier route (K1, K2's rows, plain weights).
    others = {}
    for path, fn in (("predict_update", step), ("k2_route", k2_route_step),
                     ("k2_route_again", k2_route_step), ("predict_update_again", step)):
        _, counts, others[path] = run_path(fn)
        others[path]["launches"] = counts
    _, _, main_again = run_path(fused_step)
    med = main["ms_per_step"]["median"]

    def phase_ms(fn):
        return statistics.median(cuda_ms(fn) for _ in range(blocks))

    pp = state.particles.pose
    predict_ms = phase_ms(lambda: mcl_mod.predict(state, bench_odom, bench_alphas))
    meas_ms = phase_ms(lambda: measurement.particle_log_weights(
        field, pp, scan, rc=rc, scanner_offset=cfg.scanner_offset,
        stddev=cfg.meas_stddev, eps=cfg.meas_epsilon, lut_beam_stride=cfg.lut_beam_stride))
    resample_ms = phase_ms(lambda: resample_mod.resample(
        state.particles, cfg.resample, generator=state.generator))
    say("main", json.dumps({
        "metric": "mcl_particle_updates_per_s_100k",
        "value": N_PARTICLES / (med / 1e3),
        "unit": "particle-updates/s",
        "path": "mcl.step",
        **main,
        "ms_per_step_again": main_again["ms_per_step"],
        "phases_ms": {"predict": predict_ms, "measurement": meas_ms,
                      "resample": resample_ms},
        "launches": launches,
        "device": name,
        "power_limit": smi.split(",")[-1].strip(),
    }))
    for path, res in others.items():
        say("main", json.dumps({"path": path, **res}))

    # 8. tracking through mcl.step -----------------------------------------------
    track_odom = (0.01, 2.0, 0.01)
    truth = [640.0, 190.0, 0.0]
    state = mcl_mod.init(mcl_mod.make_generator(1, dev), N_PARTICLES,
                         Pose.create(*truth, device=dev))
    odom_t = Odometry.create(*track_odom)
    for _ in range(40):
        r1, t, r2 = track_odom
        truth = [truth[0] + t * math.cos(truth[2] + r1),
                 truth[1] + t * math.sin(truth[2] + r1),
                 truth[2] + r1 + r2]
        sensor = mcl_mod.MCL.sensor_position(Pose.create(*truth, device=dev),
                                             cfg.scanner_offset)
        sc = fake_lidar.scan(blocked, sensor, lidar, RaycastConfig(max_dist=500.0))
        state = mcl_mod.step(state, odom_t, bench_alphas, sc, field, cfg, rc)
    bp = state.best_pose
    pos_err = math.hypot(float(bp.x) - truth[0], float(bp.y) - truth[1])
    th_err = abs((float(bp.theta) - truth[2] + math.pi) % (2 * math.pi) - math.pi)
    check(pos_err <= TRACK_BOUND_PX, f"tracking error {pos_err} px > {TRACK_BOUND_PX}")
    say("track", f"40 steps through mcl.step, {N_PARTICLES} particles: final best pose "
        f"({float(bp.x):.3f}, {float(bp.y):.3f}, {float(bp.theta):.4f}) vs truth "
        f"({truth[0]:.3f}, {truth[1]:.3f}, {truth[2]:.4f}): {pos_err:.3f} px, "
        f"{th_err:.4f} rad (bound {TRACK_BOUND_PX} px)")

    # 9. slam: benchmarks/suite.py slam's configuration at 1M particles ----
    from slam_tpu_torch.core import grid as gridlib
    from slam_tpu_torch.models import slam as slam_mod
    from slam_tpu_torch.ops import edt as edtlib
    from slam_tpu_torch.ops import mapping

    slam_cfg = slam_config()
    mcfg = slam_cfg.mcl
    cap = slam_mod._lf_cap(slam_cfg)
    slam_odom = Odometry.create(0.02, 2.5, 0.02)
    # Two alternating scans keep map cells flipping in steady state (as
    # the suite does), from (400, 400, pi) and (403, 403, pi + 0.05).
    slam_scans = [
        fake_lidar.scan(blocked, measurement.sensor_pose(p, mcfg.scanner_offset),
                        slam_cfg.lidar, slam_cfg.raycast)
        for p in (Pose.create(400.0, 400.0, math.pi, device=dev),
                  Pose.create(403.0, 403.0, math.pi + 0.05, device=dev))
    ]
    engine = slam_mod.GridSLAM(slam_cfg, seed=0, device=dev)
    reset_counts()
    st = engine.init(Pose.create(400.0, 400.0, math.pi, device=dev))
    n_steps = 0
    for _ in range(4):
        st = engine.step(st, slam_odom, slam_scans[n_steps % 2])
        n_steps += 1
    torch.cuda.synchronize()
    block_ms = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda.set_sync_debug_mode("error")  # a host sync in the step raises
        try:
            for _ in range(iters):
                st = engine.step(st, slam_odom, slam_scans[n_steps % 2])
                n_steps += 1
        finally:
            torch.cuda.set_sync_debug_mode(0)
        stop.record()
        stop.synchronize()
        block_ms.append(start.elapsed_time(stop))
    slam_launches, slam_warm = read_counts(), warmup_counts()
    slam_steps = n_steps
    # GridSLAM replays a graph a step: one block (one warm-up launch) per
    # phase of the resample gate.
    check(slam_launches["motion_odometry"] == slam_steps + slam_warm["motion_odometry"]
          and slam_warm["motion_odometry"] == mcfg.resample_every,
          f"K1 launches {slam_launches} != {slam_steps} SLAM steps + warm-ups {slam_warm}")
    p = st.mcl.particles
    for v in (p.pose.x, p.pose.y, p.pose.theta, p.log_weight, st.grid, st.est_pose.x,
              st.est_pose.y, st.est_pose.theta):
        check(bool(torch.isfinite(v).all()), "slam step produced non-finite values")
    check(p.n == SLAM_PARTICLES and st.grid.shape == slam_cfg.map.shape, "slam state shapes")
    check(bool((st.grid != 0).any()), "slam step mapped nothing")
    slam_ms = [b / iters for b in block_ms]
    slam_med = statistics.median(slam_ms)

    # Per-phase times on the steady state, each phase alone.
    pp = p.pose
    scan0 = slam_scans[0]
    blocked_st = gridlib.blocked_from_logodds(st.grid)
    edt_st = edtlib.edt_capped(blocked_st, cap)
    field_st = rayfield.RayField(blocked=blocked_st, edt=edt_st)
    lf = dict(rc=slam_cfg.raycast, scanner_offset=mcfg.scanner_offset,
              stddev=mcfg.meas_stddev, z_hit=mcfg.lf_z_hit, z_rand=mcfg.lf_z_rand)
    win = dict(grid_shape=slam_cfg.map.shape, scanner_offset=mcfg.scanner_offset,
               table_bins=mcfg.lf_table_bins, spread_mult=mcfg.lf_table_spread,
               min_halfwidth=mcfg.lf_table_min_halfwidth, box_size=mcfg.lf_table_box)
    window = measurement.lf_table_window(pp, **win)
    prep = measurement.lf_table_prepare(
        field_st, pp, scan0, table_bins=mcfg.lf_table_bins,
        spread_mult=mcfg.lf_table_spread, min_halfwidth=mcfg.lf_table_min_halfwidth,
        table_dtype=mcfg.lf_table_dtype, box_size=mcfg.lf_table_box, **lf)
    lw = measurement.lf_table_lookup(prep, pp, scan0, rc=slam_cfg.raycast,
                                     scanner_offset=mcfg.scanner_offset,
                                     z_rand=mcfg.lf_z_rand, grid_shape=slam_cfg.map.shape)
    check(bool(torch.isfinite(lw).all()), "non-finite table weights")
    mm = slam_cfg.map
    slam_phases = {
        "predict": phase_ms(lambda: mcl_mod.predict(st.mcl, slam_odom,
                                                    slam_cfg.motion.alphas)),
        "edt_rebuild": phase_ms(lambda: edtlib.edt_capped(blocked_st, cap)),
        "table_window": phase_ms(lambda: measurement.lf_table_window(pp, **win)),
        "table_build": phase_ms(lambda: measurement.lf_score_table(
            edt_st, scan0, window[3], dtype=mcfg.lf_table_dtype,
            origin=(window[4], window[5]), out_shape=(window[6], window[7]),
            **{k: v for k, v in lf.items() if k != "scanner_offset"})),
        "table_prepare": phase_ms(lambda: measurement.lf_table_prepare(
            field_st, pp, scan0, table_bins=mcfg.lf_table_bins,
            spread_mult=mcfg.lf_table_spread, min_halfwidth=mcfg.lf_table_min_halfwidth,
            table_dtype=mcfg.lf_table_dtype, box_size=mcfg.lf_table_box, **lf)),
        "lookup": phase_ms(lambda: measurement.lf_table_lookup(
            prep, pp, scan0, rc=slam_cfg.raycast, scanner_offset=mcfg.scanner_offset,
            z_rand=mcfg.lf_z_rand, grid_shape=slam_cfg.map.shape)),
        "estimate": phase_ms(lambda: mcl_mod.estimate(pp, p.log_weight + lw, lw,
                                                      mcfg.mode_tau)),
        "map_update": phase_ms(lambda: mapping.scan_logodds_update(
            st.grid, st.mcl.mode_pose, scan0, scanner_offset=mcfg.scanner_offset,
            step=slam_cfg.raycast.step, max_dist=slam_cfg.raycast.max_dist,
            l_occ=mm.l_occ, l_free=mm.l_free, l_min=mm.l_min, l_max=mm.l_max)),
        "resample": phase_ms(lambda: resample_mod.resample(p, mcfg.resample,
                                                           generator=st.mcl.generator)),
    }
    # Profile and host enqueue over consecutive steps (20 steps hold 5
    # resamples, as in the timed blocks).
    def advance():
        nonlocal st, n_steps
        st = engine.step(st, slam_odom, slam_scans[n_steps % 2])
        n_steps += 1

    prof = kernel_profile(advance, iters=iters, warmup=4)
    slam_dev_ms = sum(r[0] for r in prof.values())
    slam_kernels = sum(r[1] for r in prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:12]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        advance()
    slam_enqueue_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()

    # K1 at the SLAM path's shape: N = 1M on the SLAM cloud after warm-up.
    pp = st.mcl.particles.pose
    k1_err = max(k1_err, moment_gap(
        pp, sampler(slam_odom, pp, slam_cfg.motion.alphas, generator=g),
        motion.sample_motion_model_odometry(slam_odom, pp, slam_cfg.motion.alphas,
                                            generator=g),
        "SLAM cloud, N=1M"))
    seed1m = seed(2)
    k1_1m_ms = own_kernel_ms(lambda: motion_cuda.launch(seed1m, slam_odom, pp,
                                                        slam_cfg.motion.alphas),
                             "motion_odometry_kernel")
    k1_1m_plain_ms, _ = device_ms(lambda: motion.sample_motion_model_odometry(
        slam_odom, pp, slam_cfg.motion.alphas, generator=g))
    k1_1m_bound = bound(SLAM_PARTICLES * 24, SLAM_PARTICLES * OPS_SAMPLE)
    say("slam", json.dumps({
        "metric": f"slam_production_step_ms_{SLAM_PARTICLES // 1000}k",
        "ms_per_step": {"median": slam_med, "min": min(slam_ms), "max": max(slam_ms),
                        "repeats": blocks, "iters": iters},
        "slam_production_particle_updates_per_s": SLAM_PARTICLES / (slam_med / 1e3),
        "phases_ms": slam_phases,
        "device_ms_per_step": slam_dev_ms,
        "kernels_per_step": slam_kernels,
        "host_enqueue_ms_per_step": slam_enqueue_ms,
        "device_busy_share": slam_dev_ms / slam_med,
        # Per call, each phase alone (CUDA events, host pace included);
        # resample runs on every 4th step.
        "resample_every": mcfg.resample_every,
        "launches": slam_launches,
        "steps": slam_steps,
        "k1_1m_ms": k1_1m_ms,
        "k1_1m_plain_ms": k1_1m_plain_ms,
        "k1_1m_bound_ms": k1_1m_bound[0],
        "k1_1m_bound_by": k1_1m_bound[1],
        "k1_1m_bound_share": k1_1m_bound[0] / k1_1m_ms,
        "device": name,
        "power_limit": smi.split(",")[-1].strip(),
    }))
    for kname, (kms, kn) in top:
        say("slam", f"profile: {kms:.4f} ms/step in {kn:.2f} launches/step: {kname[:110]}")

    # 10. edt: the card against the CPU, and the incremental cache ---------
    rmask = torch.rand(slam_cfg.map.shape, generator=g, device=dev) < 0.02
    for label, mask in (("warm-up grid", blocked_st), ("random 2%", rmask)):
        on_card = edtlib.edt_capped(mask, cap)
        on_cpu = edtlib.edt_capped(mask.cpu(), cap)
        check(torch.equal(on_card.cpu().view(torch.int32), on_cpu.view(torch.int32)),
              f"edt_capped on the card != on the CPU ({label})")
    say("edt", f"edt_capped {tuple(blocked_st.shape)} cap {cap}: card == CPU bit for bit on "
        "the warm-up grid's mask and a random 2% mask")
    box_engine = slam_mod.GridSLAM(slam_config(edt_box=512), seed=0, device=dev)
    sb = box_engine.init(Pose.create(400.0, 400.0, math.pi, device=dev))
    reach = edtlib.edt_capped_reach(cap)
    outcomes = {"window": 0, "full": 0, "skip": 0}
    for k in range(20):
        old = gridlib.blocked_from_logodds(sb.grid)
        sb = box_engine.step(sb, slam_odom, slam_scans[k % 2])
        new = gridlib.blocked_from_logodds(sb.grid)
        any_diff, fits, _, _ = edtlib._refresh_plan(old, new, reach=reach, box=512)
        outcomes["skip" if not bool(any_diff) else "window" if bool(fits) else "full"] += 1
        check(torch.equal(sb.edt, edtlib.edt_capped(new, cap)),
              f"edt_box cache != full rebuild after step {k}")
    check(outcomes["window"] >= 1, f"no window refresh in 20 steps: {outcomes}")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(iters):
        sb = box_engine.step(sb, slam_odom, slam_scans[k % 2])
    stop.record()
    stop.synchronize()
    box_ms = start.elapsed_time(stop) / iters
    pose_cpu = st.mcl.mode_pose.to("cpu")
    map_kw = dict(scanner_offset=mcfg.scanner_offset, step=slam_cfg.raycast.step,
                  max_dist=slam_cfg.raycast.max_dist, l_occ=mm.l_occ, l_free=mm.l_free,
                  l_min=mm.l_min, l_max=mm.l_max)
    map_card = mapping.scan_logodds_update(st.grid, st.mcl.mode_pose, scan0, **map_kw).cpu()
    map_cpu = mapping.scan_logodds_update(st.grid.cpu(), pose_cpu, scan0.to("cpu"), **map_kw)
    map_err = float((map_card - map_cpu).abs().max())
    map_flips = int((gridlib.blocked_from_logodds(map_card)
                     != gridlib.blocked_from_logodds(map_cpu)).sum())
    say("edt", f"edt_box=512, 20 alternating-scan steps at {SLAM_PARTICLES} particles: cache "
        "== full rebuild bit for "
        f"bit after every step; outcomes {outcomes}; step {box_ms:.3f} ms (CUDA events, "
        f"{iters} steps) vs {slam_med:.3f} ms median with the per-step rebuild (phase 9). "
        f"Map update card vs CPU: max |diff| {map_err:.3e}, {map_flips} blocked cells flip")

    # 11. slam-track: closed loop on the floor plan ---------------------------
    err, wall_share, n_mapped = slam_track(dev, blocked, seed=1)
    check(err <= SLAM_TRACK_BOUND_PX,
          f"slam-track est_pose error {err} px > {SLAM_TRACK_BOUND_PX}")
    check(wall_share >= SLAM_WALL_SHARE,
          f"slam-track: {wall_share:.3f} of mapped walls within 2 px of a true wall "
          f"< {SLAM_WALL_SHARE}")
    say("slam-track", f"{SLAM_TRACK_STEPS} steps, {SLAM_PARTICLES} particles, seed 1: final "
        f"est_pose error {err:.3f} px (bound {SLAM_TRACK_BOUND_PX}); {wall_share:.4f} of "
        f"{n_mapped} mapped blocked cells within 2 px of a true wall (bound "
        f"{SLAM_WALL_SHARE})")

    # 12-14. planners on the floor plan -------------------------------------
    power = smi.split(",")[-1].strip()
    from slam_tpu_torch.utils.maps import inflate

    plan_free = ~inflate(blocked_np, PLAN_INFLATE)  # `suite.py:155`
    sdf = sdf_phase(dev, blocked_np)
    say("sdf", json.dumps({**sdf, "device": name, "power_limit": power}))
    lat = lattice_phase(dev, plan_free)
    say("plan-lattice", json.dumps({**lat, "device": name, "power_limit": power}))
    rrt = rrt_phase(dev, plan_free)
    say("plan-rrt", json.dumps({**rrt, "device": name, "power_limit": power}))
    cont = continuous_phase(dev, plan_free)
    say("plan-continuous", json.dumps({**cont, "device": name, "power_limit": power}))
    spat = spatial_phase(dev)
    say("spatial", json.dumps({**spat, "device": name, "power_limit": power}))
    t_new = time.perf_counter()

    # 15-19. global localization, the auto tier, kidnap, scan matching, RBPF.
    counts = (reset_counts, read_counts)
    phase_s = {}
    t0 = time.perf_counter()
    gl = globalloc_phase(dev, blocked_np, field, counts)
    phase_s["globalloc"] = time.perf_counter() - t0
    say("globalloc", json.dumps({**gl, "device": name, "power_limit": power}))
    t0 = time.perf_counter()
    auto = autotier_phase(dev, slam_scans, slam_odom, counts)
    phase_s["autotier"] = time.perf_counter() - t0
    say("autotier", json.dumps({**auto, "device": name, "power_limit": power}))
    t0 = time.perf_counter()
    kid = kidnap_phase(dev)
    phase_s["kidnap"] = time.perf_counter() - t0
    say("kidnap", json.dumps({**kid, "device": name, "power_limit": power}))
    t0 = time.perf_counter()
    sm = scanmatch_phase(dev, blocked_np, slam_scans, slam_odom, counts, slam_med)
    phase_s["scanmatch"] = time.perf_counter() - t0
    say("scanmatch", json.dumps({**{k: v for k, v in sm.items() if k != "cases"},
                                 "device": name, "power_limit": power}))
    t0 = time.perf_counter()
    rb = rbpf_phase(dev, blocked_np, counts)
    phase_s["rbpf"] = time.perf_counter() - t0
    say("rbpf", json.dumps({**rb, "device": name, "power_limit": power}))

    # 20-22. the maze through the CDDT and the dense table, the fleet, the
    # apps: the apps read the floor plan from a PNG, as users pass it.
    import shutil
    import tempfile

    from PIL import Image

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        map_png = f"{workdir}/floor_plan.png"
        Image.fromarray(np.where(blocked_np, 0, 255).astype(np.uint8)).save(map_png)
        t0 = time.perf_counter()
        mz = maze_phase(dev, counts)
        maze_inputs = mz.pop("graph_inputs")
        phase_s["maze"] = time.perf_counter() - t0
        say("maze", json.dumps({**mz, "device": name, "power_limit": power}))
        t0 = time.perf_counter()
        fl = fleet_phase(dev, blocked_np, field, counts, map_png, workdir)
        phase_s["fleet"] = time.perf_counter() - t0
        say("fleet", json.dumps({**fl, "device": name, "power_limit": power}))
        t0 = time.perf_counter()
        ap = apps_phase(dev, counts, map_png, workdir)
        phase_s["apps"] = time.perf_counter() - t0
        say("apps", json.dumps({**ap, "device": name, "power_limit": power}))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # 23. parallel/: world 1 over NCCL here, then D ranks sharing the card.
    t0 = time.perf_counter()
    par = parallel_phase(dev, counts)
    phase_s["parallel"] = time.perf_counter() - t0
    say("parallel", json.dumps({**par, "device": name, "power_limit": power}))

    # 24. the last two tools at their defaults.
    t0 = time.perf_counter()
    tl = tools_phase(dev, counts)
    phase_s["tools"] = time.perf_counter() - t0
    say("tools", json.dumps({**tl, "device": name, "power_limit": power}))

    # 25. each filter step as one CUDA graph replay, against the eager step.
    t0 = time.perf_counter()
    gr = graphs_phase(dev, blocked_np, field, maze_inputs, counts)
    del maze_inputs
    phase_s["graphs"] = time.perf_counter() - t0
    say("graphs", json.dumps({**gr, "device": name, "power_limit": power}))

    # 26. `slam_tpu_torch/entry.py`, the counterpart of `__graft_entry__.py`.
    t0 = time.perf_counter()
    en = entry_phase(dev, counts)
    phase_s["entry"] = time.perf_counter() - t0
    say("entry", json.dumps({**en, "device": name, "power_limit": power}))

    # 27. both kernels on row-padded tables, and the port's public names.
    pd = padded_phase(dev, field, field_u8, clouds, scan, cfg, rc, bench_odom, bench_alphas,
                      counts)
    phase_s["padded"] = pd["seconds"]
    say("padded", json.dumps({**{k: v for k, v in pd.items() if k not in ("k2", "lut_weights")},
                              "device": name, "power_limit": power}))
    # 28. the resampler's kernel chain against the plain path.
    rs = resample_phase(dev, counts)
    phase_s["resample"] = rs["seconds"]
    say("resample", json.dumps({**rs, "device": name, "power_limit": power}))
    # 29. the estimate's kernel chain against the plain estimate.
    es = estimate_phase(dev, counts)
    phase_s["estimate"] = es["seconds"]
    say("estimate", json.dumps({**es, "device": name, "power_limit": power}))
    # 30. the RBPF's march and map write kernels against the plain path.
    rf = rbpf_fidelity_phase(dev, blocked_np)
    phase_s["rbpf_fidelity"] = rf["seconds"]
    say("rbpf_fidelity", json.dumps({**rf, "device": name, "power_limit": power}))
    say("total", f"{time.perf_counter() - t_start:.1f} s on {name}, {power}; phases 15-30 "
        f"{time.perf_counter() - t_new:.1f} s {json.dumps(phase_s)}")

    # Launches: the counts of the main paths' runs (phase 7's mcl.step,
    # phase 9's SLAM step, phase 15's global localization, phase 16's auto
    # tier, phase 18's scan-matched SLAM step, phase 19's RBPF, phase 20's
    # maze steps through both tables, phase 21's fleet steps, phase 22's
    # apps, phase 23's sharded engines on every rank of every world and
    # their graph and eager routes, phase 24's tools, phase 25's graphed and
    # eager steps, phase 26's entry step, phase 27's padded steps; a graph
    # replay counts the launches its capture recorded, a warm-up its own). K2
    # left the MCL step with this kernel line's third entry; phases 3, 5
    # and 6 still hold it to rows[idx], phase 27's panorama-row route
    # launches it on padded rows.
    main_launches = {k: launches[k] + slam_launches[k] + gl["launches"][k]
                     + auto["launches_after_step_5"][k] + sm["launches"][k] + rb["launches"][k]
                     + mz["launches"][k] + fl["launches"][k] + ap["launches"][k]
                     + par["launches"].get(k, 0) + tl["launches"][k] + gr["launches"][k]
                     + en["launches"][k] + pd["launches"][k] for k in launches}
    k2_pad, lw_pad = pd["k2"], pd["lut_weights"]
    lw_fleet = fl["kernel_fleet"]
    lw_maze = mz["maze"]["lut"]["lut_weights_vs_plain"]
    lw_1m = gl["lut_weights_1m_uniform"]
    k1_bound = bound(N_PARTICLES * 24, N_PARTICLES * OPS_SAMPLE)
    k1_fleet = fl["k1_fleet"]
    lw_bench = lw_times["bench cloud"]
    print(json.dumps({"kernels": [
        {"name": "motion_odometry", "route": "cuda",
         "source": "slam_tpu_torch/csrc/motion_odometry.cu",
         "replaces": "slam_tpu/ops/motion_pallas.py:76",
         "launches": main_launches["motion_odometry"],
         # Largest moment gap (mean, std of the x, y, theta displacement)
         # vs the plain version, at N=65536, on the two 100k clouds of
         # phase 6 and the 1M SLAM cloud: the kernel's noise stream is its
         # own. Times at N = 100k (phase 4).
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "bound_share": k1_bound[0] / k1_ms,
         "library_ms": None,
         # Phase 9: the 1M SLAM cloud.
         "ms_1m": k1_1m_ms, "plain_ms_1m": k1_1m_plain_ms, "bound_ms_1m": k1_1m_bound[0],
         "bound_by_1m": k1_1m_bound[1], "bound_share_1m": k1_1m_bound[0] / k1_1m_ms,
         # Phase 21: one launch for a fleet of 16 x 100k (robot axis).
         "ms_fleet_16x100k": k1_fleet["ms"], "bound_ms_fleet_16x100k": k1_fleet["bound_ms"],
         "bound_by_fleet_16x100k": k1_fleet["bound_by"],
         "bound_share_fleet_16x100k": k1_fleet["bound_share"]},
        {"name": "gather_rows", "route": "cuda",
         "source": "slam_tpu_torch/csrc/gather_rows.cu",
         "replaces": "slam_tpu/ops/pano_pallas.py:69",
         "launches": main_launches["gather_rows"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": k2_library_ms,
         # Phase 27, in turns: rows of 360 and 512 bf16, 360 and 384 u8 (the
         # padded widths), on 100k random rows and the bench cloud's rows.
         **{f"{key}_{rows}_{cloud}": k2_pad[f"{rows}_{cloud}"][key]
            for rows in ("bf16_360", "bf16_512", "u8_360", "u8_384")
            for cloud in ("random_100k", "bench")
            for key in ("ms", "bound_ms", "bound_share")},
         **{f"library_ms_{rows}_random_100k": k2_pad[f"{rows}_random_100k"]["library_ms"]
            for rows in ("bf16_360", "bf16_512", "u8_360", "u8_384")},
         "ms_padded_bench": k2_pad["bf16_512_bench"]["ms"],
         "bound_share_padded_bench": k2_pad["bf16_512_bench"]["bound_share"]},
        {"name": "lut_weights", "route": "cuda",
         "source": "slam_tpu_torch/csrc/lut_weights.cu",
         "replaces": "slam_tpu/ops/motion_pallas.py:76 (K1, fused as the prologue) + "
                     "slam_tpu/ops/measurement.py:671 (particle_log_weights_lut_fused)",
         "launches": main_launches["lut_weights"],
         # Largest |weight - plain| over both tables, the three clouds of
         # phase 6 and its adversarial clouds (a bin or cell on a rounding
         # tie flips a particle's weight whole; the share within LW_RTOL is
         # checked there); the poses equal K1's bit for bit. Times on the
         # bench cloud, bf16.
         "max_abs_err": lw_err, "ms": lw_bench["ms"], "plain_ms": lw_bench["plain_ms"],
         "bound_ms": lw_bench["bound_ms"], "bound_by": lw_bench["bound_by"],
         "bound_share": lw_bench["bound_share"], "library_ms": None,
         # Phase 15: step 1 of the 1M uniform global-localization cloud.
         "ms_1m_uniform": lw_1m["ms"], "plain_ms_1m_uniform": lw_1m["plain_ms"],
         "bound_ms_1m_uniform": lw_1m["bound_ms"], "bound_by_1m_uniform": lw_1m["bound_by"],
         "bound_share_1m_uniform": lw_1m["bound_share"],
         "max_abs_err_1m_uniform": lw_1m["max_abs_diff"],
         # Phase 21: one launch for a fleet of 16 x 100k (robot axis).
         "ms_fleet_16x100k": lw_fleet["ms"], "plain_ms_fleet_16x100k": lw_fleet["plain_ms"],
         "bound_ms_fleet_16x100k": lw_fleet["bound_ms"],
         "bound_by_fleet_16x100k": lw_fleet["bound_by"],
         "bound_share_fleet_16x100k": lw_fleet["bound_share"],
         "max_abs_err_fleet_16x100k": lw_fleet["max_abs_diff"],
         # Phase 20: the maze's 10k step on its 2400 px u8 table.
         "ms_maze_u8_10k": lw_maze["ms"], "plain_ms_maze_u8_10k": lw_maze["plain_ms"],
         "bound_ms_maze_u8_10k": lw_maze["bound_ms"], "bound_by_maze_u8_10k": lw_maze["bound_by"],
         "bound_share_maze_u8_10k": lw_maze["bound_share"],
         "max_abs_err_maze_u8_10k": lw_maze["max_abs_diff"],
         # Phase 21: the adversarial clouds of 16 robots x RAGGED_N.
         "max_abs_err_fleet_adversarial": fl["kernel_fleet_adversarial"]["max_abs_diff"],
         # Phase 27, in turns: padded (512 bf16, 384 u8) against unpadded
         # rows on four clouds, equal bit for bit.
         **{f"{key}_{cloud}_{t}": lw_pad[f"{cloud}_{t}"][key]
            for cloud in ("bench", "free_space", "uniform_1m", "adversarial")
            for t in ("bf16", "u8")
            for key in ("ms_padded", "ms_unpadded", "bound_ms", "bound_share_padded",
                        "bound_share_unpadded")},
         "ms_padded_bench": lw_pad["bench_bf16"]["ms_padded"],
         "bound_share_padded_bench": lw_pad["bench_bf16"]["bound_share_padded"],
         "ms_padded_1m_uniform": lw_pad["uniform_1m_bf16"]["ms_padded"],
         "bound_share_padded_1m_uniform": lw_pad["uniform_1m_bf16"]["bound_share_padded"]},
        {"name": "resample", "route": "cuda",
         "source": "slam_tpu_torch/csrc/resample.cu",
         "replaces": "none (slam_tpu/ops/resample.py:systematic_indices is plain XLA)",
         "launches": main_launches["resample"],
         # Phase 28: slots that differ from the plain path over its clouds
         # (each a draw within RESAMPLE_EDGE of a bin edge), the chain's
         # device ms beside its 32 N bytes bound and the plain chain's.
         "slots_differing": sum(c_["slots_differing"] for c_ in rs["clouds"].values()),
         "library_ms": None,
         **{f"{key}_{cloud}": rs["timed"][cloud][key] for cloud in RESAMPLE_TIMED
            for key in ("ms", "bound_ms", "bound_share", "plain_ms", "kernels_per_call")}},
        {"name": "estimate", "route": "cuda",
         "source": "slam_tpu_torch/csrc/estimate.cu",
         "replaces": "none (slam_tpu/models/mcl.py's estimate is plain XLA)",
         "launches": main_launches["estimate"],
         # Phase 29: the mode pose's widest gap from the plain estimate over
         # its clouds (the best pose and the tie share equal it bit for
         # bit), the chain's device ms beside its 20 N bytes bound and the
         # plain estimate's.
         "mode_gap_rel": max(c_["mode_gap_rel"] for c_ in es["clouds"].values()),
         "mode_gap_rad": max(c_["mode_gap_rad"] for c_ in es["clouds"].values()),
         "library_ms": None,
         **{f"{key}_{cloud}": es["timed"][cloud][key] for cloud in ESTIMATE_TIMED
            for key in ("ms", "bound_ms", "bound_share", "plain_ms", "kernels_per_call")}},
        # Phase 30: over the step's chunks of phase 19's shapes (1000 maps,
        # 90 beams, K = 1000), the kernel's ms beside its byte bound (the
        # steps marched; the cells written) and the plain path's chunks.
        {"name": "rbpf_march", "route": "cuda",
         "source": "slam_tpu_torch/csrc/rbpf_fidelity.cu",
         "replaces": "none (slam_tpu/ops/mapping.py:141, the fidelity update, is plain XLA)",
         "launches": main_launches["rbpf_march"],
         "ms": rf["march_ms"], "plain_ms": rf["plain_march_ms"],
         "bound_ms": rf["march_bound_ms"], "bound_by": rf["march_bound_by"],
         "bound_share": rf["march_bound_ms"] / rf["march_ms"], "library_ms": None,
         "mean_steps_marched": rf["mean_steps_marched"]},
        {"name": "rbpf_write", "route": "cuda",
         "source": "slam_tpu_torch/csrc/rbpf_fidelity.cu",
         "replaces": "none (slam_tpu/ops/mapping.py:141, the fidelity update, is plain XLA)",
         "launches": main_launches["rbpf_write"],
         "ms": rf["write_ms"], "plain_ms": rf["plain_write_ms"],
         "bound_ms": rf["write_bound_ms"], "bound_by": rf["write_bound_by"],
         "bound_share": rf["write_bound_ms"] / rf["write_ms"], "library_ms": None,
         "cells_written": rf["cells_written"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--parallel-rank":
        par_rank_main(sys.argv[2])  # one rank of a phase-23 world
    else:
        main()
    sys.exit(0)
