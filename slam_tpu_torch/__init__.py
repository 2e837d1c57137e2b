"""slam_tpu_torch: the PyTorch/CUDA port of slam_tpu for NVIDIA Hopper.

Mirrors `slam_tpu`'s layers (`core/`, `ops/`, `models/`, `utils/`) and
names. Plain tensor code is PyTorch; the two TPU Pallas kernels of the
MCL step are hand-written CUDA C++ under `csrc/` (built at first use by
`ops/_build.py`). A CUDA tensor goes to the kernel, a CPU tensor to the
kernel's plain PyTorch version beside it. On the card each planner search
replays CUDA graphs of its gated rounds (`planners/_graph.py`), the
counterpart of the JAX package's device `while_loop` solves.

This package never imports `jax` or `slam_tpu`: the machines it targets
need not have JAX installed.
"""

__version__ = "0.1.0"
