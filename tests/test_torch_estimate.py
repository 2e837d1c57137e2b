"""The filter's best and mode poses: the plain `estimate` (the CPU's route
and the specification of the card's kernel chain, `csrc/estimate.cu`) on
hand-worked cases, and the chain's wrapper refusing what the kernel does
not take before anything is built."""

import math

import numpy as np
import pytest
import torch

from slam_tpu_torch.core.types import Pose
from slam_tpu_torch.models import mcl

N = 10


def _pose(r=None, n=N):
    """x = 2 + 1.5 i, y = -i, theta = 0.25 at particle i (each row alike)."""
    i = torch.arange(n, dtype=torch.float32)
    p = Pose(x=2.0 + 1.5 * i, y=-i, theta=torch.full((n,), 0.25))
    if r is None:
        return p
    return Pose(x=p.x.repeat(r, 1), y=p.y.repeat(r, 1), theta=p.theta.repeat(r, 1))


def _distinct_lw(n=N):
    """Measurement log weights with a single top score: informative."""
    return -10.0 * torch.arange(n, dtype=torch.float32)


def _assert_pose(got: Pose, want, rtol=0.0):
    for g, w in zip((got.x, got.y, got.theta), want):
        np.testing.assert_allclose(g.numpy(), np.float32(w), rtol=rtol, atol=0)


def _at(k):
    return (2.0 + 1.5 * k, -float(k), 0.25)


# log_weight -> the first maximum torch.argmax (and jnp.argmax) picks.
FIRST_MAXIMUM = {
    "equal_maxima": ({3: 5.0, 7: 5.0}, 3),
    "nan_above_all": ({6: math.nan, 2: math.nan, 4: 1e30}, 2),
    "minus_inf_rest": ({i: -math.inf for i in range(N) if i not in (5, 8)} | {5: -7.0, 8: -7.0},
                       5),
    "all_minus_inf": ({i: -math.inf for i in range(N)}, 0),
    "signed_zeros": ({i: -1.0 for i in range(N)} | {4: 0.0, 1: -0.0}, 1),
}


@pytest.mark.parametrize("case", FIRST_MAXIMUM)
def test_plain_estimate_takes_the_first_maximum(case):
    """Among equal maxima the lowest index; a NaN above every number, the
    first NaN; -inf everywhere still index 0; -0.0 == 0.0. The measurement
    is informative, so the best pose is that particle's, bit for bit."""
    planted, k = FIRST_MAXIMUM[case]
    log_weight = torch.zeros(N)
    for i, v in planted.items():
        log_weight[i] = v
    for fn in (mcl.plain_estimate, mcl.estimate):  # the CPU's route is the plain one
        best, _ = fn(_pose(), log_weight, _distinct_lw(), 1.0)
        _assert_pose(best, _at(k))


# Top-score ties of the measurement -> the tie share and whether the best
# pose falls back to the mode pose (share 0.5 or more).
TIES = {"below_half": (4, False), "at_half": (5, True), "above_half": (6, True)}


@pytest.mark.parametrize("case", TIES)
def test_plain_estimate_falls_back_at_a_majority_tie(case):
    """N = 10, top score 100: tol = max(1e-6 * 100, 1e-6) = 1e-4, so a
    score 5e-5 below the top ties it and one 2e-4 below does not. With
    log_weight log(3) at particle 2 and 0 elsewhere (tau 1) the weights are
    3/12 there and 1/12 elsewhere: mode x = (sum x + 2 x_2) / 12 =
    (87.5 + 10) / 12, y = (-45 - 4) / 12, theta 0.25."""
    ties, falls_back = TIES[case]
    lw = _distinct_lw() - 1000.0
    lw[:ties - 1] = 100.0
    lw[ties - 1] = 100.0 - 5e-5  # within the relative tolerance
    lw[ties] = 100.0 - 2e-4  # outside it
    log_weight = torch.zeros(N)
    log_weight[2] = math.log(3.0)
    best, mode = mcl.plain_estimate(_pose(), log_weight, lw, 1.0)
    want_mode = (97.5 / 12.0, -49.0 / 12.0, 0.25)
    _assert_pose(mode, want_mode, rtol=1e-6)
    if falls_back:
        _assert_pose(best, (mode.x, mode.y, mode.theta))
    else:
        _assert_pose(best, _at(2))


def test_plain_estimate_rows_each_decide():
    """[R, N] rows are filters of their own: row 0 informative with its
    maximum at 7; row 1 uninformative (every score equal, share 1), so its
    best pose is its mode, the plain mean under equal log weights; row 2
    informative with equal maxima at 1 and 8."""
    log_weight = torch.zeros(3, N)
    log_weight[0, 7] = 2.0
    log_weight[2, 1] = log_weight[2, 8] = 4.0
    lw = _distinct_lw().repeat(3, 1)
    lw[1] = 3.0
    best, mode = mcl.plain_estimate(_pose(3), log_weight, lw, 1.0)
    assert best.x.shape == mode.x.shape == (3,)
    _assert_pose(Pose(x=best.x[0], y=best.y[0], theta=best.theta[0]), _at(7))
    _assert_pose(Pose(x=mode.x[1], y=mode.y[1], theta=mode.theta[1]),
                 (2.0 + 1.5 * 4.5, -4.5, 0.25), rtol=1e-6)
    _assert_pose(Pose(x=best.x[1], y=best.y[1], theta=best.theta[1]),
                 (mode.x[1], mode.y[1], mode.theta[1]))
    _assert_pose(Pose(x=best.x[2], y=best.y[2], theta=best.theta[2]), _at(1))


def _wrapper_args(r=2, n=8):
    pose = Pose(x=torch.zeros(r, n), y=torch.zeros(r, n), theta=torch.zeros(r, n))
    return dict(pose=pose, log_weight=torch.zeros(r, n), lw=torch.zeros(r, n))


def _bad(name):
    a = _wrapper_args()
    r, n = a["log_weight"].shape
    p = a["pose"]
    if name == "log_weight_dtype":
        a["log_weight"] = a["log_weight"].double()
    elif name == "lw_dtype":
        a["lw"] = a["lw"].half()
    elif name == "pose_strided":
        a["pose"] = Pose(x=p.x, y=torch.zeros(n, r).t(), theta=p.theta)
    elif name == "lw_strided":
        a["lw"] = torch.zeros(r, 2 * n)[:, ::2]
    elif name == "lw_shape":
        a["lw"] = torch.zeros(n)
    elif name == "pose_shape":
        a["pose"] = Pose(x=p.x, y=p.y, theta=torch.zeros(r, n + 1))
    elif name == "log_weight_3d":
        a = _wrapper_args()
        a = {k: (Pose(x=v.x[None], y=v.y[None], theta=v.theta[None]) if k == "pose" else v[None])
             for k, v in a.items()}
    elif name == "empty":
        a = _wrapper_args(n=0)
    elif name == "rows":
        a = _wrapper_args(r=65536, n=1)
    return a


@pytest.mark.parametrize("name", ["log_weight_dtype", "lw_dtype", "pose_strided", "lw_strided",
                                  "lw_shape", "pose_shape", "log_weight_3d", "empty", "rows",
                                  "cpu"])
def test_estimate_cuda_wrapper_rejects(name):
    """`estimate_cuda.launch` raises ValueError, before any build, on a
    wrong dtype, layout, shape or count of rows, and on tensors off the
    card (the last case: every argument right, on the CPU); no launch is
    counted. The plain route on CPU tensors never counts one either."""
    from slam_tpu_torch.ops import estimate_cuda

    before = estimate_cuda.launch.launches
    a = _bad(name)
    with pytest.raises(ValueError):
        estimate_cuda.launch(a["pose"], a["log_weight"], a["lw"], 1.0)
    a = _wrapper_args()
    mcl.estimate(a["pose"], a["log_weight"], a["lw"], 1.0)
    assert estimate_cuda.launch.launches == before


@pytest.mark.parametrize("r, n, words", [(1, 4096, 0), (1, 4097, 10 * 5 + 1),
                                         (16, 100_000, 16 * (10 * 98 + 1)),
                                         (1, 1_000_000, 10 * 512 + 1)])
def test_estimate_cuda_scratch_and_mean_factor(r, n, words):
    """The chain's scratch: none at one block's 4096 particles a row or
    fewer, else a row's ticket and 10 words for each of its blocks, one a
    1024-particle tile up to 512. The tie share's factor is the one
    PyTorch's CUDA mean takes, f32(R) / f32(R * N), which for these shapes
    is f32(1 / N)."""
    from slam_tpu_torch.ops import estimate_cuda

    assert estimate_cuda.scratch_words(r, n) == words
    assert estimate_cuda.mean_factor(r, n) == np.float32(1.0) / np.float32(n)
