"""The odometry motion model's samples, worked out again from the filter's
random stream.

The filter draws from its own `torch.Generator`; the reference clones the
generator's state as it was before the request and replays the same
draws with torch's own random ops, in the order the step makes them:

  on the card  the motion kernel's seed, `randint(0, 2**62)` int64 [1];
               then the kernel's noise, which this module computes from
               that seed by the published algorithm the kernel
               implements: Philox4x32-10 (Salmon et al., SC'11) keyed by
               the seed with counter (particle index, 0, 0, 0), the top
               24 bits of each word a (0, 1] uniform, two Box-Muller pairs
               of which three normals are kept;
  on the CPU   three `randn(N)` (the plain sampler's).

Then the resampler's uniform `rand(())` (systematic), or the injection's
draws. The motion model (Thrun et al., Probabilistic Robotics, table
5.6): rot1, trans and rot2 perturbed by the alpha-mixed stddevs, then
integrated, the heading wrapped to [-pi, pi) by a floored modulo. Each
multiply-add the card's kernel rounds once is taken here in float64 and
rounded to float32 once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
_TWO_PI = float(np.float32(2.0 * math.pi))
_PI = float(np.float32(math.pi))


def clone(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of m * c for a 32-bit constant m and 32-bit
    words c held in int64, without overflowing 63 bits."""
    lo16, hi16 = c & 0xFFFF, c >> 16
    p_lo, p_hi = m * lo16, m * hi16
    return (p_hi + (p_lo >> 16)) >> 16, (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK


def philox(seed: int, n: int, device):
    """The four 32-bit words of Philox4x32-10 for counters (i, 0, 0, 0),
    i < n, under the 64-bit key `seed` (int64 tensors)."""
    c0 = torch.arange(n, dtype=torch.int64, device=device) & _MASK
    c1 = torch.zeros_like(c0)  # i >> 32 for i < 2^32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 8) + 1).to(torch.float32) * float(2.0 ** -24)


def kernel_noise(seed: int, n: int, device):
    """The three standard normals each particle draws under `seed`."""
    bx, by, bz, bw = philox(int(seed), n, device)
    two_pi = torch.tensor(_TWO_PI, dtype=torch.float32, device=device)
    ang_a, ang_b = two_pi * _uniform(by), two_pi * _uniform(bw)
    rad_a = torch.sqrt(-2.0 * torch.log(_uniform(bx)))
    rad_b = torch.sqrt(-2.0 * torch.log(_uniform(bz)))
    return rad_a * torch.cos(ang_a), rad_a * torch.sin(ang_a), rad_b * torch.cos(ang_b)


def stddevs(odom, alphas):
    """(r1, t, r2, std_r1, std_t, std_r2) in float32, one rounding an
    operation."""
    f = np.float32
    a0, a1, a2, a3 = (f(a) for a in alphas)
    r1, t, r2 = (f(v) for v in odom)
    tt = a1 * t * t
    return (r1, t, r2, np.sqrt(a0 * r1 * r1 + tt), np.sqrt(a2 * t * t + a3 * (r1 * r1 + r2 * r2)),
            np.sqrt(a0 * r2 * r2 + tt))


def _fma(a, b, c):
    """a * b + c rounded once to float32 (a, b, c float32 tensors or
    numbers)."""
    return (torch.as_tensor(a, dtype=torch.float64) * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).to(torch.float32)


def apply_kernel(odom, alphas, noise, x, y, th):
    """The card's sampled poses from (x, y, th) with the normals `noise`."""
    r1, t, r2, s1, st, s2 = (float(v) for v in stddevs(odom, alphas))
    n1, n2, n3 = noise
    rot1, trans, rot2 = _fma(-n1, s1, r1), _fma(-n2, st, t), _fma(-n3, s2, r2)
    a = th + rot1
    ox, oy = _fma(trans, torch.cos(a), x), _fma(trans, torch.sin(a), y)
    b = (a + rot2) + _PI
    two_pi = torch.tensor(_TWO_PI, dtype=torch.float32, device=x.device)
    q = torch.floor(b / two_pi)
    return ox, oy, _fma(-two_pi, q, b) - _PI


def apply_plain(odom, alphas, noise, x, y, th):
    """The CPU's sampled poses: the plain sampler's float32 operations."""
    a0, a1, a2, a3 = (float(a) for a in alphas)
    r1, t, r2 = (torch.tensor(float(v), dtype=torch.float32) for v in odom)
    s1 = torch.sqrt(a0 * r1 * r1 + a1 * t * t)
    st = torch.sqrt(a2 * t * t + a3 * (r1 * r1 + r2 * r2))
    s2 = torch.sqrt(a0 * r2 * r2 + a1 * t * t)
    n1, n2, n3 = noise
    rot1, trans, rot2 = r1 - n1 * s1, t - n2 * st, r2 - n3 * s2
    ox = x + trans * torch.cos(th + rot1)
    oy = y + trans * torch.sin(th + rot1)
    oth = torch.remainder(th + rot1 + rot2 + math.pi, 2.0 * math.pi) - math.pi
    return ox, oy, oth


def sample(gen: torch.Generator, odom, alphas, x, y, th):
    """The poses the filter's predict samples from (x, y, th), drawing
    from `gen` as the filter does on the poses' device."""
    n = x.shape[0]
    if x.is_cuda:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen, device=x.device,
                                 dtype=torch.int64).item())
        return apply_kernel(odom, alphas, kernel_noise(seed, n, x.device), x, y, th)
    noise = tuple(torch.randn((n,), generator=gen) for _ in range(3))
    return apply_plain(odom, alphas, noise, x, y, th)
