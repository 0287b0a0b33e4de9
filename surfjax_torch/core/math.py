"""Core vector/ray math on tensors.

Same formulas, in the same floating-point evaluation order, as
`surfjax/core/math.py`:
  * float32 everywhere;
  * dot products are ((x*x + y*y) + z*z), never `sum()`;
  * `normalize` is v * (1/sqrt(dot(v, v)));
  * integer powers use repeated squaring.

Vectors are component triplets (x, y, z) of same-shape tensors (SoA).
Python scalars that enter tensor arithmetic are first rounded to float32
with `f32`, so a product or comparison never sees a constant that the
float32 reference would not.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = float(np.float32(1e30))   # finite miss sentinel (no NaNs on miss lanes)


def f32(x) -> float:
    """A Python float holding the float32 rounding of x."""
    return float(np.float32(x))


def fdiv(a, b: float):
    """a / b for a Python float b, as a true float32 division on every
    device (PyTorch's CUDA division by a host scalar multiplies by the
    rounded reciprocal, which is not the same number)."""
    return a / torch.tensor(f32(b), dtype=torch.float32, device=a.device)


def sqrt(x):
    """Correctly rounded float32 square root on every device. PyTorch's
    vectorized float32 sqrt on the CPU is not (it differs from IEEE sqrt
    on ~0.7% of inputs), so the CPU takes the float64 root, rounded once
    to float32, which is exact; CUDA's sqrtf is IEEE."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


def vdot(a, b):
    """Fixed-association dot product: ((ax*bx + ay*by) + az*bz)."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vnormalize(a):
    inv = 1.0 / sqrt(vdot(a, a))
    return (a[0] * inv, a[1] * inv, a[2] * inv)


def _scalar(b, like):
    """A Python number as a 0-dim float tensor of like's dtype, kept on the
    CPU (a CPU scalar joins a tensor op on any device without a copy)."""
    return torch.tensor(b, dtype=like.dtype)


def maximum(a, b):
    """Elementwise max; a Python number on either side is taken as a
    tensor, so that at a tie each side gets half the gradient, as with
    jnp.maximum (torch.clamp would give it all to the tensor). The tensor
    goes first: at a tie of signed zeros torch returns the first operand,
    and the values stay those of torch.clamp."""
    if not isinstance(b, torch.Tensor):
        return torch.maximum(a, _scalar(b, a))
    if not isinstance(a, torch.Tensor):
        return torch.maximum(b, _scalar(a, b))
    return torch.maximum(a, b)


def minimum(a, b):
    """Elementwise min, ties as in maximum."""
    if not isinstance(b, torch.Tensor):
        return torch.minimum(a, _scalar(b, a))
    if not isinstance(a, torch.Tensor):
        return torch.minimum(b, _scalar(a, b))
    return torch.minimum(a, b)


def pow_int(x, n: int):
    """x**n for a static non-negative integer n, by repeated squaring."""
    if n < 0 or int(n) != n:
        raise ValueError(f"pow_int needs a non-negative integer, got {n}")
    n = int(n)
    if n == 0:
        return torch.ones_like(x)
    result = None
    base = x
    while n:
        if n & 1:
            result = base if result is None else result * base
        n >>= 1
        if n:
            base = base * base
    return result


def clamp(x, lo, hi):
    return minimum(maximum(x, lo), hi)


def saturate(x):
    return minimum(maximum(x, 0.0), 1.0)


def mix(a, b, t):
    return a + (b - a) * t


def quadratic_smallest_root(b_half, c):
    """Roots of t^2 + 2*b_half*t + c = 0 -> (t0, t1, has_roots), t0 <= t1;
    (BIG, -BIG, False) when there is no real root."""
    disc = b_half * b_half - c
    has = disc >= 0.0
    sq = sqrt(maximum(disc, 0.0))
    s = torch.where(b_half >= 0.0, 1.0, -1.0)
    q = -(b_half + s * sq)
    r0 = q
    r1 = torch.where(q != 0.0, c / q, -b_half)
    t0 = minimum(r0, r1)
    t1 = maximum(r0, r1)
    t0 = torch.where(has, t0, BIG)
    t1 = torch.where(has, t1, -BIG)
    return t0, t1, has


# Bitwise-portable float32 log: the same two-round polynomial as
# surfjax/core/math.py::portable_log, op for op. Domain: normal positive
# finite x (callers guard with max(x, 1e-30)).
_PLOG_C = tuple(f32(c) for c in (
    -0.4999999701976776, 0.33333322405815125,
    -0.2500077188014984, 0.2000196874141693,
    -0.1662759929895401, 0.1418900042772293,
    -0.131016343832016, 0.12821748852729797,
    -0.07866667956113815,
))
_PLOG_LN2_HI = f32(0.6931457519531250)
_PLOG_LN2_LO = f32(1.4286067653301955e-06)
_PLOG_SQRTH = f32(0.7071067811865476)


def portable_log(x):
    """Bitwise-portable natural log of a normal positive float32 tensor."""
    bits = x.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 126
    f = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = f < _PLOG_SQRTH
    f = torch.where(small, f + f, f)
    e = torch.where(small, e - 1, e)
    ef = e.to(torch.float32)
    u = f - 1.0
    g = torch.full_like(u, _PLOG_C[8])
    for c in _PLOG_C[7::-1]:
        g = g * u + c
    u2 = u * u
    l1p = u + u2 * g
    return ef * _PLOG_LN2_HI + (l1p + ef * _PLOG_LN2_LO)
