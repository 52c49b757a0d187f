"""Counter-based PCG random numbers on int64 tensors.

A frozen copy of the path tracer's published generator: a path key is the
PCG output permutation folded over (pixel, frame, sample, stream), and
each draw advances the key through ``pcg_hash``.  It draws the same bits
for the same counters as the renderer under test, so a reference lane
traces the path the renderer traces.

torch has no complete uint32 arithmetic, so keys live in int64 tensors
holding values in [0, 2^32).  Shifts, XOR and masks are exact there.  A
product of two 32-bit values does not fit in int64, so ``_mul32`` splits
the constant into 16-bit halves: each partial product stays below 2^48
and the low 32 bits of the sum are the uint32 product.  Python ints are
accepted too (exact big-int arithmetic, masked the same way).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# PCG-RXS-M-XS-32 constants (fypraytracer_tpu/core/rng.py:24-28)
_MUL1 = 747796405
_INC = 2891336453
_MUL2 = 277803737
_GOLDEN = 0x9E3779B9

# top 24 bits × 2^-24: exact in float32 (fypraytracer_tpu/core/rng.py:30-36)
_INV_24 = 1.0 / 16777216.0


def _mul32(x, c: int):
    """``(x * c) mod 2^32`` for x in [0, 2^32) and a constant c < 2^32."""
    if isinstance(x, int):
        return (x * c) & MASK32
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def as_u32(x):
    """A uint32 view of ``x`` as an int64 tensor (or a masked Python int)."""
    if isinstance(x, int):
        return x & MASK32
    return x.to(torch.int64) & MASK32


def pcg_hash(x):
    """PCG output permutation: uint32 -> uint32 (MathUtils.cuh:47-52)."""
    state = (_mul32(x, _MUL1) + _INC) & MASK32
    word = _mul32(((state >> ((state >> 28) + 4)) ^ state), _MUL2)
    return (word >> 22) ^ word


def fold(key, data):
    """Mix ``data`` into ``key`` (both uint32), order-sensitively."""
    return pcg_hash(key ^ ((_mul32(data, _GOLDEN) + _INC) & MASK32))


def path_key(pixel_id, frame, sample, stream=0):
    """Per-path key: ``fold(fold(fold(pcg(pixel), frame), sample), stream)``."""
    k = pcg_hash(as_u32(pixel_id))
    k = fold(k, as_u32(frame))
    k = fold(k, as_u32(sample))
    return fold(k, as_u32(stream))


def next_uniform(key, dtype=torch.float32):
    """Advance the key; return ``(new_key, u)`` with u in [0, 1), drawn in
    float32 and then rounded to ``dtype``."""
    new_key = pcg_hash(key)
    return new_key, ((new_key >> 8).to(torch.float32) * _INV_24).to(dtype)


def uniforms(key, n: int, dtype=torch.float32):
    """Draw ``n`` sequential uniforms; returns (new_key, list-of-tensors)."""
    us = []
    for _ in range(n):
        key, u = next_uniform(key, dtype)
        us.append(u)
    return key, us
