"""30-bit Morton codes on the host (NumPy).

A frozen copy of the path tracer's published Morton codes
(MortonCode.cuh:11-38 semantics): ``scenes`` orders the stress scene's
triangles with them, as the renderer's Morton order does.
"""

from __future__ import annotations

import numpy as np


def expand_bits(v):
    """Spread the low 10 bits of each element to every 3rd bit
    (MortonCode.cuh:11-24)."""
    v = np.asarray(v).astype(np.uint32) & np.uint32(0x3FF)
    v = (v | (v << np.uint32(16))) & np.uint32(0x030000FF)
    v = (v | (v << np.uint32(8))) & np.uint32(0x0300F00F)
    v = (v | (v << np.uint32(4))) & np.uint32(0x030C30C3)
    v = (v | (v << np.uint32(2))) & np.uint32(0x09249249)
    return v


def morton3d(points, lo, hi):
    """30-bit Morton codes for (..., 3) points inside the box [lo, hi]
    (MortonCode.cuh:26-38)."""
    q = np.clip((np.asarray(points) - lo) / (hi - lo), 0.0, 1.0)
    g = np.minimum(q * 1024.0, 1023.0).astype(np.uint32)
    return (expand_bits(g[..., 0]) << np.uint32(2)) \
        | (expand_bits(g[..., 1]) << np.uint32(1)) \
        | expand_bits(g[..., 2])
