"""Ray–AABB and ray–triangle intersection on tensors.

The torch counterpart of ``fypraytracer_tpu/ops/intersect.py``; the same
two tests, per thread, are in ``csrc/traverse.cuh``:
  * slab test — BVH.cuh:124-165;
  * Möller–Trumbore with hit epsilon ``t > 1e-4`` — Renderer.cu:508-537.
"""

from __future__ import annotations

import torch

from fypraytracer_tpu_torch.core.mathutils import cross3, dot3

T_EPSILON = 1.0e-4   # Renderer.cu:531
DET_EPSILON = 1.0e-12


def ray_aabb(origin, inv_dir, lo, hi, t_best):
    """Slab test: hit mask (...,) for rays (..., 3) against boxes lo/hi.

    A box behind the ray or farther than ``t_best`` misses.  A box entered
    exactly at ``t_best`` is still visited (the JAX test is strict), so a
    triangle tying the best hit can win the tie (ops/traverse.py).
    """
    return ray_aabb_entry(origin, inv_dir, lo, hi, t_best)[0]


def ray_aabb_entry(origin, inv_dir, lo, hi, t_best):
    """``ray_aabb``'s hit mask and the entry t of each box."""
    t0 = (lo - origin) * inv_dir
    t1 = (hi - origin) * inv_dir
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    return (tmax >= torch.clamp_min(tmin, 0.0)) & (tmin <= t_best), tmin


def moller_trumbore(origin, direction, p0, p1, p2):
    """Möller–Trumbore (Renderer.cu:508-537) on broadcastable (..., 3).

    Returns ``(t, u, v, hit)``; ``hit`` enforces 0<=u, 0<=v, u+v<=1,
    t > T_EPSILON and a non-degenerate determinant.
    """
    return moller_trumbore_edges(origin, direction, p0, p1 - p0, p2 - p0)


def moller_trumbore_edges(origin, direction, p0, e1, e2):
    """``moller_trumbore`` of the triangle (p0, p0 + e1, p0 + e2), given its
    edges ``e1 = p1 - p0`` and ``e2 = p2 - p0`` (the wide BVH's records)."""
    pvec = cross3(direction, e2)
    det = dot3(e1, pvec, keepdims=False)
    valid_det = torch.abs(det) > DET_EPSILON
    inv_det = 1.0 / torch.where(valid_det, det, 1.0)
    tvec = origin - p0
    u = dot3(tvec, pvec, keepdims=False) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(direction, qvec, keepdims=False) * inv_det
    t = dot3(e2, qvec, keepdims=False) * inv_det
    hit = valid_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_EPSILON)
    return t, u, v, hit
