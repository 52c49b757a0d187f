"""The plain reference's closest-hit walk over its own SAH tree.

``tree`` builds the benchmark's binary SAH BVH (``sah.py``) over a scene's
triangles on the host, or reads it back from ``.gpubench_cache/`` in the
checkout, where the first build of a scene leaves it under a hash of the
triangles and of ``sah.py`` itself (the stress scene's build takes some
20 s).  ``closest_hit`` is the threaded walk over it: each ray holds one
node; a hit inner node falls through to the next node in preorder,
anything else jumps to its miss link.  Every box that can hold a closer
hit is opened, so the result is the exact closest hit whatever the tree:
of hits at the same t the lowest triangle id wins.  The box test runs in
float32 on boxes that bound the triangles as given, the triangle test in
the scene's own type.  With ``counts`` the walk adds the rays it walked,
their box tests and their triangle tests.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from gpubench.reference import sah
from gpubench.reference.mathutils import cross3, dot3

T_EPSILON = 1.0e-4   # a hit closer than this along the ray is the surface it left
DET_EPSILON = 1.0e-12
_BIG = 3.0e38
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                         ".gpubench_cache")


@dataclasses.dataclass(frozen=True)
class Tree:
    lo: torch.Tensor        # (N, 3) float32
    hi: torch.Tensor
    miss: torch.Tensor      # (N,) int64
    first: torch.Tensor     # (N,) int64, -1 on an inner node
    prim: torch.Tensor      # (S,) int64 triangle ids, -1 padding
    leaf_size: int


def _host_tree(positions: np.ndarray, tri_v: np.ndarray) -> sah.FlatBVH:
    h = hashlib.sha256(np.ascontiguousarray(positions, np.float32).tobytes())
    h.update(np.ascontiguousarray(tri_v, np.int32).tobytes())
    with open(sah.__file__, "rb") as f:
        h.update(f.read())
    path = os.path.join(CACHE_DIR, f"sah_{h.hexdigest()[:24]}.npz")
    fields = ("lo", "hi", "miss", "first", "count", "prim_idx")
    if os.path.exists(path):
        with np.load(path) as z:
            return sah.FlatBVH(**{k: z[k] for k in fields})
    p0, p1, p2 = (positions[tri_v[:, k]] for k in range(3))
    flat = sah.build_scene_bvh(np.minimum(np.minimum(p0, p1), p2), np.maximum(np.maximum(p0, p1), p2),
                               [(0, tri_v.shape[0])], 4)
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **{k: getattr(flat, k) for k in fields})
    os.replace(tmp, path)
    return flat


def tree(geometry) -> Tree:
    """The SAH tree of a scene's triangles as they are in the scene's own
    type, on the scene's device."""
    device = geometry.positions.device
    flat = _host_tree(geometry.positions.float().cpu().numpy(), geometry.tri_v.cpu().numpy().astype(np.int32))
    return Tree(lo=torch.as_tensor(flat.lo, device=device), hi=torch.as_tensor(flat.hi, device=device),
                miss=torch.as_tensor(flat.miss, device=device).long(),
                first=torch.as_tensor(flat.first, device=device).long(),
                prim=torch.as_tensor(flat.prim_idx, device=device).long(), leaf_size=flat.leaf_size)


def moller_trumbore(origin, direction, p0, p1, p2):
    """Möller–Trumbore on broadcastable (..., 3): ``(t, u, v, hit)``."""
    e1, e2 = p1 - p0, p2 - p0
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


def closest_hit(bvh: Tree, positions, tri_v, origins, directions, live=None, counts: dict | None = None):
    """(B,) int32 id of each live ray's closest triangle, -1 on a miss and
    on every ray that is not live."""
    B = origins.shape[0]
    dev = origins.device
    o32, d32 = origins.float(), directions.float()
    d_safe = torch.where(torch.abs(d32) < 1e-20, torch.where(d32 < 0, -1e-20, 1e-20), d32)
    inv_dir = 1.0 / d_safe
    node = torch.zeros(B, dtype=torch.int64, device=dev)
    t = torch.full((B,), _BIG, dtype=torch.float32, device=dev)
    tri = torch.full((B,), -1, dtype=torch.int64, device=dev)
    slots = torch.arange(bvh.leaf_size, device=dev)
    tv_all = tri_v.long()
    n_nodes = bvh.lo.shape[0]
    ray = torch.arange(B, device=dev) if live is None else torch.nonzero(live).squeeze(1)
    if counts is not None:
        counts["rays"] += int(ray.numel())
    while ray.numel():
        nd = node[ray]
        t0 = (bvh.lo[nd] - o32[ray]) * inv_dir[ray]
        t1 = (bvh.hi[nd] - o32[ray]) * inv_dir[ray]
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        hit_box = (tmax >= torch.clamp_min(tmin, 0.0)) & (tmin <= t[ray])
        first = bvh.first[nd]
        is_leaf = first >= 0
        leaf = hit_box & is_leaf
        if counts is not None:
            counts["boxes"] += int(ray.numel())
        if bool(leaf.any()):
            r = ray[leaf]
            ids = bvh.prim[first[leaf][:, None] + slots]                  # (L, leaf_size)
            if counts is not None:
                counts["tris"] += int((ids >= 0).sum())
            tv = tv_all[ids.clamp_min(0)]
            p0, p1, p2 = (positions[tv[..., k]] for k in range(3))
            tt, _, _, h = moller_trumbore(origins[r][:, None], directions[r][:, None], p0, p1, p2)
            h = h & (ids >= 0)
            tt = torch.where(h, tt.float(), _BIG)
            t_leaf = tt.amin(1)
            best = h & (tt == t_leaf[:, None])
            id_leaf = torch.where(best, ids, torch.iinfo(torch.int64).max).amin(1)
            closer = best.any(1) & ((t_leaf < t[r]) | ((t_leaf == t[r]) & (id_leaf < tri[r])))
            rc = r[closer]
            t[rc] = t_leaf[closer]
            tri[rc] = id_leaf[closer]
        nxt = torch.where(hit_box & ~is_leaf, nd + 1, bvh.miss[nd])
        node[ray] = nxt
        ray = ray[nxt < n_nodes]
    return tri.to(torch.int32)
