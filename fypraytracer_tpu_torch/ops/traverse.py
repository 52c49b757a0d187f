"""Closest-hit tracing against the threaded BVH.

``trace_rays`` is the plain PyTorch walk, the same algorithm as
``fypraytracer_tpu/ops/traverse.py::trace_rays``: every ray carries one
node index; an inner node whose box is hit falls through to ``i+1``,
anything else jumps to the skip link.  Each step works on the rays still
walking only, so a batch costs as many steps as its longest walk.

``trace_closest`` is the wrapper of the hand-written CUDA kernel
``csrc/trace.cu``, which replaces the TPU kernel
``fypraytracer_tpu/ops/pallas_dense.py::_intersect_kernel``.  It takes the
plain walk for CPU tensors only; for CUDA tensors it launches the kernel
or raises.  ``trace_closest.launches`` counts its kernel launches.

Both return ``dict(tri (B,) i32 (-1 miss), t (B,) f32 (-1 miss), u, v)``,
with t/u/v from Möller–Trumbore, as the JAX tracers do.

``segment_visible`` is the plain version of the device function of the same
name in ``csrc/traverse.cuh``: the visibility test of a segment that ReSTIR
GI's reconnections use.  ``trace_rays(..., counts=...)`` also counts the
walk's node visits and triangle tests, for the roofline bound that
``chip_smoke.py`` reports; no render path asks for counts.

Ties: of hits at exactly the same t, the lowest triangle id wins, as in
the TPU kernel (pallas_dense.py:65-70), so the result does not depend on
the walk order.  The JAX BVH walk keeps the first hit in walk order
instead; the two differ only on exact ties.  Those are not rare in the
Cornell box: camera rays along the image diagonals pass exactly through
the edges where the walls meet the floor and ceiling.
"""

from __future__ import annotations

import ctypes

import torch

from fypraytracer_tpu_torch.ops import kernels
from fypraytracer_tpu_torch.ops.intersect import moller_trumbore, ray_aabb
from fypraytracer_tpu_torch.scene.types import FlatBVH, Geometry

_BIG = 3.0e38

def trace_rays(bvh: FlatBVH, geometry: Geometry, origins, directions, t_max=None,
               stop_below=None, counts: dict | None = None):
    """Closest hit of a ray batch (B, 3) against the BVH — plain PyTorch.

    ``t_max``: optional (B,) upper bound on t.  ``stop_below``: optional
    (B,); a ray ends its walk once it has a hit with t below it (its result
    is then some hit below it, not necessarily the closest).  ``counts``:
    optional dict; the walk adds its node visits (box tests) to
    ``counts["nodes"]`` and its triangle tests to ``counts["tris"]`` (an
    int and a 0-d tensor).

    The rays are detached: which triangle a ray hits carries no gradient
    (the JAX tracers' ``stop_gradient``); ``ops.hit.hit_payload`` re-derives
    t/u/v from the ray and keeps its gradient.
    """
    origins, directions = origins.detach(), directions.detach()
    B = origins.shape[0]
    dev = origins.device
    n_nodes = bvh.lo.shape[0]
    slots = torch.arange(bvh.leaf_size, device=dev)

    d_safe = torch.where(torch.abs(directions) < 1e-20,
                         torch.where(directions < 0, -1e-20, 1e-20), directions)
    inv_dir = 1.0 / d_safe

    node = torch.zeros(B, dtype=torch.int64, device=dev)
    t = (torch.full((B,), _BIG, dtype=torch.float32, device=dev) if t_max is None
         else torch.as_tensor(t_max, dtype=torch.float32, device=dev).detach().clone())
    tri = torch.full((B,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(B, dtype=torch.float32, device=dev)
    v = torch.zeros(B, dtype=torch.float32, device=dev)

    ray = torch.arange(B, device=dev)           # rays still walking
    while ray.numel():
        if counts is not None:
            counts["nodes"] += ray.numel()
        nd = node[ray]
        o = origins[ray]
        hit_box = ray_aabb(o, inv_dir[ray], bvh.lo[nd], bvh.hi[nd], t[ray])
        first = bvh.first[nd].long()
        is_leaf = first >= 0

        leaf = hit_box & is_leaf
        if bool(leaf.any()):
            r = ray[leaf]
            tri_ids = bvh.prim_idx[first[leaf][:, None] + slots]          # (L, K)
            tv = geometry.tri_v[torch.clamp_min(tri_ids, 0).long()].long()
            p0 = geometry.positions[tv[..., 0]]
            p1 = geometry.positions[tv[..., 1]]
            p2 = geometry.positions[tv[..., 2]]
            tt, uu, vv, hit = moller_trumbore(origins[r][:, None], directions[r][:, None], p0, p1, p2)
            hit = hit & (tri_ids >= 0)
            if counts is not None:
                counts["tris"] = counts["tris"] + (tri_ids >= 0).sum()
            tt = torch.where(hit, tt, _BIG)
            t_leaf = tt.amin(dim=1)
            # lowest id among the slots at the leaf's closest t
            best = hit & (tt == t_leaf[:, None])
            id_leaf = torch.where(best, tri_ids, torch.iinfo(torch.int32).max).amin(dim=1)
            k = (best & (tri_ids == id_leaf[:, None])).int().argmax(dim=1, keepdim=True)
            closer = best.any(dim=1) & ((t_leaf < t[r]) | ((t_leaf == t[r]) & (id_leaf < tri[r])))
            rc = r[closer]
            t[rc] = t_leaf[closer]
            tri[rc] = id_leaf[closer]
            u[rc] = uu.gather(1, k)[:, 0][closer]
            v[rc] = vv.gather(1, k)[:, 0][closer]

        nxt = torch.where(hit_box & ~is_leaf, nd + 1, bvh.miss[nd].long())
        node[ray] = nxt
        walking = nxt < n_nodes
        if stop_below is not None:
            walking = walking & ~(t[ray] < stop_below[ray])
        ray = ray[walking]

    return dict(tri=tri, t=torch.where(tri < 0, -1.0, t), u=u, v=v)


def segment_visible(bvh: FlatBVH, geometry: Geometry, origins, directions, dist):
    """(B,) bool: the segment of length ``dist`` from each origin along its
    unit direction reaches its end.  True when no hit has t < dist − tol and
    some hit has t ≤ dist + tol, tol = max(1e-4, 1e-3·dist): the JAX
    megakernels' shadow test (megakernel.py:847-866), which is the
    wavefront's |t_closest − dist| ≤ tol.  A closest-hit walk bounded by
    dist + tol that stops at the first hit below dist − tol, as
    ``csrc/traverse.cuh::segment_visible`` walks.  A boolean: the inputs
    are detached."""
    origins, directions, dist = origins.detach(), directions.detach(), dist.detach()
    tol = torch.clamp_min(dist * 1e-3, 1e-4)
    lo, hi = dist - tol, dist + tol
    h = trace_rays(bvh, geometry, origins, directions,
                   t_max=torch.nextafter(hi, torch.full_like(hi, float("inf"))), stop_below=lo)
    return (h["tri"] >= 0) & (h["t"] >= lo)


_TRACE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] + [ctypes.c_void_p] * 5)


def trace_closest(bvh: FlatBVH, geometry: Geometry, origins, directions, t_max=None):
    """Closest hit through the CUDA kernel ``csrc/trace.cu`` (plain walk
    for CPU tensors).  Same contract as ``trace_rays``: the rays are
    detached, so the kernel never sees a tensor that requires grad."""
    if origins.device.type == "cpu":
        return trace_rays(bvh, geometry, origins, directions, t_max)
    origins = origins.detach().to(torch.float32).contiguous()
    directions = directions.detach().to(torch.float32).contiguous()
    tm = None if t_max is None else torch.as_tensor(
        t_max, dtype=torch.float32, device=origins.device).detach().contiguous()
    B = origins.shape[0]
    if origins.shape != (B, 3) or directions.shape != (B, 3):
        raise ValueError(f"trace_closest: rays must be (B, 3), got {tuple(origins.shape)}, "
                         f"{tuple(directions.shape)}")
    kernels.check_inputs("trace_closest",
                         floats=(origins, directions, geometry.positions, bvh.lo, bvh.hi)
                         + (() if tm is None else (tm,)),
                         ints=(geometry.tri_v, bvh.miss, bvh.first, bvh.prim_idx))
    return _launch_trace(bvh, geometry, origins, directions, tm,
                         kernels.stream_ptr(origins.device))


def _launch_trace(bvh, geometry, origins, directions, tm, stream):
    """Allocate the outputs and launch ``fyp_trace_closest`` on ``stream``
    (inputs already checked)."""
    fn = kernels.load("trace", "fyp_trace_closest", _TRACE_ARGTYPES)
    B = origins.shape[0]
    dev = origins.device
    tri = torch.empty(B, dtype=torch.int32, device=dev)
    t, u, v = (torch.empty(B, dtype=torch.float32, device=dev) for _ in range(3))
    P = kernels.ptr
    rc = fn(P(bvh.lo), P(bvh.hi), P(bvh.miss), P(bvh.first), P(bvh.prim_idx),
            bvh.lo.shape[0], bvh.leaf_size, P(geometry.positions), P(geometry.tri_v),
            P(origins), P(directions), ctypes.c_void_p(None) if tm is None else P(tm), B,
            P(tri), P(t), P(u), P(v), stream)
    trace_closest.launches += 1
    kernels.check(rc, "trace_closest")
    return dict(tri=tri, t=t, u=u, v=v)


trace_closest.launches = 0


def pick_tracer(scene):
    """A ``trace(o, d) -> tri`` closure over the scene: the CUDA kernel for
    CUDA tensors, the plain walk for CPU tensors (``trace_closest``)."""
    def trace(o, d):
        return trace_closest(scene.bvh, scene.geometry, o, d)["tri"]
    return trace
