"""Closest-hit tracing against the scene's BVH.

``trace_rays`` is the plain PyTorch walk of the threaded binary BVH, the
same algorithm as ``fypraytracer_tpu/ops/traverse.py::trace_rays``: every
ray carries one node index; an inner node whose box is hit falls through
to ``i+1``, anything else jumps to the skip link.  Each step works on the
rays still walking only, so a batch costs as many steps as its longest
walk.  It is the plain version every kernel is held against.

``trace_rays_wide`` walks the scene's 4-wide BVH (``Scene.wide``,
``accel/wide.py``) in the order of the CUDA walk ``csrc/wide.cuh``: near
child first, a stack, entries pruned on pop.  It gives what ``trace_rays``
gives, bit for bit, and rehearses the kernel's logic on the CPU.

``trace_closest(scene, ...)`` is the wrapper of the hand-written CUDA
kernel ``csrc/trace.cu`` (K1), which replaces the TPU kernel
``fypraytracer_tpu/ops/pallas_dense.py::_intersect_kernel`` and walks the
wide BVH with ``k1_lanes`` threads a ray.  It takes the plain walk for CPU
tensors only; for CUDA tensors it launches the kernel or raises (also on
a scene without its wide BVH).  ``trace_closest.launches`` counts its
kernel launches.

It returns ``dict(tri (B,) i32 (-1 miss), t (B,) f32 (-1 miss), u, v)``,
with t/u/v from Möller–Trumbore, as the JAX tracers do.

``segment_visible`` is the plain visibility test of a segment through the
threaded BVH, which the plain versions of the ReSTIR GI kernels' (K5, K7)
reconnections use.  ``segment_visible_wide`` is the same test walked in
the order of ``csrc/wide.cuh::segment_visible_wide1`` (K5's), and
``trace_segments`` launches that device function on a batch of segments
(``csrc/trace.cu::fyp_segment_visible``), so that the card can hold it
against its plain twin.  ``trace_rays(..., counts=...)`` also counts the
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
import functools

import torch

from fypraytracer_tpu_torch.accel.wide import EMPTY, MAX_STACK, WIDTH, unpack_nodes
from fypraytracer_tpu_torch.ops import kernels
from fypraytracer_tpu_torch.ops.intersect import moller_trumbore, moller_trumbore_edges, ray_aabb, ray_aabb_entry
from fypraytracer_tpu_torch.scene.types import FlatBVH, Geometry, WideBVH

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
            if counts is not None:
                counts["tris"] = counts["tris"] + (tri_ids >= 0).sum()
            _keep_closest(r, tri_ids, tt, uu, vv, hit, t, tri, u, v)

        nxt = torch.where(hit_box & ~is_leaf, nd + 1, bvh.miss[nd].long())
        node[ray] = nxt
        walking = nxt < n_nodes
        if stop_below is not None:
            walking = walking & ~(t[ray] < stop_below[ray])
        ray = ray[walking]

    return dict(tri=tri, t=torch.where(tri < 0, -1.0, t), u=u, v=v)


def _keep_closest(r, ids, tt, uu, vv, hit, t, tri, u, v):
    """Fold the tests of a leaf's slots (L, K) into the running hits of the
    rays r: the leaf's closest hit, of those at the same t the lowest id,
    replaces the ray's (t, tri, u, v) where it is closer or ties it with a
    lower id.  Padding slots (id -1) never hit."""
    hit = hit & (ids >= 0)
    tt = torch.where(hit, tt, _BIG)
    t_leaf = tt.amin(dim=1)
    best = hit & (tt == t_leaf[:, None])
    id_leaf = torch.where(best, ids, torch.iinfo(torch.int32).max).amin(dim=1)
    k = (best & (ids == id_leaf[:, None])).int().argmax(dim=1, keepdim=True)
    closer = best.any(dim=1) & ((t_leaf < t[r]) | ((t_leaf == t[r]) & (id_leaf < tri[r])))
    rc = r[closer]
    t[rc] = t_leaf[closer]
    tri[rc] = id_leaf[closer]
    u[rc] = uu.gather(1, k)[:, 0][closer]
    v[rc] = vv.gather(1, k)[:, 0][closer]


_POP = -1     # the walk's "take the next stack entry"


def trace_rays_wide(wide: WideBVH, origins, directions, t_max=None, counts: dict | None = None,
                    stop_below=None):
    """Closest hit of a ray batch (B, 3) through the 4-wide BVH's records —
    plain PyTorch, in the order of ``csrc/wide.cuh::trace_closest_wide``.

    At an inner node the four child boxes are tested with the slab test
    of ``ray_aabb`` (inclusive at ``t_best``), the hit children sorted by
    entry t (ties to the lower child), the nearest taken next and the
    others pushed, farthest first.  At a leaf the four slots are tested
    and the best (t, id) of them kept as ``trace_rays`` keeps it.  An
    entry popped from the stack is skipped unless its entry t is still
    ``<= t_best``.  Returns what ``trace_rays`` returns, and the same hits:
    the closest, ties to the lowest id, whatever the order of the walk.
    ``counts`` (optional dict) gets ``"nodes"`` (inner node visits) and
    ``"leaves"`` (leaf visits) added.  ``stop_below``: optional (B,); a ray
    ends its walk at the leaf that gives it a hit below it (as
    ``trace_rays``'s).  The CPU rehearsal of the kernel's logic;
    ``trace_rays`` stays the plain version the kernels are held to.
    """
    origins, directions = origins.detach(), directions.detach()
    B = origins.shape[0]
    dev = origins.device
    box_lo, box_hi, box_ref = unpack_nodes(wide.nodes)
    box_ref = box_ref.long()
    p0, e1, e2 = wide.tris[:, 0, :3], wide.tris[:, 1, :3], wide.tris[:, 2, :3]
    tri_id = wide.tris[:, 0, 3].contiguous().view(torch.int32)
    lanes = torch.arange(WIDTH, device=dev)

    d_safe = torch.where(torch.abs(directions) < 1e-20,
                         torch.where(directions < 0, -1e-20, 1e-20), directions)
    inv_dir = 1.0 / d_safe

    t = (torch.full((B,), _BIG, dtype=torch.float32, device=dev) if t_max is None
         else torch.as_tensor(t_max, dtype=torch.float32, device=dev).detach().clone())
    tri = torch.full((B,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(B, dtype=torch.float32, device=dev)
    v = torch.zeros(B, dtype=torch.float32, device=dev)
    cur = torch.zeros(B, dtype=torch.int64, device=dev)          # the root
    depth = max(wide.stack_need, 1)
    st_ref = torch.zeros((B, depth), dtype=torch.int64, device=dev)
    st_t = torch.zeros((B, depth), dtype=torch.float32, device=dev)
    sp = torch.zeros(B, dtype=torch.int64, device=dev)

    ray = torch.arange(B, device=dev)           # rays still walking
    while ray.numel():
        c = cur[ray]
        inner, leaf = c >= 0, c <= -2
        if bool(inner.any()):
            r, nd = ray[inner], c[inner]
            if counts is not None:
                counts["nodes"] = counts.get("nodes", 0) + r.numel()
            hit, tmin = ray_aabb_entry(origins[r][:, None], inv_dir[r][:, None], box_lo[nd], box_hi[nd],
                                       t[r][:, None])
            ref = box_ref[nd]
            hit = hit & (ref != EMPTY)
            key = torch.where(hit, tmin, float("inf"))
            key, order = torch.sort(key, dim=1, stable=True)
            ref = ref.gather(1, order)
            n_hit = hit.sum(dim=1)
            for j in range(WIDTH - 1, 0, -1):       # farthest first, so the nearest pops first
                m = n_hit > j
                rm = r[m]
                st_ref[rm, sp[rm]] = ref[m, j]
                st_t[rm, sp[rm]] = key[m, j]
                sp[rm] += 1
            cur[r] = torch.where(n_hit > 0, ref[:, 0], _POP)
        if bool(leaf.any()):
            r = ray[leaf]
            if counts is not None:
                counts["leaves"] = counts.get("leaves", 0) + r.numel()
            slot = WIDTH * (-c[leaf] - 2)[:, None] + lanes                  # (L, 4)
            tt, uu, vv, hit = moller_trumbore_edges(origins[r][:, None], directions[r][:, None],
                                                    p0[slot], e1[slot], e2[slot])
            _keep_closest(r, tri_id[slot], tt, uu, vv, hit, t, tri, u, v)
            cur[r] = _POP
            if stop_below is not None:
                sp[r[t[r] < stop_below[r]]] = 0          # nothing left to pop: the walk ends
        # pop the nearest entry still in reach; a ray with an empty stack is done
        popping = ray[cur[ray] == _POP]
        while popping.numel():
            has = sp[popping] > 0
            popping = popping[has]
            sp[popping] -= 1
            te = st_t[popping, sp[popping]]
            take = te <= t[popping]
            cur[popping[take]] = st_ref[popping[take], sp[popping[take]]]
            popping = popping[~take]
        ray = ray[cur[ray] != _POP]

    return dict(tri=tri, t=torch.where(tri < 0, -1.0, t), u=u, v=v)


def _segment_ends(dist):
    """The bounds of the segment test: hits below ``lo`` block a segment,
    and the walk's bound ``t_max`` lies just above dist + tol, so that a hit
    at t <= dist + tol counts."""
    tol = torch.clamp_min(dist * 1e-3, 1e-4)
    hi = dist + tol
    return dist - tol, torch.nextafter(hi, torch.full_like(hi, float("inf")))


def segment_visible(bvh: FlatBVH, geometry: Geometry, origins, directions, dist):
    """(B,) bool: the segment of length ``dist`` from each origin along its
    unit direction reaches its end.  True when no hit has t < dist − tol and
    some hit has t ≤ dist + tol, tol = max(1e-4, 1e-3·dist): the JAX
    megakernels' shadow test (megakernel.py:847-866), which is the
    wavefront's |t_closest − dist| ≤ tol.  A closest-hit walk bounded by
    dist + tol that stops at the first hit below dist − tol.  A boolean:
    the inputs are detached."""
    origins, directions, dist = origins.detach(), directions.detach(), dist.detach()
    lo, t_max = _segment_ends(dist)
    h = trace_rays(bvh, geometry, origins, directions, t_max=t_max, stop_below=lo)
    return (h["tri"] >= 0) & (h["t"] >= lo)


def segment_visible_wide(wide: WideBVH, origins, directions, dist):
    """``segment_visible`` through the 4-wide BVH's records, in the order of
    ``csrc/wide.cuh::segment_visible_wide1``: the walk of
    ``trace_rays_wide`` bounded by dist + tol, ending at the first leaf
    that gives a hit below dist − tol.  The same boolean as
    ``segment_visible`` for every segment: its bound never falls below
    dist − tol, so a box it prunes holds no hit that blocks the segment or
    ends it."""
    origins, directions, dist = origins.detach(), directions.detach(), dist.detach()
    lo, t_max = _segment_ends(dist)
    h = trace_rays_wide(wide, origins, directions, t_max=t_max, stop_below=lo)
    return (h["tri"] >= 0) & (h["t"] >= lo)


def wide_records(scene) -> WideBVH:
    """The scene's wide BVH for a CUDA walk.  Raises if the scene has none
    (``SceneBuilder.compile``, ``scene_from_arrays`` and
    ``morton_permuted_scene`` build it) or if its walk could need more
    stack than the kernels hold."""
    wide = scene.wide
    if wide is None:
        raise ValueError("the scene has no wide BVH (accel/wide.py::build_wide); the CUDA walk needs it")
    if wide.stack_need > MAX_STACK:
        raise ValueError(f"the wide BVH needs a stack of {wide.stack_need} entries; the kernels' stacks fit "
                         f"{MAX_STACK} in a block's shared memory (accel/wide.py::MAX_STACK)")
    return wide


def stack_depth(wide: WideBVH) -> int:
    """The entries of a walk's stack the kernels allocate for this tree."""
    return max(wide.stack_need, 1)


_OVERFLOW_MSG = ("a wide-BVH walk overflowed its stack (Scene.wide.overflow): the tree needs more than its "
                 "stack_need, and the hits of that call are wrong")


def check_overflow(scene) -> None:
    """Raise if a CUDA walk over the scene's wide BVH ever dropped a stack
    entry (the kernels' flag; reading it waits for the card)."""
    if scene.wide is not None and int(scene.wide.overflow.item()) != 0:
        raise RuntimeError(_OVERFLOW_MSG)


class OverflowWatch:
    """An entry point's read of ``Scene.wide.overflow``, the flag a CUDA
    walk sets when it drops a stack entry, without a host wait.

    At the end of each call ``queue()`` puts a copy of the flag into pinned
    host memory on the stream, behind the call's launches, and records the
    watch's one event again; at the start of the next call ``poll()``
    raises if that copy has landed (the event has completed: a query,
    never a wait) and shows the flag set.  The flag is never cleared, so
    every copy writes the same or a later value, and a copy that has not
    landed yet is read by a later call.  ``check()`` waits for the card and
    reads the flag itself, for a caller that reads the image on the host
    anyway.  On CPU tensors the flag is read directly: the plain walks
    never set it.
    """

    def __init__(self, scene):
        self.flag = None if scene.wide is None else scene.wide.overflow
        self.cuda = self.flag is not None and self.flag.device.type == "cuda"
        self.host = torch.zeros(1, dtype=torch.int32).pin_memory() if self.cuda else None
        self.seen = None if self.host is None else self.host.numpy()      # the pinned copy, read without torch
        self.event = torch.cuda.Event() if self.cuda else None
        self.queued = False

    def poll(self) -> None:
        """Raise if a copy queued by an earlier call has landed and is set."""
        if self.flag is None:
            return
        if not self.cuda:
            if int(self.flag[0]) != 0:
                raise RuntimeError(_OVERFLOW_MSG)
            return
        if self.queued and self.event.query():
            self.queued = False
            if self.seen[0] != 0:
                raise RuntimeError(_OVERFLOW_MSG)

    def queue(self) -> None:
        """Copy the flag to the host behind the launches queued so far
        (nothing to copy on the CPU: ``poll`` reads the flag)."""
        if not self.cuda:
            return
        self.host.copy_(self.flag, non_blocking=True)
        self.event.record()
        self.queued = True

    def check(self) -> None:
        """Wait for the card and raise if the flag is set."""
        if self.flag is not None and int(self.flag.item()) != 0:
            raise RuntimeError(_OVERFLOW_MSG)


def _rays(name, origins, directions, t_max):
    """The rays as contiguous float32 (B, 3), detached, and t_max or None."""
    origins = origins.detach().to(torch.float32).contiguous()
    directions = directions.detach().to(torch.float32).contiguous()
    B = origins.shape[0]
    if origins.shape != (B, 3) or directions.shape != (B, 3):
        raise ValueError(f"{name}: rays must be (B, 3), got {tuple(origins.shape)}, {tuple(directions.shape)}")
    tm = None if t_max is None else torch.as_tensor(
        t_max, dtype=torch.float32, device=origins.device).detach().contiguous()
    if tm is not None and tm.shape != (B,):
        raise ValueError(f"{name}: t_max must be (B,), got {tuple(tm.shape)}")
    return origins, directions, tm


def _outputs(B, dev):
    """The (tri, t, u, v) outputs of a trace, in one allocation."""
    out = torch.empty((4, B), dtype=torch.float32, device=dev)
    return dict(tri=out[0].view(torch.int32), t=out[1], u=out[2], v=out[3])


_P = ctypes.c_void_p
_TRACE_ARGTYPES = [_P] * 6 + [ctypes.c_int] + [_P] * 4 + [ctypes.c_int] * 2 + [_P]


@functools.lru_cache(maxsize=None)
def _resident_threads(index: int) -> int:
    p = torch.cuda.get_device_properties(index)
    return p.multi_processor_count * p.max_threads_per_multi_processor


def k1_lanes(n_rays: int, device) -> int:
    """K1's threads a ray (csrc/trace.cu): a quad, which shares each node's
    four children, while the batch's quads fit on the card at once; one
    thread, which tests all four itself and costs fewer instructions a
    ray, for a batch larger than that."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return 4 if 4 * n_rays <= _resident_threads(index) else 1


def trace_closest(scene, origins, directions, t_max=None, lanes=None):
    """Closest hit through the CUDA kernel ``csrc/trace.cu``, ``lanes``
    threads (4 or 1; by default ``k1_lanes``) walking each ray through the
    scene's wide BVH (``trace_rays`` for CPU tensors).  Same contract as
    ``trace_rays``: the rays are detached, so the kernel never sees a
    tensor that requires grad."""
    if origins.device.type == "cpu":
        return trace_rays(scene.bvh, scene.geometry, origins, directions, t_max)
    wide = wide_records(scene)
    origins, directions, tm = _rays("trace_closest", origins, directions, t_max)
    kernels.check_inputs("trace_closest", floats=(origins, directions, wide.nodes, wide.tris)
                         + (() if tm is None else (tm,)), ints=(wide.overflow,))
    if lanes is None:
        lanes = k1_lanes(origins.shape[0], origins.device)
    return _launch_trace(wide, origins, directions, tm, kernels.stream_ptr(origins.device), lanes)


def _launch_trace(wide, origins, directions, tm, stream, lanes):
    """Allocate the outputs and launch ``fyp_trace_closest`` on ``stream``
    with ``lanes`` threads a ray (inputs already checked)."""
    fn = kernels.load("trace", "fyp_trace_closest", _TRACE_ARGTYPES)
    B = origins.shape[0]
    out = _outputs(B, origins.device)
    P = kernels.ptr
    rc = fn(P(wide.nodes), P(wide.tris), P(wide.overflow), P(origins), P(directions),
            _P(None) if tm is None else P(tm), B, P(out["tri"]), P(out["t"]), P(out["u"]), P(out["v"]), lanes,
            stack_depth(wide), stream)
    trace_closest.launches += 1
    kernels.check(rc, "trace_closest")
    return out


trace_closest.launches = 0


_SEGMENT_ARGTYPES = [_P] * 6 + [ctypes.c_int, _P, ctypes.c_int, _P]


def trace_segments(scene, origins, directions, dist):
    """(B,) bool: ``segment_visible_wide`` through the device function K5
    walks (``csrc/wide.cuh::segment_visible_wide1``), launched one thread a
    segment by ``csrc/trace.cu::fyp_segment_visible`` (the plain twin for
    CPU tensors).  ``trace_segments.launches`` counts its launches."""
    if origins.device.type == "cpu":
        return segment_visible_wide(scene.wide, origins, directions, dist)
    wide = wide_records(scene)
    origins, directions, dist = _rays("trace_segments", origins, directions, dist)
    if dist is None:
        raise ValueError("trace_segments: dist is required")
    kernels.check_inputs("trace_segments", floats=(origins, directions, dist, wide.nodes, wide.tris),
                         ints=(wide.overflow,))
    fn = kernels.load("trace", "fyp_segment_visible", _SEGMENT_ARGTYPES)
    B = origins.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=origins.device)
    P = kernels.ptr
    rc = fn(P(wide.nodes), P(wide.tris), P(wide.overflow), P(origins), P(directions), P(dist), B, P(out),
            stack_depth(wide), kernels.stream_ptr(origins.device))
    trace_segments.launches += 1
    kernels.check(rc, "trace_segments")
    return out != 0


trace_segments.launches = 0


def pick_tracer(scene):
    """A ``trace(o, d) -> tri`` closure over the scene: the CUDA kernel for
    CUDA tensors, the plain walk for CPU tensors (``trace_closest``)."""
    def trace(o, d):
        return trace_closest(scene, o, d)["tri"]
    return trace
