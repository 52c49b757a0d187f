"""The 4-wide BVH of the CUDA walk, collapsed from the threaded binary BVH.

The port's closest-hit kernels (``csrc/wide.cuh::trace_closest_wide``)
walk a tree whose inner nodes have up to four children, four lanes of a
warp to a ray: lane k tests child k's box, then the lanes sort the hit
children by entry distance.  This module builds that tree on the host, in
NumPy, from the scene's ``FlatBVH`` and ``Geometry``:

  * each wide node takes a binary inner node's two children and, while it
    has fewer than four, replaces the inner child of largest surface area
    by that child's two children (ties to the child that comes first).
    Every child box is therefore one of the binary tree's boxes, bit for
    bit: collapsing only drops intermediate boxes.  A binary tree that is
    one leaf becomes one wide node with one child;
  * a leaf child keeps the binary leaf's ``leaf_size`` = 4 slots, so lane
    k of the quad tests slot k;
  * triangles are stored per leaf slot, in the slot order of
    ``FlatBVH.prim_idx``: ``p0`` with the triangle id, ``e1 = p1 - p0`` and
    ``e2 = p2 - p0``.  The differences are float32 subtractions here, the
    same correctly rounded operation that Möller–Trumbore does on the card
    and in ``ops/intersect.py``, so the hit arithmetic keeps its bits.
    This replaces the chain ``prim_idx -> tri_v -> positions`` by one load.

``WideBVH.stack_need`` is the most entries the walk's stack can hold: along
any path from the root, a visited node pushes at most one entry fewer than
it has children.  The kernels give each walk a stack of that many entries
in shared memory, and the wrappers refuse a tree that needs more than
``MAX_STACK``.
"""

from __future__ import annotations

import numpy as np

from fypraytracer_tpu_torch.scene.types import FlatBVH, Geometry, WideBVH

WIDTH = 4
# the deepest stack the kernels can give every thread of a block of 128 (K2
# and K1's one-thread walk; csrc/wide.cuh), 8 bytes an entry, in the 227 KB
# of shared memory a block may hold on sm_90 (232,448 bytes)
MAX_STACK = 232448 // (8 * 128)
EMPTY = -1          # the ref of a missing child


def leaf_ref(slot_group: int) -> int:
    """The ref of the leaf whose slots are 4·g .. 4·g + 3."""
    return -slot_group - 2


def build_wide(bvh: FlatBVH, geometry: Geometry) -> WideBVH:
    """The wide BVH of a scene's host arrays (NumPy, or CPU tensors)."""
    lo, hi = np.asarray(bvh.lo, np.float32), np.asarray(bvh.hi, np.float32)
    first, miss = np.asarray(bvh.first), np.asarray(bvh.miss)
    prim_idx = np.asarray(bvh.prim_idx)
    if bvh.leaf_size != WIDTH:
        raise ValueError(f"the wide BVH needs leaves of {WIDTH} slots, got {bvh.leaf_size}")
    ext = np.maximum(hi.astype(np.float64) - lo, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    def kids_of(i: int) -> list[int]:
        return [i + 1, int(miss[i + 1])]

    def collapse(i: int) -> list[int]:
        if first[i] >= 0:                    # the root is a leaf
            return [i]
        kids = kids_of(i)
        while len(kids) < WIDTH:
            inner = [k for k in kids if first[k] < 0]
            if not inner:
                break
            pick = max(inner, key=lambda k: (area[k], -k))
            at = kids.index(pick)
            kids[at:at + 1] = kids_of(pick)
        return kids

    # wide nodes in preorder: a node's inner children get the next indices
    # as the walk reaches them depth first
    groups: list[list[int]] = []
    refs: list[list[int]] = []
    depth, stack_need = 1, 0
    todo = [(0, 0, 1, 0)]       # (binary node, slot of its wide node, depth, stack entries below)
    while todo:
        b, parent, d, below = todo.pop()
        w = len(groups)
        if groups:
            refs[parent[0]][parent[1]] = w
        kids = collapse(b)
        groups.append(kids)
        refs.append([EMPTY] * WIDTH)
        held = below + len(kids) - 1
        depth, stack_need = max(depth, d), max(stack_need, held)
        for k in reversed(range(len(kids))):
            c = kids[k]
            if first[c] >= 0:
                refs[w][k] = leaf_ref(int(first[c]) // WIDTH)
            else:
                todo.append((c, (w, k), d + 1, held))

    n = len(groups)
    nodes = np.zeros((n, 2 * WIDTH, 4), np.float32)
    ref_bits = np.full((n, WIDTH), EMPTY, np.int32)
    for w, kids in enumerate(groups):
        for k, c in enumerate(kids):
            nodes[w, k, :3], nodes[w, k, 3] = lo[c], hi[c, 0]
            nodes[w, WIDTH + k, :2] = hi[c, 1:]
        ref_bits[w] = refs[w]
    nodes[:, WIDTH:, 2] = ref_bits.view(np.float32)

    pos = np.asarray(geometry.positions, np.float32)
    tri_v = np.asarray(geometry.tri_v)
    live = prim_idx >= 0
    tv = tri_v[np.where(live, prim_idx, 0)]
    p0, p1, p2 = pos[tv[:, 0]], pos[tv[:, 1]], pos[tv[:, 2]]
    tris = np.zeros((prim_idx.shape[0], 3, 4), np.float32)
    tris[:, 0, :3] = np.where(live[:, None], p0, 0.0)
    tris[:, 1, :3] = np.where(live[:, None], p1 - p0, 0.0)
    tris[:, 2, :3] = np.where(live[:, None], p2 - p0, 0.0)
    tris[:, 0, 3] = np.where(live, prim_idx, -1).astype(np.int32).view(np.float32)
    return WideBVH(nodes=nodes, tris=tris, overflow=np.zeros(1, np.int32), depth=depth, stack_need=stack_need)


def unpack_nodes(nodes):
    """(lo (Nw, 4, 3), hi (Nw, 4, 3), ref (Nw, 4) int32) of the node
    records, as tensors or arrays of the records' kind."""
    lo = nodes[:, :WIDTH, :3]
    if isinstance(nodes, np.ndarray):
        hi = np.concatenate([nodes[:, :WIDTH, 3:], nodes[:, WIDTH:, :2]], axis=-1)
        ref = np.ascontiguousarray(nodes[:, WIDTH:, 2]).view(np.int32)
    else:
        import torch

        hi = torch.cat([nodes[:, :WIDTH, 3:], nodes[:, WIDTH:, :2]], dim=-1)
        ref = nodes[:, WIDTH:, 2].contiguous().view(torch.int32)
    return lo, hi, ref
