"""The benchmark's binary SAH BVH builder, a frozen copy.

The path tracer's published binned-SAH builder: 16 bins over all three
axes on centroids, a median split where SAH finds no valid partition,
leaves of at most four triangles, flattened in preorder with miss links
(``FlatBVH``).  The reference walks it (``bvh.closest_hit``), and the
counting script counts the tests of that walk: the yardstick of the
kernels' roofline shares, which does not change when the renderer's own
trees do.
"""

from __future__ import annotations

import dataclasses

import numpy as np


NUM_BINS = 16  # binned SAH bin count


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """Threaded binary BVH in preorder: a hit inner node falls through to
    ``i + 1``, anything else jumps to ``miss[i]`` (``N`` ends the walk); a
    leaf (``first >= 0``) owns ``leaf_size`` slots of ``prim_idx``, -1 padded."""

    lo: np.ndarray
    hi: np.ndarray
    miss: np.ndarray
    first: np.ndarray
    count: np.ndarray
    prim_idx: np.ndarray
    leaf_size: int = 4


@dataclasses.dataclass
class _Node:
    lo: np.ndarray
    hi: np.ndarray
    left: "_Node | None" = None
    right: "_Node | None" = None
    prims: np.ndarray | None = None   # leaf primitive ids
    sub: "_Node | None" = None        # spliced subtree (TLAS leaf -> BLAS root)


def _aabb_of(lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return lo.min(axis=0), hi.max(axis=0)


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> float:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def build_tree(prim_lo: np.ndarray, prim_hi: np.ndarray, prim_ids: np.ndarray, leaf_size: int = 4) -> _Node:
    """Recursive binned-SAH build over primitive AABBs.

    Semantics of BVH.cpp:146-309: best of 16-bin SAH across x/y/z on
    centroids; median split when SAH finds no valid partition; leaf when
    ``count <= leaf_size``.
    """
    centroids = 0.5 * (prim_lo + prim_hi)

    def rec(ids: np.ndarray) -> _Node:
        lo, hi = _aabb_of(prim_lo[ids], prim_hi[ids])
        n = len(ids)
        if n <= leaf_size:
            return _Node(lo, hi, prims=ids)

        c = centroids[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        ext = cmax - cmin

        best = None  # (cost, axis, left_mask)
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            rel = (c[:, axis] - cmin[axis]) / ext[axis]
            bins = np.minimum((rel * NUM_BINS).astype(np.int32), NUM_BINS - 1)
            # bin AABBs + counts
            counts = np.bincount(bins, minlength=NUM_BINS)
            bin_lo = np.full((NUM_BINS, 3), np.inf, np.float32)
            bin_hi = np.full((NUM_BINS, 3), -np.inf, np.float32)
            np.minimum.at(bin_lo, bins, prim_lo[ids])
            np.maximum.at(bin_hi, bins, prim_hi[ids])
            # prefix (left) / suffix (right) sweeps
            lcount = np.cumsum(counts)[:-1]
            rcount = n - lcount
            llo = np.minimum.accumulate(bin_lo, axis=0)[:-1]
            lhi = np.maximum.accumulate(bin_hi, axis=0)[:-1]
            rlo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1][1:]
            rhi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1][1:]

            dl = np.maximum(lhi - llo, 0.0)
            dr = np.maximum(rhi - rlo, 0.0)
            sal = 2.0 * (dl[:, 0] * dl[:, 1] + dl[:, 1] * dl[:, 2] + dl[:, 2] * dl[:, 0])
            sar = 2.0 * (dr[:, 0] * dr[:, 1] + dr[:, 1] * dr[:, 2] + dr[:, 2] * dr[:, 0])
            cost = np.where((lcount > 0) & (rcount > 0), sal * lcount + sar * rcount, np.inf)
            k = int(np.argmin(cost))
            if np.isfinite(cost[k]):
                if best is None or cost[k] < best[0]:
                    best = (cost[k], axis, bins <= k)

        if best is None:
            # median fallback (BVH.cpp:110-144): split sorted-by-centroid halves
            axis = int(np.argmax(ext))
            order = np.argsort(c[:, axis], kind="stable")
            half = n // 2
            left_ids, right_ids = ids[order[:half]], ids[order[half:]]
        else:
            mask = best[2]
            left_ids, right_ids = ids[mask], ids[~mask]

        node = _Node(lo, hi)
        node.left = rec(left_ids)
        node.right = rec(right_ids)
        return node

    return rec(prim_ids.astype(np.int64))


def _resolve(node: _Node) -> _Node:
    """Follow splice links (TLAS leaf → BLAS root)."""
    while node.sub is not None:
        node = node.sub
    return node


def _subtree_size(node: _Node) -> int:
    node = _resolve(node)
    if node.prims is not None:
        return 1
    return 1 + _subtree_size(node.left) + _subtree_size(node.right)


def flatten(root: _Node, leaf_size: int = 4) -> FlatBVH:
    """Emit preorder threaded arrays; splices ``sub`` links (TLAS→BLAS).

    Single pass: a node's miss link is passed down — the left child misses
    to the right child's (precomputable) preorder index, the right child
    inherits the parent's miss link.
    """
    lo, hi, miss, first, count = [], [], [], [], []
    prim_idx: list[int] = []

    def emit(node: _Node, miss_to: int) -> None:
        node = _resolve(node)
        idx = len(lo)
        lo.append(node.lo)
        hi.append(node.hi)
        miss.append(miss_to)
        if node.prims is not None:
            first.append(len(prim_idx))
            count.append(len(node.prims))
            prim_idx.extend(int(p) for p in node.prims)
            prim_idx.extend([-1] * (leaf_size - len(node.prims)))
        else:
            first.append(-1)
            count.append(0)
            right_start = idx + 1 + _subtree_size(node.left)
            emit(node.left, right_start)
            emit(node.right, miss_to)

    n_total = _subtree_size(root)
    emit(root, n_total)

    return FlatBVH(
        lo=np.asarray(lo, np.float32),
        hi=np.asarray(hi, np.float32),
        miss=np.asarray(miss, np.int32),
        first=np.asarray(first, np.int32),
        count=np.asarray(count, np.int32),
        prim_idx=np.asarray(prim_idx, np.int32),
        leaf_size=leaf_size,
    )


def build_blas(tri_lo: np.ndarray, tri_hi: np.ndarray, tri_ids: np.ndarray, leaf_size: int = 4) -> _Node:
    """Per-mesh BLAS over its triangles (Mesh.cpp:148-171 equivalent)."""
    return build_tree(tri_lo, tri_hi, tri_ids, leaf_size)


def build_scene_bvh(
    tri_lo: np.ndarray,
    tri_hi: np.ndarray,
    mesh_tri_ranges: list[tuple[int, int]],
    leaf_size: int = 4,
) -> FlatBVH:
    """Two-level build: BLAS per mesh + TLAS over mesh AABBs, flattened.

    ``mesh_tri_ranges``: [start, end) triangle ranges per mesh
    (the reference's Mesh vertex/index offsets, Mesh.h:17-37).
    """
    blas_roots = []
    mesh_lo, mesh_hi = [], []
    for (s, e) in mesh_tri_ranges:
        ids = np.arange(s, e, dtype=np.int64)
        root = build_blas(tri_lo, tri_hi, ids, leaf_size)
        blas_roots.append(root)
        mesh_lo.append(root.lo)
        mesh_hi.append(root.hi)

    if len(blas_roots) == 1:
        return flatten(blas_roots[0], leaf_size)

    mesh_lo = np.asarray(mesh_lo, np.float32)
    mesh_hi = np.asarray(mesh_hi, np.float32)
    # TLAS with leaf_size=1 so every leaf is exactly one mesh (Scene.cpp:111-126)
    tlas_root = build_tree(mesh_lo, mesh_hi, np.arange(len(blas_roots)), leaf_size=1)

    # splice: each TLAS leaf points at its mesh's BLAS root
    def splice(node: _Node) -> None:
        if node.prims is not None:
            assert len(node.prims) == 1
            node.sub = blas_roots[int(node.prims[0])]
            node.prims = None
        else:
            splice(node.left)
            splice(node.right)

    splice(tlas_root)
    return flatten(tlas_root, leaf_size)

