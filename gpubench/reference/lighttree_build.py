"""Light tree construction — SAOH (surface-area-orientation heuristic).

Host-side builder re-implementing the reference's recursive SAOH
(``LightTree.cpp:21-293``, after Conty Estevez & Kulla, "Importance
Sampling of Many Lights with Adaptive Tree Splitting"):

  * leaf per emissive triangle with energy = area · ‖emission‖ · π, cone
    axis = triangle normal, θ_o = 0, θ_e = π/2 (Mesh.cpp:192-203);
  * 16-bin split search on all 3 axes over leaf centroids; cost =
    (P_L + P_R)/P_parent with P = area · orientation-measure · energy
    (LightTree.cpp:318-340) and the thin-box regularizer kr
    (LightTree.cpp:196-214 — including its quirk of indexing box extent
    by the *running best* axis, which we fix by using the current axis);
  * median fallback on degenerate centroids (LightTree.cpp:228-252);
  * conservative cone union (ConeBounds.cuh:14-45).

Output is a single flat binary tree (scene/types.py::LightTreeArrays): the
two-level TLAS/BLAS of the reference (Scene.cpp:160-186) is merged by
building per-mesh subtrees and then SAOH-combining their roots — the
descent distribution is identical to chaining TLAS→BLAS since TLAS leaves
carry exactly the BLAS roots' aggregates.  ``leaf_of_tri`` + ``parent``
links give O(depth) PMF replay instead of the reference's linear scans
(LightTree.cu:156-191).

A frozen copy of the path tracer's published NumPy builder.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gpubench.reference.types import LightTreeArrays

NUM_BINS = 16
PI = 3.1415926535


def orientation_measure(theta_o: float, theta_e: float) -> float:
    """M_Ω from paper §4.3 (LightTree.cpp:318-329)."""
    theta_w = min(theta_o + theta_e, PI)
    a = 2.0 * PI * (1.0 - np.cos(theta_o))
    b = 0.5 * PI * (2.0 * theta_w * np.sin(theta_o) - np.cos(theta_o - 2.0 * theta_w)
                    - 2.0 * theta_o * np.sin(theta_o) + np.cos(theta_o))
    return float(a + b)


def cluster_prob(area: float, orient: float, energy: float) -> float:
    """P = MA · MΩ · E (LightTree.cpp:331-335)."""
    return area * orient * energy


def cone_union(a, b):
    """Conservative cone union (ConeBounds.cuh:14-45).

    a/b: (axis(3,), theta_o, theta_e).
    """
    if b[1] > a[1]:
        a, b = b, a
    ax_a, to_a, te_a = a
    ax_b, to_b, te_b = b
    d = float(np.clip(np.dot(ax_a, ax_b), -1.0, 1.0))
    theta_d = float(np.arccos(d))
    theta_e = max(te_a, te_b)
    if min(theta_d + to_b, PI) <= to_a:
        return (ax_a, to_a, theta_e)
    theta_o = (to_a + theta_d + to_b) * 0.5
    if theta_o >= PI:
        return (ax_a, PI, theta_e)
    theta_r = theta_o - to_a
    rot_axis = np.cross(ax_a, ax_b)
    n = np.linalg.norm(rot_axis)
    if n < 1e-12:
        return (ax_a, theta_o, theta_e)
    rot_axis = rot_axis / n
    # Rodrigues rotation of a's axis by theta_r about rot_axis
    c, s = np.cos(theta_r), np.sin(theta_r)
    axis = (ax_a * c + np.cross(rot_axis, ax_a) * s
            + rot_axis * np.dot(rot_axis, ax_a) * (1.0 - c))
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    return (axis.astype(np.float32), float(theta_o), float(theta_e))


def _surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))


@dataclasses.dataclass
class _Cluster:
    """Per-emitter work item (LightTree::Node as builder input)."""

    lo: np.ndarray
    hi: np.ndarray
    position: np.ndarray   # centroid
    axis: np.ndarray
    theta_o: float
    theta_e: float
    energy: float
    tri: int               # global triangle id at leaves; -1 internal
    left: int = -1
    right: int = -1


class _TreeAccum:
    def __init__(self):
        self.nodes: list[_Cluster] = []

    def add(self, c: _Cluster) -> int:
        self.nodes.append(c)
        return len(self.nodes) - 1


def _merge(acc: _TreeAccum, li: int, ri: int) -> int:
    l, r = acc.nodes[li], acc.nodes[ri]
    cone = cone_union((l.axis, l.theta_o, l.theta_e), (r.axis, r.theta_o, r.theta_e))
    node = _Cluster(lo=np.minimum(l.lo, r.lo), hi=np.maximum(l.hi, r.hi),
                    position=0.5 * (np.minimum(l.lo, r.lo) + np.maximum(l.hi, r.hi)),
                    axis=np.asarray(cone[0], np.float32), theta_o=cone[1],
                    theta_e=cone[2], energy=l.energy + r.energy, tri=-1,
                    left=li, right=ri)
    return acc.add(node)


def _build_recursive(acc: _TreeAccum, work: list[_Cluster]) -> int:
    if len(work) == 1:
        return acc.add(work[0])

    los = np.stack([w.lo for w in work])
    his = np.stack([w.hi for w in work])
    pos = np.stack([w.position for w in work])
    energies = np.array([w.energy for w in work])

    p_lo, p_hi = los.min(axis=0), his.max(axis=0)
    cone = (work[0].axis, work[0].theta_o, work[0].theta_e)
    for w in work[1:]:
        cone = cone_union(cone, (w.axis, w.theta_o, w.theta_e))
    p_prob = cluster_prob(_surface_area(p_lo, p_hi),
                          orientation_measure(cone[1], cone[2]),
                          float(energies.sum()))
    p_prob = max(p_prob, 1e-12)
    length_max = max(float(np.max(p_hi - p_lo)), 1e-12)

    best = None  # (cost, axis, mask)
    for axis in range(3):
        cmin, cmax = float(pos[:, axis].min()), float(pos[:, axis].max())
        if cmin == cmax:
            continue
        rel = (pos[:, axis] - cmin) / (cmax - cmin)
        bins = np.clip((rel * (NUM_BINS - 1)).astype(np.int32), 0, NUM_BINS - 1)
        for split in range(NUM_BINS - 1):
            mask = bins <= split
            nl, nr = int(mask.sum()), int((~mask).sum())
            if nl == 0 or nr == 0:
                continue
            cost_parts = []
            lens = []
            for sel in (mask, ~mask):
                s_lo, s_hi = los[sel].min(axis=0), his[sel].max(axis=0)
                sc = None
                for i in np.nonzero(sel)[0]:
                    w = work[i]
                    sc = (w.axis, w.theta_o, w.theta_e) if sc is None else cone_union(sc, (w.axis, w.theta_o, w.theta_e))
                p = cluster_prob(_surface_area(s_lo, s_hi),
                                 orientation_measure(sc[1], sc[2]),
                                 float(energies[sel].sum()))
                cost_parts.append(p)
                lens.append(max(float(s_hi[axis] - s_lo[axis]), 1e-12))
            cost = (cost_parts[0] + cost_parts[1]) / p_prob
            kr = max(max(length_max / lens[0], length_max / lens[1]), 1.0)
            cost *= kr
            if best is None or cost < best[0]:
                best = (cost, axis, mask.copy())

    if best is None:
        order = np.argsort(pos[:, 0], kind="stable")
        half = len(work) // 2
        mask = np.zeros(len(work), bool)
        mask[order[:half]] = True
    else:
        mask = best[2]

    left_work = [w for w, m in zip(work, mask) if m]
    right_work = [w for w, m in zip(work, mask) if not m]
    li = _build_recursive(acc, left_work)
    ri = _build_recursive(acc, right_work)
    return _merge(acc, li, ri)


def make_leaf_clusters(positions, tri_v, tri_ids, emission_per_tri) -> list[_Cluster]:
    """Leaf per emissive triangle (Mesh.cpp:173-207): energy =
    area · ‖emission‖ · π; cone = (face normal, θ_o=0, θ_e=π/2)."""
    out = []
    for t in tri_ids:
        v = tri_v[t]
        p0, p1, p2 = positions[v[0]], positions[v[1]], positions[v[2]]
        n = np.cross(p1 - p0, p2 - p0)
        area = 0.5 * float(np.linalg.norm(n))
        n = n / max(np.linalg.norm(n), 1e-20)
        e = float(np.linalg.norm(emission_per_tri[t]))
        lo = np.minimum(np.minimum(p0, p1), p2)
        hi = np.maximum(np.maximum(p0, p1), p2)
        out.append(_Cluster(lo=lo, hi=hi, position=0.5 * (lo + hi),
                            axis=n.astype(np.float32), theta_o=0.0,
                            theta_e=PI / 2.0, energy=area * e * PI, tri=int(t)))
    return out


def build_scene_light_tree(positions, tri_v, tri_mat, emission_per_mat,
                           mesh_tri_ranges) -> LightTreeArrays:
    """Two-level build (per-mesh BLAS + combined TLAS, Scene.cpp:160-186),
    merged into one flat tree.

    ``emission_per_mat``: (M, 3) emission color·power per material.
    """
    emission_per_tri = emission_per_mat[tri_mat]
    acc = _TreeAccum()
    mesh_roots = []
    for (s, e) in mesh_tri_ranges:
        ids = [t for t in range(s, e)
               if np.abs(emission_per_tri[t]).sum() > 0.0]
        if not ids:
            continue
        leaves = make_leaf_clusters(positions, tri_v, np.asarray(ids), emission_per_tri)
        mesh_roots.append(_build_recursive(acc, leaves))

    if not mesh_roots:
        raise ValueError("the scene has no emissive triangle: NEE needs at least one")

    # TLAS over mesh roots (Scene.cpp:160-186): combine BLAS roots into one tree
    root = _build_recursive_over_indices(acc, mesh_roots)
    return _flatten(acc, root, len(tri_v))


def _build_recursive_over_indices(acc: _TreeAccum, indices: list[int]) -> int:
    """SAOH build whose leaves are existing accumulated subtrees."""
    if len(indices) == 1:
        return indices[0]
    work = [acc.nodes[i] for i in indices]
    pos = np.stack([w.position for w in work])
    # simple greedy: split on largest centroid axis by median (few meshes)
    axis = int(np.argmax(pos.max(axis=0) - pos.min(axis=0)))
    order = np.argsort(pos[:, axis], kind="stable")
    half = max(len(indices) // 2, 1)
    li = _build_recursive_over_indices(acc, [indices[o] for o in order[:half]])
    ri = _build_recursive_over_indices(acc, [indices[o] for o in order[half:]])
    return _merge(acc, li, ri)


def _flatten(acc: _TreeAccum, root: int, num_tris: int) -> LightTreeArrays:
    """Re-emit reachable nodes in preorder with parent links; root = 0."""
    order: list[int] = []
    remap: dict[int, int] = {}

    def visit(i: int):
        remap[i] = len(order)
        order.append(i)
        n = acc.nodes[i]
        if n.left >= 0:
            visit(n.left)
            visit(n.right)

    visit(root)
    n_out = len(order)
    energy = np.zeros(n_out, np.float32)
    axis = np.zeros((n_out, 3), np.float32)
    theta_o = np.zeros(n_out, np.float32)
    theta_e = np.zeros(n_out, np.float32)
    box_lo = np.zeros((n_out, 3), np.float32)
    box_hi = np.zeros((n_out, 3), np.float32)
    left = np.full(n_out, -1, np.int32)
    right = np.full(n_out, -1, np.int32)
    tri = np.full(n_out, -1, np.int32)
    parent = np.full(n_out, -1, np.int32)
    leaf_of_tri = np.full(num_tris, -1, np.int32)

    for new_i, old_i in enumerate(order):
        n = acc.nodes[old_i]
        energy[new_i] = n.energy
        axis[new_i] = n.axis
        theta_o[new_i] = n.theta_o
        theta_e[new_i] = n.theta_e
        box_lo[new_i] = n.lo
        box_hi[new_i] = n.hi
        if n.left >= 0:
            left[new_i] = remap[n.left]
            right[new_i] = remap[n.right]
            parent[remap[n.left]] = new_i
            parent[remap[n.right]] = new_i
        else:
            tri[new_i] = n.tri
            if n.tri >= 0:
                leaf_of_tri[n.tri] = new_i

    # static max depth for fixed-length device descent loops
    depth = np.zeros(n_out, np.int32)
    for i in range(1, n_out):
        depth[i] = depth[parent[i]] + 1
    max_depth = int(depth.max()) + 1

    return LightTreeArrays(energy=energy, axis=axis, theta_o=theta_o,
                           theta_e=theta_e, box_lo=box_lo, box_hi=box_hi,
                           left=left, right=right, tri=tri, parent=parent,
                           leaf_of_tri=leaf_of_tri, max_depth=max_depth)
