"""Light-tree importance descent and PMF replay on tensors.

A frozen copy of the path tracer's published light-tree sampling:
  * ``cluster_importance`` — LightTree.cuh:91-117 in (cos, sin) space;
  * ``pick_light`` — PickLight (LightTree.cu:4-154): binary descent with
    the random number remapped into the chosen branch, p(left) clamped to
    [1e-6, 1-1e-6] and rand to 0.9999999;
  * ``emitter_pmf`` — ComputeDirectEmitterPMF (LightTree.cu:193-276),
    replayed bottom-up through parent links.

cos/sin of the cone angles are read from ``LightTreeArrays.cone_trig``
(float32, made once on the host), as the published kernels read them.
"""

from __future__ import annotations

import torch

from gpubench.reference.mathutils import dot3, normalize
from gpubench.reference.types import LightTreeArrays

_P_CLAMP = 1e-6           # LightTree.cu:58
_RAND_CLAMP = 0.9999999   # LightTree.cu:23


def _cos_theta_u(box_lo, box_hi, point):
    """cos of the half-angle of the cone from ``point`` enveloping the
    AABB (ConeBounds.cuh:47-87): min over corners of cos(axis, corner)."""
    axis = normalize(0.5 * (box_lo + box_hi) - point)
    min_cos = None
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                corner = torch.stack([
                    (box_lo if cx == 0 else box_hi)[..., 0],
                    (box_lo if cy == 0 else box_hi)[..., 1],
                    (box_lo if cz == 0 else box_hi)[..., 2],
                ], dim=-1)
                d = normalize(corner - point)
                c = torch.clamp(dot3(axis, d, keepdims=False), -1.0, 1.0)
                min_cos = c if min_cos is None else torch.minimum(min_cos, c)
    return min_cos


def cluster_importance(lt: LightTreeArrays, node_idx, point):
    """ComputeClusterImportance (LightTree.cuh:91-117), transcendental-free
    (see fypraytracer_tpu/ops/lighttree.py:52-101 for the angle algebra).

    node_idx: (...,) valid node ids; point: (..., 3).
    """
    node_idx = node_idx.long()
    box_lo = lt.box_lo[node_idx]
    box_hi = lt.box_hi[node_idx]
    cos_u = _cos_theta_u(box_lo, box_hi, point)
    sin_u = torch.sqrt(torch.clamp_min(1.0 - cos_u * cos_u, 0.0))

    d = point - 0.5 * (box_lo + box_hi)
    dist2 = torch.clamp_min(dot3(d, d, keepdims=False), 1e-12)
    d = normalize(d)

    cos_t = torch.clamp(dot3(lt.axis[node_idx], d, keepdims=False), -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))

    cos_o, sin_o, cos_e, sin_e = (a[node_idx] for a in lt.cone_trig)

    cos_a = cos_o * cos_u - sin_o * sin_u          # cos(θ_o + θ_u)
    sin_a = sin_o * cos_u + cos_o * sin_u          # sin(θ_o + θ_u)
    cos_diff = cos_t * cos_a + sin_t * torch.abs(sin_a)

    a_gt_pi = sin_a < 0.0
    clamp_low = a_gt_pi | (cos_t >= cos_a)
    b_ge_pi = a_gt_pi | (cos_e <= -cos_a)
    cos_b = cos_a * cos_e - sin_a * sin_e          # cos(a + θ_e)
    clamp_high = (~b_ge_pi) & (cos_t <= cos_b)

    val = torch.where(clamp_low, 1.0, torch.where(clamp_high, cos_e, cos_diff))
    return lt.energy[node_idx] * val / dist2


def _child_probs(lt: LightTreeArrays, parent_idx, point):
    """p(left | parent) with the reference's guards (LightTree.cu:41-58)."""
    parent_idx = parent_idx.long()
    i_l = cluster_importance(lt, torch.clamp_min(lt.left[parent_idx], 0), point)
    i_r = cluster_importance(lt, torch.clamp_min(lt.right[parent_idx], 0), point)
    s = i_l + i_r
    p_left = torch.where(s > 0.0, i_l / torch.where(s > 0.0, s, 1.0), 0.5)
    return torch.clamp(p_left, _P_CLAMP, 1.0 - _P_CLAMP)


def pick_light(lt: LightTreeArrays, point, rand):
    """Importance descent (PickLight, LightTree.cu:4-154).

    Args: point (B, 3); rand (B,) uniform in [0, 1].
    Returns (tri, pmf): global triangle ids (B,) i32 (-1 if the tree is
    empty) and the selection pmf (B,).
    """
    idx = torch.zeros(point.shape[:-1], dtype=torch.int64, device=point.device)
    pmf = torch.ones(point.shape[:-1], dtype=point.dtype, device=point.device)
    rand = torch.clamp(rand, 0.0, _RAND_CLAMP)

    for _ in range(lt.max_depth):
        at_leaf = lt.left[idx] < 0
        p_left = _child_probs(lt, idx, point)
        go_left = rand < p_left
        new_pmf = pmf * torch.where(go_left, p_left, 1.0 - p_left)
        new_rand = torch.where(go_left, rand / p_left, (rand - p_left) / (1.0 - p_left))
        new_idx = torch.where(go_left, lt.left[idx], lt.right[idx]).long()
        idx = torch.where(at_leaf, idx, new_idx)
        pmf = torch.where(at_leaf, pmf, new_pmf)
        rand = torch.where(at_leaf, rand, torch.clamp(new_rand, 0.0, _RAND_CLAMP))

    return lt.tri[idx], pmf


def emitter_pmf(lt: LightTreeArrays, tri_ids, point):
    """Probability the descent picks ``tri_ids`` from ``point``, replayed
    bottom-up (LightTree.cu:193-276); 0 for triangles not in the tree."""
    leaf = lt.leaf_of_tri[torch.clamp_min(tri_ids, 0).long()]
    in_tree = (tri_ids >= 0) & (leaf >= 0)
    idx = torch.clamp_min(leaf, 0).long()
    pmf = torch.ones(point.shape[:-1], dtype=point.dtype, device=point.device)

    for _ in range(lt.max_depth):
        par = lt.parent[idx]
        valid = par >= 0
        par_c = torch.clamp_min(par, 0).long()
        p_left = _child_probs(lt, par_c, point)
        went_left = lt.left[par_c] == idx
        step = torch.where(went_left, p_left, 1.0 - p_left)
        pmf = pmf * torch.where(valid, step, 1.0)
        idx = torch.where(valid, par_c, idx)

    return torch.where(in_tree, pmf, 0.0)
