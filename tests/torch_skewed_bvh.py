"""A scene whose BVH is a chain, for the wide walk's deep-stack tests.

``skewed_scene(scene, run)`` keeps a port scene's triangles, materials and
light tree but replaces its binary BVH by a chain: the triangles sorted by
centroid x and cut into runs of ``run``, each run a binned-SAH subtree,
each chain node the pair (run k, the chain of the runs after it).  Its
wide BVH is built from that chain, so the wide walk's stack must hold
about one entry for every run: on the Cornell box's 1,164 triangles 79
entries for runs of 16, 149 for 8, 290 for 4, against 21 for its own
BVH and 37 for the stress scene's.  Imports no JAX (``tests/test_torch_cuda.py`` runs it
on the card).
"""

import dataclasses

import numpy as np

from fypraytracer_tpu_torch.accel.bvh import _Node, build_tree, flatten
from fypraytracer_tpu_torch.accel.wide import build_wide


def skewed_scene(scene, run: int):
    """``scene`` (host arrays, as ``SceneBuilder.compile`` returns it) with
    a chain BVH over runs of ``run`` triangles, and its wide BVH."""
    g = scene.geometry
    tri = np.asarray(g.positions)[np.asarray(g.tri_v)]           # (T, 3, 3)
    lo, hi = tri.min(axis=1), tri.max(axis=1)
    order = np.argsort(tri.mean(axis=1)[:, 0], kind="stable")
    runs = [order[i:i + run] for i in range(0, order.shape[0], run)]
    node = build_tree(lo, hi, runs[-1])
    for ids in reversed(runs[:-1]):
        left = build_tree(lo, hi, ids)
        node = _Node(np.minimum(left.lo, node.lo), np.maximum(left.hi, node.hi), left=left, right=node)
    bvh = flatten(node)
    return dataclasses.replace(scene, bvh=bvh, wide=build_wide(bvh, g))
