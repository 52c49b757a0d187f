"""Count the operations and bytes a cell's kernel launch needs, once, and
freeze them into the cell's file.

    python3 gpubench/count/count.py [--write] [cell ...]

For each cell (by default every cell of ``BENCHMARK.json`` and the cells
held out of it, ``gpubench/control.py``): the plain
reference's scene, this folder's frozen binary SAH tree over it
(``gpubench/reference/sah.py``), and ``SAMPLE_PIXELS`` pixels of frames 1
and 2 drawn with a fixed seed (a ``Sample``).  The cell's entry
(``gpubench/entries/<entry>.py``) traces its own paths on them through
the plain reference, every live ray walked by the reference's
``bvh.closest_hit``, which counts its box and triangle tests, and says
what one launch of each of its kernels does (``count(cell, sample)``).
Then, a launch:

  * operations: the sample's tests scaled to the whole launch's pixels and
    frames, ``OPS_BOX`` a box test and ``OPS_TRI`` a triangle test;
  * bytes: the scene read once (vertices, normals, triangles, materials,
    the SAH tree, the light tree where the entry samples lights) and what
    the launch reads and writes once besides (the entry says).

Shading is not counted, so a share of this roofline bounds the walks'
work only.  With ``--write`` the numbers go into ``frozen`` of
``gpubench/workloads/<cell>.json``, one entry a kernel; without, they are
printed.  The CPU only; stress takes about a minute.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpubench.reference import bvh, scenes  # noqa: E402

SAMPLE_PIXELS = 2048
SAMPLE_FRAMES = (1, 2)
SAMPLE_SEED = 0
# float32 arithmetic of one test, comparisons and min/max left out: the
# slab test 6 subtractions and 6 products; Möller–Trumbore 6 edge
# subtractions, 2 cross products (9 each), 4 dot products (5 each), the
# origin offset (3), 3 products by 1/det, the reciprocal and u + v (1 each)
OPS_BOX = 12
OPS_TRI = 52


def rays_per_frame(width: int, height: int, samples: int, bounces: int,
                   shadow_rays_per_bounce: int = 0, visibility_rays: int = 0) -> int:
    """W·H·samples·(1 + bounces + shadow rays + visibility rays): primary,
    bounce and shadow rays a path, as the reference benchmark counts them."""
    return width * height * samples * (1 + bounces + shadow_rays_per_bounce * bounces + visibility_rays)


def scene_bytes(scene, tree: bvh.Tree, light_tree: bool) -> int:
    g, m, lt = scene.geometry, scene.materials, scene.light_tree
    n = (g.positions.size + g.normals.size) * 4 + g.tri_v.size * 4 + g.tri_mat.size * 4
    n += (m.albedo.size + m.roughness.size + m.metallic.size + m.emission_color.size + m.emission_power.size) * 4
    n += (tree.lo.numel() + tree.hi.numel() + tree.miss.numel() + tree.first.numel() + tree.prim.numel()) * 4
    if light_tree:
        n += sum(np.asarray(getattr(lt, f)).size * 4 for f in ("energy", "axis", "theta_o", "theta_e", "box_lo",
                                                                 "box_hi", "left", "right", "tri", "parent",
                                                                 "leaf_of_tri"))
    return int(n)


class Sample:
    """The pixels and frames a cell's walks are counted on, with the plain
    reference's scene and the frozen SAH tree; ``trace`` counts as it walks."""

    def __init__(self, cell):
        tr = cell.traffic
        self.width, self.height = tr["width"], tr["height"]
        self.host, self.camera = scenes.build(cell.config, self.width, self.height)
        self.scene = self.host.to("cpu")
        self.tree = bvh.tree(self.scene.geometry)
        self.counts = {"rays": 0, "boxes": 0, "tris": 0}
        self.ids = torch.randperm(self.width * self.height,
                                  generator=torch.Generator().manual_seed(SAMPLE_SEED))[:SAMPLE_PIXELS]
        self.frames = SAMPLE_FRAMES

    def trace(self, o, d, live):
        g = self.scene.geometry
        return bvh.closest_hit(self.tree, g.positions, g.tri_v, o, d, live, self.counts)

    def frozen(self, frames: int, rays_formula: int, written: int, light_tree: bool) -> dict:
        """One launch of ``frames`` frames of the whole image, from the walks
        traced so far: ``written`` bytes besides the scene, which holds its
        light tree where ``light_tree``."""
        c = self.counts
        scale = self.width * self.height * frames / (SAMPLE_PIXELS * len(self.frames))
        return {
            "ops_per_launch": (c["boxes"] * OPS_BOX + c["tris"] * OPS_TRI) * scale,
            "bytes_per_launch": scene_bytes(self.host, self.tree, light_tree) + written,
            "rays_per_launch": c["rays"] * scale, "rays_per_launch_formula": rays_formula,
            "box_tests_per_ray": c["boxes"] / c["rays"], "tri_tests_per_ray": c["tris"] / c["rays"],
            "sample": {"pixels": SAMPLE_PIXELS, "frames": list(self.frames), "seed": SAMPLE_SEED, **c},
            "sah_nodes": int(self.tree.lo.shape[0]), "ops_box": OPS_BOX, "ops_tri": OPS_TRI,
        }


def count_cell(cell) -> dict:
    """``{kernel: frozen counts}`` of the cell, by its entry's ``count``."""
    from gpubench.run import load_module

    entry = load_module("entries", cell.traffic["entry"])
    with torch.no_grad():
        return entry.count(cell, Sample(cell))


def main(argv=None) -> int:
    from gpubench.control import bench_with_held_out
    from gpubench.run import Cell

    args = list(sys.argv[1:] if argv is None else argv)
    write = "--write" in args
    bench = bench_with_held_out()
    names = [a for a in args if a != "--write"] or [w["name"] for w in bench["workloads"]]
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    for name in names:
        frozen = count_cell(Cell.find(name, bench))
        print(name, json.dumps(frozen))
        if write:
            path = os.path.join(ROOT, "gpubench", "workloads", f"{name}.json")
            with open(path) as f:
                data = json.load(f)
            data["frozen"] = frozen
            with open(path, "w") as f:
                json.dump(data, f, indent=1)
                f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
