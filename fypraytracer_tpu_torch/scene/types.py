"""Scene data model — dense SoA arrays as plain frozen dataclasses.

Field for field the same as ``fypraytracer_tpu/scene/types.py`` (the
reference's flat global arrays with index-based triangles, Scene.h:23-56),
without the JAX pytree registration.  Leaves are NumPy arrays while the
host builders run, and torch tensors after ``Scene.to(device)``.  Integer
fields stay int32 on the device: the CUDA kernels read them as ``int``.

``scene_from_arrays`` reads any object with the JAX ``Scene``'s attribute
tree (every leaf through ``np.asarray``), so the tests can hand the JAX
package's compiled scene to the port and both trace the same BVH and
light tree.  ``materials_from_arrays`` does the same for a material table
(the parameters of a training step), ``with_materials`` puts one into a
scene.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from fypraytracer_tpu_torch.utils import profiling

Array = Any


def _leaf_to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def _to(obj, device, meta=()):
    """Copy of a leaf dataclass with every array field on ``device``."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kw[f.name] = v if (f.name in meta or v is None) else _leaf_to(v, device)
    return type(obj)(**kw)


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Material SoA (Material.cuh:7-21); ``albedo_map`` -1 = untextured."""

    albedo: Array          # (M, 3) f32
    roughness: Array       # (M,)   f32
    metallic: Array        # (M,)   f32
    emission_color: Array  # (M, 3) f32
    emission_power: Array  # (M,)   f32
    albedo_map: Array      # (M,)   i32, -1 = none

    def emission(self):
        return self.emission_color * self.emission_power[..., None]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """World-space triangle soup (Scene.h:27-37 equivalents)."""

    positions: Array   # (V, 3) f32
    normals: Array     # (V, 3) f32
    uvs: Array         # (V, 2) f32
    tri_v: Array       # (T, 3) i32
    tri_mat: Array     # (T,)   i32


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """Stackless threaded BVH in preorder (fypraytracer_tpu/scene/types.py:71-96).

    An inner node that is hit falls through to ``i+1``; otherwise the walk
    jumps to ``miss[i]`` (``miss == N`` ends it).  A leaf (``first >= 0``)
    owns ``leaf_size`` slots of ``prim_idx`` padded with -1.
    """

    lo: Array        # (N, 3) f32
    hi: Array        # (N, 3) f32
    miss: Array      # (N,)   i32
    first: Array     # (N,)   i32
    count: Array     # (N,)   i32
    prim_idx: Array  # (P,)   i32
    leaf_size: int = 4


@dataclasses.dataclass(frozen=True)
class WideBVH:
    """The 4-wide BVH the CUDA walk reads (``accel/wide.py`` builds it from
    a ``FlatBVH``), as 16-byte records.

    ``nodes`` (Nw, 8, 4) f32: record k holds child k's (lo.x, lo.y, lo.z,
    hi.x), record 4 + k its (hi.y, hi.z, ref, 0) with ``ref`` an int32 in
    float bits: >= 0 an inner node, -1 no child, <= -2 the leaf of slots
    4·(-ref - 2) .. +3.  Node 0 is the root.  ``tris`` (S, 3, 4) f32, one
    row per leaf slot of the ``FlatBVH``: (p0, id), (p1 - p0, 0),
    (p2 - p0, 0), the id in int32 bits, -1 on a padding slot.
    ``overflow`` (1,) i32: set to 1 by a CUDA walk whose stack overflowed.
    ``depth``: levels of nodes; ``stack_need``: the most entries a walk's
    stack can hold at once.
    """

    nodes: Array
    tris: Array
    overflow: Array
    depth: int = 1
    stack_need: int = 0


@dataclasses.dataclass(frozen=True)
class LightTreeArrays:
    """Flat light tree in preorder with child and parent links
    (LightTree.cuh:28-49 node fields, SoA)."""

    energy: Array      # (N,)   f32
    axis: Array        # (N, 3) f32
    theta_o: Array     # (N,)   f32
    theta_e: Array     # (N,)   f32
    box_lo: Array      # (N, 3) f32
    box_hi: Array      # (N, 3) f32
    left: Array        # (N,)   i32
    right: Array       # (N,)   i32
    tri: Array         # (N,)   i32
    parent: Array      # (N,)   i32
    leaf_of_tri: Array  # (T,)  i32
    max_depth: int = 1

    @functools.cached_property
    def cone_trig(self):
        """(cos θ_o, sin θ_o, cos θ_e, sin θ_e) per node, float32.

        Computed once on the host in NumPy float32 and placed where the
        tree lies; the importance code and the CUDA kernel both read these
        instead of evaluating cos/sin per visit.
        """
        def host(x):
            return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float32)

        to, te = host(self.theta_o), host(self.theta_e)
        dev = self.theta_o.device if isinstance(self.theta_o, torch.Tensor) else "cpu"
        return tuple(torch.as_tensor(f(a), device=dev)
                     for f, a in ((np.cos, to), (np.sin, to), (np.cos, te), (np.sin, te)))


@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    """All textures packed into one array for single-source gathers
    (``scene/build.py::pack_atlas``; an untextured scene carries an empty
    8×8 page).

    ``pages``: (K, H, W, 3) f32 RGB in [0, 1], mip 0 at full detail;
    ``size``: (K, 2) i32 original (w, h); ``bounce_pages``: (K, hb, wb, 3)
    f32, a box-filtered minified level.  Sampling policy
    (``ops/texture.py``): primary fetches read ``pages``, fetches at hits
    after a scatter read ``bounce_pages``."""

    pages: Array
    size: Array
    bounce_pages: Array = None


@dataclasses.dataclass(frozen=True)
class KernelTex:
    """The megakernels' texture levels as ``csrc/shading.cuh::Tex`` reads
    them (``ops/texture.py::make_kernel_tex`` builds them from the atlas):
    mip 0 box-filtered to at most ``KERNEL_TEX_PAGE`` a side and the bounce
    level, (K, h, w) float4 texels (RGB and a zero)."""

    prim: Array     # (K, hp, wp, 4) f32
    bounce: Array   # (K, hb, wb, 4) f32


@dataclasses.dataclass(frozen=True)
class Scene:
    """The complete scene."""

    geometry: Geometry
    materials: MaterialTable
    bvh: FlatBVH
    light_tree: LightTreeArrays
    emissive_tris: Array  # (E,) i32
    textures: TextureAtlas
    wide: WideBVH | None = None   # the records of the CUDA walk (accel/wide.py)
    # the kernels' texture levels, None when no material maps an albedo
    # (ops/texture.py::make_kernel_tex); built with the scene, as ``wide`` is
    tex: KernelTex | None = None

    @property
    def num_triangles(self) -> int:
        return self.geometry.tri_v.shape[0]

    @property
    def num_emissive(self) -> int:
        return self.emissive_tris.shape[0]

    @profiling.setup_spanned("scene.upload")
    def to(self, device) -> "Scene":
        """Every leaf as a torch tensor on ``device``."""
        return Scene(
            geometry=_to(self.geometry, device),
            materials=_to(self.materials, device),
            bvh=_to(self.bvh, device, meta=("leaf_size",)),
            light_tree=_to(self.light_tree, device, meta=("max_depth",)),
            emissive_tris=_leaf_to(self.emissive_tris, device),
            textures=_to(self.textures, device),
            wide=None if self.wide is None else _to(self.wide, device, meta=("depth", "stack_need")),
            tex=None if self.tex is None else _to(self.tex, device))


def scene_from_arrays(obj, device="cpu") -> Scene:
    """The port's ``Scene`` from any object with the JAX ``Scene``'s
    attribute tree (NumPy or JAX leaves), on ``device``."""
    def leaf(cls, src, meta=()):
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(src, f.name)
            kw[f.name] = int(v) if f.name in meta else (None if v is None else np.asarray(v))
        return cls(**kw)

    from fypraytracer_tpu_torch.accel.wide import build_wide
    from fypraytracer_tpu_torch.ops.texture import make_kernel_tex

    bvh, geometry = leaf(FlatBVH, obj.bvh, meta=("leaf_size",)), leaf(Geometry, obj.geometry)
    materials, textures = leaf(MaterialTable, obj.materials), leaf(TextureAtlas, obj.textures)
    host = Scene(
        geometry=geometry,
        materials=materials,
        bvh=bvh,
        light_tree=leaf(LightTreeArrays, obj.light_tree, meta=("max_depth",)),
        emissive_tris=np.asarray(obj.emissive_tris),
        textures=textures,
        wide=build_wide(bvh, geometry),
        tex=make_kernel_tex(materials, textures))
    return host.to(device)


# the float fields of a MaterialTable: what a training step may update
FLOAT_MATERIAL_FIELDS = ("albedo", "roughness", "metallic", "emission_color", "emission_power")


def materials_from_arrays(obj, device="cuda", requires_grad=()) -> MaterialTable:
    """The port's ``MaterialTable`` from any object with the JAX
    ``MaterialTable``'s fields (NumPy or JAX leaves, through ``np.asarray``),
    on ``device``.  The float fields named in ``requires_grad`` are leaf
    tensors that require grad."""
    kw = {}
    for f in dataclasses.fields(MaterialTable):
        t = _leaf_to(np.asarray(getattr(obj, f.name)), device)
        if f.name in requires_grad:
            if f.name not in FLOAT_MATERIAL_FIELDS:
                raise ValueError(f"{f.name} is not a float field of the material table")
            t = t.requires_grad_(True)
        kw[f.name] = t
    return MaterialTable(**kw)


def with_materials(scene: Scene, materials: MaterialTable) -> Scene:
    """``scene`` with its material table replaced (the tensors are shared,
    not copied, so a gradient reaches ``materials``).  ``materials`` maps
    the albedos as the scene's own table does: the scene keeps its texture
    levels (``Scene.tex``)."""
    return dataclasses.replace(scene, materials=materials)
