"""Scene compiler: authored meshes/materials → SoA ``Scene`` (NumPy).

Plays the role of ``Scene::AddNewMeshToScene`` + ``SceneToGPU``
(Scene.cpp:9-92, Scene_GPU.cpp:6-81): the scene is flattened once into
dense arrays, and ``Scene.to(device)`` uploads them.

A copy of ``fypraytracer_tpu/scene/build.py``.  ``compile`` builds with
the NumPy builders by default (the JAX package's ``compile(native=False)``);
``native=True`` takes the C++ builders of ``accel/native.py`` and falls
back to NumPy where they are unavailable, as the JAX package does.

Transform baking matches Scene.cpp:32-51: world = T · yawPitchRoll(y,x,z)
· S applied to positions.  Deviation (documented fix of a reference quirk):
normals are transformed by the inverse-transpose of the upper 3×3 — the
reference uses the full matrix (Scene.cpp:46), which is wrong under
non-uniform scale.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fypraytracer_tpu_torch.accel import bvh as bvh_mod
from fypraytracer_tpu_torch.accel import lighttree as lt_mod
from fypraytracer_tpu_torch.accel.wide import build_wide
from fypraytracer_tpu_torch.scene.types import (
    Geometry,
    LightTreeArrays,
    MaterialTable,
    Scene,
    TextureAtlas,
)
from fypraytracer_tpu_torch.utils import profiling

ATLAS_PAGE = 256  # atlas page resolution (textures resampled to this)


def yaw_pitch_roll(yaw_deg: float, pitch_deg: float, roll_deg: float) -> np.ndarray:
    """glm::yawPitchRoll = Y(yaw) · X(pitch) · Z(roll), row-major 3x3."""
    y, x, z = np.deg2rad([yaw_deg, pitch_deg, roll_deg])
    cy, sy = np.cos(y), np.sin(y)
    cx, sx = np.cos(x), np.sin(x)
    cz, sz = np.cos(z), np.sin(z)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
    return ry @ rx @ rz


def compose_transform(position, rotation_deg, scale) -> np.ndarray:
    """T · yawPitchRoll(rot.y, rot.x, rot.z) · S (Scene.cpp:32-39)."""
    m = np.eye(4, dtype=np.float32)
    r = yaw_pitch_roll(rotation_deg[1], rotation_deg[0], rotation_deg[2])
    m[:3, :3] = r * np.asarray(scale, np.float32)[None, :]
    m[:3, 3] = np.asarray(position, np.float32)
    return m


def smooth_normals(positions: np.ndarray, tri_v: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (stand-in for Assimp GenSmoothNormals)."""
    p0, p1, p2 = (positions[tri_v[:, k]] for k in range(3))
    fn = np.cross(p1 - p0, p2 - p0)  # area-weighted
    out = np.zeros_like(positions)
    for k in range(3):
        np.add.at(out, tri_v[:, k], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(norm, 1e-20)).astype(np.float32)


@dataclasses.dataclass
class MeshEntry:
    """Host-side mesh record (Mesh.h:17-37): local data + transform +
    offsets into the global SoA buffers."""

    positions: np.ndarray
    tri_v: np.ndarray
    normals: np.ndarray | None
    uvs: np.ndarray | None
    material: int
    position: tuple
    rotation: tuple
    scale: tuple
    vertex_start: int = 0
    tri_start: int = 0


class SceneBuilder:
    """Accumulates authored content, compiles to a device ``Scene``."""

    def __init__(self):
        self.meshes: list[MeshEntry] = []
        self._mat = dict(albedo=[], roughness=[], metallic=[],
                         emission_color=[], emission_power=[], albedo_map=[])
        self.textures: list[np.ndarray] = []
        self.last_builders: dict = {}     # which builders the last compile ran

    # -- authoring ---------------------------------------------------------

    def add_material(self, albedo=(0.8, 0.8, 0.8), roughness=1.0, metallic=0.0,
                     emission_color=(0.0, 0.0, 0.0), emission_power=0.0,
                     albedo_map: int = -1) -> int:
        """Material fields per Material.cuh:7-21."""
        m = self._mat
        m["albedo"].append(albedo)
        m["roughness"].append(roughness)
        m["metallic"].append(metallic)
        m["emission_color"].append(emission_color)
        m["emission_power"].append(emission_power)
        m["albedo_map"].append(albedo_map)
        return len(m["albedo"]) - 1

    def add_texture(self, rgb01: np.ndarray) -> int:
        """Register an (H, W, 3) float RGB [0,1] texture; returns atlas id."""
        self.textures.append(np.asarray(rgb01, np.float32))
        return len(self.textures) - 1

    def add_mesh(self, positions, tri_v, normals=None, uvs=None, material=0,
                 position=(0.0, 0.0, 0.0), rotation=(0.0, 0.0, 0.0),
                 scale=(1.0, 1.0, 1.0)) -> int:
        """Append a mesh (Scene::AddNewMeshToScene semantics, Scene.cpp:9-92)."""
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        tri_v = np.asarray(tri_v, np.int32).reshape(-1, 3)
        self.meshes.append(MeshEntry(
            positions=positions, tri_v=tri_v,
            normals=None if normals is None else np.asarray(normals, np.float32).reshape(-1, 3),
            uvs=None if uvs is None else np.asarray(uvs, np.float32).reshape(-1, 2),
            material=material, position=tuple(position), rotation=tuple(rotation),
            scale=tuple(scale)))
        return len(self.meshes) - 1

    # -- compilation -------------------------------------------------------

    @profiling.setup_spanned("scene.compile")
    def compile(self, leaf_size: int = 4, light_tree: bool = True, native: bool = False) -> Scene:
        """Bake transforms, flatten SoA, build BVH/light tree/atlas, and the
        kernels' wide BVH (``Scene.wide``) and texture levels (``Scene.tex``).

        ``native=False`` (the default) builds with the NumPy builders, the
        JAX package's ``compile(native=False)``; ``native=True`` prefers the
        C++ builders (``accel/native.py``) and falls back to NumPy where
        g++ or the library is unavailable.  ``last_builders`` records which
        builder made the BVH and the light tree.
        """
        all_pos, all_nrm, all_uv, all_tri, all_mat = [], [], [], [], []
        mesh_ranges = []
        v_off = 0
        t_off = 0
        for mesh in self.meshes:
            mesh.vertex_start = v_off
            mesh.tri_start = t_off
            m = compose_transform(mesh.position, mesh.rotation, mesh.scale)
            pos_h = mesh.positions @ m[:3, :3].T + m[:3, 3]
            nrm_local = mesh.normals if mesh.normals is not None else smooth_normals(mesh.positions, mesh.tri_v)
            # inverse-transpose for normals (documented fix of Scene.cpp:46)
            nit = np.linalg.inv(m[:3, :3]).T
            nrm_h = nrm_local @ nit.T
            nrm_h /= np.maximum(np.linalg.norm(nrm_h, axis=-1, keepdims=True), 1e-20)
            uv_h = mesh.uvs if mesh.uvs is not None else np.zeros((len(pos_h), 2), np.float32)

            all_pos.append(pos_h.astype(np.float32))
            all_nrm.append(nrm_h.astype(np.float32))
            all_uv.append(uv_h.astype(np.float32))
            all_tri.append(mesh.tri_v + v_off)
            all_mat.append(np.full(len(mesh.tri_v), mesh.material, np.int32))
            v_off += len(pos_h)
            n_tri = len(mesh.tri_v)
            mesh_ranges.append((t_off, t_off + n_tri))
            t_off += n_tri

        positions = np.concatenate(all_pos) if all_pos else np.zeros((0, 3), np.float32)
        normals = np.concatenate(all_nrm) if all_nrm else np.zeros((0, 3), np.float32)
        uvs = np.concatenate(all_uv) if all_uv else np.zeros((0, 2), np.float32)
        tri_v = np.concatenate(all_tri) if all_tri else np.zeros((0, 3), np.int32)
        tri_mat = np.concatenate(all_mat) if all_mat else np.zeros((0,), np.int32)

        geometry = Geometry(positions=positions, normals=normals, uvs=uvs,
                            tri_v=tri_v.astype(np.int32), tri_mat=tri_mat)

        materials = MaterialTable(
            albedo=np.asarray(self._mat["albedo"], np.float32).reshape(-1, 3),
            roughness=np.asarray(self._mat["roughness"], np.float32),
            metallic=np.asarray(self._mat["metallic"], np.float32),
            emission_color=np.asarray(self._mat["emission_color"], np.float32).reshape(-1, 3),
            emission_power=np.asarray(self._mat["emission_power"], np.float32),
            albedo_map=np.asarray(self._mat["albedo_map"], np.int32),
        )

        # per-triangle AABBs (Scene.cpp:58-77)
        p0, p1, p2 = (positions[tri_v[:, k]] for k in range(3))
        tri_lo = np.minimum(np.minimum(p0, p1), p2)
        tri_hi = np.maximum(np.maximum(p0, p1), p2)

        flat_bvh = None
        with profiling.setup_span("scene.bvh"):
            if native and len(tri_v) > 0:
                from fypraytracer_tpu_torch.accel import native as native_mod
                flat_bvh = native_mod.build_scene_bvh_native(tri_lo, tri_hi, mesh_ranges, leaf_size)
            self.last_builders = dict(bvh="numpy" if flat_bvh is None else "native", light_tree="none")
            if flat_bvh is None:
                flat_bvh = bvh_mod.build_scene_bvh(tri_lo, tri_hi, mesh_ranges, leaf_size)

        # emissive triangle list (InitSceneEmissiveTriangles, Scene.cpp:209-221)
        emission = materials.emission_color * materials.emission_power[:, None]
        emissive_mat = (np.abs(emission).sum(axis=-1) > 0.0)
        emissive_tris = np.nonzero(emissive_mat[tri_mat])[0].astype(np.int32)

        with profiling.setup_span("scene.light_tree"):
            if light_tree and len(emissive_tris) > 0:
                lt, self.last_builders["light_tree"] = build_light_tree(positions, tri_v, tri_mat, emission,
                                                                         mesh_ranges, native)
            else:
                lt = empty_light_tree(len(tri_v))

        from fypraytracer_tpu_torch.ops.texture import make_kernel_tex

        with profiling.setup_span("scene.tex"):
            atlas = pack_atlas(self.textures)
            tex = make_kernel_tex(materials, atlas)
        with profiling.setup_span("scene.wide"):
            wide = build_wide(flat_bvh, geometry)
        return Scene(geometry=geometry, materials=materials, bvh=flat_bvh,
                     light_tree=lt, emissive_tris=emissive_tris, textures=atlas, wide=wide, tex=tex)


def build_light_tree(positions, tri_v, tri_mat, emission, mesh_ranges, native: bool):
    """``(light tree, "native" | "numpy")`` over the emissive triangles: the
    C++ builder where ``native`` and it is available, else NumPy's."""
    emission = np.asarray(emission, np.float32)
    if native:
        from fypraytracer_tpu_torch.accel import native as native_mod
        lt = native_mod.build_light_tree_native(positions, tri_v, tri_mat, emission, mesh_ranges)
        if lt is not None:
            return lt, "native"
    return lt_mod.build_scene_light_tree(positions, tri_v, tri_mat, emission, mesh_ranges), "numpy"


def empty_light_tree(num_tris: int) -> LightTreeArrays:
    z3 = np.zeros((1, 3), np.float32)
    z1 = np.zeros((1,), np.float32)
    mi = np.full((1,), -1, np.int32)
    return LightTreeArrays(energy=z1, axis=z3, theta_o=z1, theta_e=z1,
                           box_lo=z3, box_hi=z3, left=mi, right=mi, tri=mi,
                           parent=mi,
                           leaf_of_tri=np.full((max(num_tris, 1),), -1, np.int32))


def _resize_bilinear(tex: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resample to (h, w) with the framework's (n-1) endpoint
    convention (matches ops/texture.py::sample_bilinear footprints)."""
    sh, sw = tex.shape[:2]
    if (sh, sw) == (h, w):
        return np.asarray(tex[..., :3], np.float32)
    fy = np.linspace(0.0, sh - 1.0, h, dtype=np.float64)
    fx = np.linspace(0.0, sw - 1.0, w, dtype=np.float64)
    y0 = np.floor(fy).astype(np.int64)
    x0 = np.floor(fx).astype(np.int64)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    ay = (fy - y0).astype(np.float32)[:, None, None]
    ax = (fx - x0).astype(np.float32)[None, :, None]
    t = np.asarray(tex[..., :3], np.float32)
    top = t[y0[:, None], x0[None, :]] * (1 - ax) + t[y0[:, None], x1[None, :]] * ax
    bot = t[y1[:, None], x0[None, :]] * (1 - ax) + t[y1[:, None], x1[None, :]] * ax
    return top * (1 - ay) + bot * ay


def _box_downsample(tex: np.ndarray, h: int, w: int) -> np.ndarray:
    """Area-average minification (exact mean pooling when divisible,
    bilinear fallback otherwise)."""
    sh, sw = tex.shape[:2]
    t = np.asarray(tex[..., :3], np.float32)
    if sh % h == 0 and sw % w == 0:
        return t.reshape(h, sh // h, w, sw // w, 3).mean(axis=(1, 3))
    return _resize_bilinear(t, h, w)


def pack_atlas(textures: list[np.ndarray], page: int | None = None,
               bounce_page: int = 128) -> TextureAtlas:
    """Pack textures into one (K, H, W, 3) mip-0 gather source plus a
    box-filtered (K, hb, wb, 3) bounce level (see TextureAtlas policy).

    ``page=None`` keeps the largest native resolution (smaller textures are
    bilinearly upsampled so one page size serves all ids); an explicit
    ``page`` forces that resolution (legacy ATLAS_PAGE behavior, now with
    proper filtering instead of nearest)."""
    if not textures:
        return TextureAtlas(pages=np.zeros((1, 8, 8, 3), np.float32),
                            size=np.ones((1, 2), np.int32) * 8,
                            bounce_pages=np.zeros((1, 8, 8, 3), np.float32))
    if page is None:
        ph = max(t.shape[0] for t in textures)
        pw = max(t.shape[1] for t in textures)
    else:
        ph = pw = page
    bh = min(bounce_page, ph)
    bw = min(bounce_page, pw)
    pages, bounce, sizes = [], [], []
    for tex in textures:
        h, w = tex.shape[:2]
        full = (_resize_bilinear(tex, ph, pw) if h <= ph and w <= pw
                else _box_downsample(tex, ph, pw))
        pages.append(full)
        bounce.append(_box_downsample(full, bh, bw))
        sizes.append((w, h))
    return TextureAtlas(pages=np.asarray(pages, np.float32),
                        size=np.asarray(sizes, np.int32),
                        bounce_pages=np.asarray(bounce, np.float32))
