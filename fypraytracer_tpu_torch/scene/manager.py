"""SceneManager — runtime scene edits with minimal recompilation.

The torch counterpart of ``fypraytracer_tpu/scene/manager.py``, mirroring
the reference's incremental update flow (SceneManager.cpp:6-130): UI-style
mutations are queued (``meshesToUpdate``/``materialsToUpdate``
equivalents), then one ``apply()`` call rebuilds what they touched and
signals the renderer to reset accumulation (the ``isSceneUpdated`` dirty
flag, Renderer.cu:62-69 + frame-index reset, WalnutApp.cpp:638-643).

* A geometry edit (a transform, an added mesh) recompiles the scene, and
  with it the kernels' wide BVH (``Scene.wide``) and texture levels
  (``Scene.tex``).
* A material or texture edit keeps the geometry and both BVHs, and
  rebuilds the material table, the emissive list, the light tree, the
  atlas where it grew, and ``Scene.tex`` from the new table and atlas: the
  levels follow the albedo maps (``ops/texture.py::make_kernel_tex``), so
  a changed ``albedo_map`` alone rebuilds them too.

The JAX ``apply(renderer)`` swaps ``renderer.scene`` in place.  The port's
renderers derive state from their scene when they take it (the emissive
table, the Morton-permuted scene, the material ids, the overflow watch),
so ``apply(renderer)`` hands the scene to ``renderer.set_scene``, which
rebuilds that state and restarts accumulation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fypraytracer_tpu_torch.scene.build import SceneBuilder, build_light_tree, empty_light_tree, pack_atlas
from fypraytracer_tpu_torch.scene.types import MaterialTable, Scene


class SceneManager:
    """Owns a ``SceneBuilder`` and its compiled host ``Scene``; applies
    queued edits incrementally.  ``native`` (the JAX manager's default:
    True) builds the BVH and light tree with the C++ builders where they
    are available."""

    def __init__(self, builder: SceneBuilder, leaf_size: int = 4, native: bool = True):
        self.builder = builder
        self.leaf_size = leaf_size
        self.native = native
        self._meshes_dirty: set[int] = set()
        self._materials_dirty: set[int] = set()
        self._textures_dirty = False
        self.scene: Scene = builder.compile(leaf_size=leaf_size, native=native)
        self._n_packed = len(builder.textures)  # pages in the compiled atlas
        self.version = 0

    # -- mutation queue (SceneManager.h:25-26 equivalents) -------------------

    def set_mesh_transform(self, mesh_id: int, position=None, rotation=None, scale=None) -> None:
        mesh = self.builder.meshes[mesh_id]
        if position is not None:
            mesh.position = tuple(position)
        if rotation is not None:
            mesh.rotation = tuple(rotation)
        if scale is not None:
            mesh.scale = tuple(scale)
        self._meshes_dirty.add(mesh_id)

    def set_material(self, mat_id: int, **fields) -> None:
        """Update material fields (albedo, roughness, metallic,
        emission_color, emission_power, albedo_map).

        A stale ``albedo_map`` (no such registered texture) raises here
        rather than flowing into a compiled scene whose atlas lacks the
        page."""
        m = self.builder._mat
        for k, v in fields.items():
            if k not in m:
                raise KeyError(k)
            if k == "albedo_map" and not (-1 <= int(v) < len(self.builder.textures)):
                raise ValueError(
                    f"albedo_map {v} out of range: {len(self.builder.textures)}"
                    " texture(s) registered (add one with add_texture)")
            m[k][mat_id] = v
        self._materials_dirty.add(mat_id)

    def add_texture(self, rgb01_or_path) -> int:
        """Register a texture mid-session (WalnutApp.cpp:674 →
        Scene::AddNewTexture, Scene.cpp:188): an (H, W, 3) float [0, 1]
        array or an image path (.png/.bmp).  The next ``apply()`` repacks
        the atlas.  Returns the texture id for ``set_material(albedo_map=)``."""
        if isinstance(rgb01_or_path, str):
            from fypraytracer_tpu_torch.utils.image import load_image

            rgb01 = load_image(rgb01_or_path).astype(np.float32) / 255.0
        else:
            rgb01 = np.asarray(rgb01_or_path, np.float32)
        tid = self.builder.add_texture(rgb01)
        self._textures_dirty = True
        return tid

    def add_mesh(self, positions, tri_v, normals=None, uvs=None, material: int = 0,
                 position=(0.0, 0.0, 0.0), rotation=(0.0, 0.0, 0.0), scale=(1.0, 1.0, 1.0)) -> int:
        """Add a mesh mid-session (Scene::CreateNewMeshInScene,
        Scene.cpp:241-290): the next ``apply()`` recompiles the grown
        scene.  Returns the new mesh id."""
        mesh_id = self.builder.add_mesh(positions, tri_v, normals=normals, uvs=uvs, material=material,
                                        position=position, rotation=rotation, scale=scale)
        self._meshes_dirty.add(mesh_id)
        return mesh_id

    def load_mesh(self, path: str, material: int = 0, position=(0.0, 0.0, 0.0),
                  rotation=(0.0, 0.0, 0.0), scale=(1.0, 1.0, 1.0)) -> int:
        """Import an OBJ mid-session (WalnutApp.cpp:742 →
        Scene::CreateNewMeshInScene), with the loader's left-handed z-flip
        (Mesh.cpp:299-304)."""
        from fypraytracer_tpu_torch.scene.objloader import load_obj

        pos, tri, nrm, uv = load_obj(path)
        return self.add_mesh(pos, tri, normals=nrm, uvs=uv, material=material, position=position,
                             rotation=rotation, scale=scale)

    @property
    def dirty(self) -> bool:
        return bool(self._meshes_dirty or self._materials_dirty or self._textures_dirty)

    # -- flush (PerformAllSceneUpdates, SceneManager.cpp:6-130) --------------

    def apply(self, renderer=None) -> Scene:
        """Rebuild the scene if dirty; then hand it to ``renderer`` (any
        entry point with ``set_scene``), which rebuilds its derived state
        and restarts accumulation."""
        if self.dirty:
            if not self._meshes_dirty:
                self.scene = self._apply_material_edit()
            else:
                self.scene = self.builder.compile(leaf_size=self.leaf_size, native=self.native)
            self._n_packed = len(self.builder.textures)
            self.version += 1
            self._meshes_dirty.clear()
            self._materials_dirty.clear()
            self._textures_dirty = False
            if renderer is not None:
                renderer.set_scene(self.scene)
        return self.scene

    def _apply_material_edit(self) -> Scene:
        """The material-only rebuild (SceneManager.cpp:87-130): the material
        table, the emissive list and light tree, the atlas where textures
        were added or a map points past it, and ``Scene.tex``."""
        from fypraytracer_tpu_torch.ops.texture import make_kernel_tex

        m = self.builder._mat
        textures = self.scene.textures
        max_map = int(max(m["albedo_map"] or [-1]))
        if self._textures_dirty or len(self.builder.textures) != self._n_packed or max_map >= self._n_packed:
            if max_map >= len(self.builder.textures):
                raise ValueError(f"albedo_map {max_map} out of range: only "
                                 f"{len(self.builder.textures)} texture(s) registered")
            textures = pack_atlas(self.builder.textures)
        materials = MaterialTable(
            albedo=np.asarray(m["albedo"], np.float32).reshape(-1, 3),
            roughness=np.asarray(m["roughness"], np.float32),
            metallic=np.asarray(m["metallic"], np.float32),
            emission_color=np.asarray(m["emission_color"], np.float32).reshape(-1, 3),
            emission_power=np.asarray(m["emission_power"], np.float32),
            albedo_map=np.asarray(m["albedo_map"], np.int32),
        )
        g = self.scene.geometry
        positions, tri_v, tri_mat = np.asarray(g.positions), np.asarray(g.tri_v), np.asarray(g.tri_mat)
        emission = materials.emission_color * materials.emission_power[:, None]
        emissive_tris = np.nonzero((np.abs(emission).sum(axis=-1) > 0.0)[tri_mat])[0].astype(np.int32)
        mesh_ranges = [(me.tri_start, me.tri_start + len(me.tri_v)) for me in self.builder.meshes]
        if len(emissive_tris) > 0:
            lt, _ = build_light_tree(positions, tri_v, tri_mat, emission, mesh_ranges, self.native)
        else:
            lt = empty_light_tree(len(tri_v))
        return dataclasses.replace(self.scene, materials=materials, emissive_tris=emissive_tris, light_tree=lt,
                                   textures=textures, tex=make_kernel_tex(materials, textures))
