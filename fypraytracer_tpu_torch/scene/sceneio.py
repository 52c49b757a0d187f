"""Scene description files — replaces the reference's hard-coded scene
constructor (WalnutApp.cpp:43-521) with a declarative JSON format.

A copy of ``fypraytracer_tpu/scene/sceneio.py`` on the port's builders.

Schema::

    {
      "materials": [{"name": "white", "albedo": [r,g,b], "roughness": 1.0,
                     "metallic": 0.0, "emission_color": [r,g,b],
                     "emission_power": 0.0, "texture": "path.bmp"?}, ...],
      "meshes":    [{"type": "quad"|"box"|"sphere"|"obj",
                     "material": "white",
                     "position": [x,y,z], "rotation": [pitch,yaw,roll],
                     "scale": [x,y,z],
                     ... type params: size/radius/rows/cols/path}, ...],
      "camera":    {"position": [..], "forward": [..], "vfov": 45,
                    "width": 256, "height": 256}
    }
"""

from __future__ import annotations

import json
import os

import numpy as np

from fypraytracer_tpu_torch.core.camera import Camera
from fypraytracer_tpu_torch.scene import procedural
from fypraytracer_tpu_torch.scene.build import SceneBuilder
from fypraytracer_tpu_torch.scene.objloader import load_obj
from fypraytracer_tpu_torch.utils.image import load_bmp


def load_scene_file(path: str):
    """Parse a scene JSON into ``(SceneBuilder, Camera)``."""
    with open(path) as f:
        spec = json.load(f)
    base = os.path.dirname(os.path.abspath(path))
    b = SceneBuilder()

    mat_ids: dict[str, int] = {}
    for m in spec.get("materials", []):
        tex_id = -1
        if m.get("texture"):
            tex_path = os.path.join(base, m["texture"])
            rgb8 = load_bmp(tex_path)
            tex_id = b.add_texture(rgb8.astype(np.float32) / 255.0)
        mat_ids[m["name"]] = b.add_material(
            albedo=tuple(m.get("albedo", (0.8, 0.8, 0.8))),
            roughness=float(m.get("roughness", 1.0)),
            metallic=float(m.get("metallic", 0.0)),
            emission_color=tuple(m.get("emission_color", (0, 0, 0))),
            emission_power=float(m.get("emission_power", 0.0)),
            albedo_map=tex_id)

    for mesh in spec.get("meshes", []):
        kind = mesh.get("type", "quad")
        if kind == "quad":
            geo = procedural.quad(*mesh.get("size", (1.0, 1.0)))
        elif kind == "box":
            geo = procedural.box(tuple(mesh.get("size", (1.0, 1.0, 1.0))))
        elif kind == "sphere":
            geo = procedural.uv_sphere(float(mesh.get("radius", 1.0)),
                                       int(mesh.get("rows", 16)),
                                       int(mesh.get("cols", 32)))
        elif kind == "obj":
            geo = load_obj(os.path.join(base, mesh["path"]))
        else:
            raise ValueError(f"unknown mesh type {kind!r}")
        b.add_mesh(*geo,
                   material=mat_ids[mesh["material"]],
                   position=tuple(mesh.get("position", (0, 0, 0))),
                   rotation=tuple(mesh.get("rotation", (0, 0, 0))),
                   scale=tuple(mesh.get("scale", (1, 1, 1))))

    cspec = spec.get("camera", {})
    cam = Camera(position=cspec.get("position", (0, 1, 3)),
                 forward=cspec.get("forward", (0, 0, -1)),
                 vfov_deg=float(cspec.get("vfov", 45.0)),
                 width=int(cspec.get("width", 256)),
                 height=int(cspec.get("height", 256)))
    return b, cam


def builtin_scene(name: str, width: int, height: int):
    """Named built-in scenes (the reference's authored content, §2.1)."""
    if name == "cornell":
        return procedural.cornell_box(width=width, height=height)
    if name == "cornell-empty":
        return procedural.cornell_box(width=width, height=height,
                                      with_spheres=False)
    if name == "triangle":
        return procedural.single_triangle()
    if name == "room":
        return procedural.room(width=width, height=height)
    if name == "stress":
        return procedural.stress(width=width, height=height)
    raise ValueError(f"unknown builtin scene {name!r} "
                     "(try: cornell, cornell-empty, triangle, room, "
                     "stress)")
