"""The benchmark's scenes, described and built by the plain reference alone.

Copies of the path tracer's procedural scenes (``cornell_box``: the
Cornell room, its area light and two spheres; ``stress``: 98 UV spheres of
2,048 triangles in a lit shell, 200,712 triangles), compiled to a world-
space triangle soup with the same transforms, the emissive triangles'
light tree (``lighttree_build``), and, where the configuration asks for
it, the triangles renumbered along the Z-order curve of their centroids
after the light tree is built, as the renderer's Morton order does.
Nothing here reads the program: the configuration's file names the scene
and its camera size.
"""

from __future__ import annotations

import numpy as np

from gpubench.reference.camera import Camera
from gpubench.reference.lighttree_build import build_scene_light_tree
from gpubench.reference.morton import morton3d
from gpubench.reference.types import Geometry, MaterialTable, RefScene


def quad(size_x: float = 1.0, size_z: float = 1.0):
    """Unit quad in the XZ plane facing +Y, centred at the origin."""
    hx, hz = size_x / 2.0, size_z / 2.0
    positions = np.array([[-hx, 0, -hz], [hx, 0, -hz], [hx, 0, hz], [-hx, 0, hz]], np.float32)
    tri_v = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    normals = np.tile(np.float32([0, 1, 0]), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return positions, tri_v, normals, uvs


def uv_sphere(radius: float = 1.0, rows: int = 16, cols: int = 32):
    """UV sphere with analytic normals: latitude rings × longitude segments."""
    positions, normals, uvs = [], [], []
    for r in range(rows + 1):
        theta = np.pi * r / rows
        for c in range(cols + 1):
            phi = 2.0 * np.pi * c / cols
            n = np.float32([np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)])
            positions.append(n * radius)
            normals.append(n)
            uvs.append(np.float32([c / cols, r / rows]))
    tri_v = []
    stride = cols + 1
    for r in range(rows):
        for c in range(cols):
            a = r * stride + c
            b = a + stride
            tri_v.append([a, b, a + 1])
            tri_v.append([a + 1, b, b + 1])
    return (np.asarray(positions, np.float32), np.asarray(tri_v, np.int32),
            np.asarray(normals, np.float32), np.asarray(uvs, np.float32))


def _yaw_pitch_roll(yaw_deg, pitch_deg, roll_deg):
    y, x, z = np.deg2rad([yaw_deg, pitch_deg, roll_deg])
    cy, sy, cx, sx, cz, sz = np.cos(y), np.sin(y), np.cos(x), np.sin(x), np.cos(z), np.sin(z)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
    return ry @ rx @ rz


class Builder:
    """Meshes and materials, compiled to a ``RefScene``."""

    def __init__(self):
        self.meshes = []
        self.mats = dict(albedo=[], roughness=[], metallic=[], emission_color=[], emission_power=[])

    def add_material(self, albedo=(0.8, 0.8, 0.8), roughness=1.0, metallic=0.0,
                     emission_color=(0.0, 0.0, 0.0), emission_power=0.0) -> int:
        for k, v in dict(albedo=albedo, roughness=roughness, metallic=metallic, emission_color=emission_color,
                         emission_power=emission_power).items():
            self.mats[k].append(v)
        return len(self.mats["albedo"]) - 1

    def add_mesh(self, positions, tri_v, normals, uvs, material, position=(0, 0, 0), rotation=(0, 0, 0)):
        self.meshes.append((positions, tri_v, normals, uvs, material, position, rotation))

    def compile(self, morton: bool) -> RefScene:
        pos, nrm, uv, tri, mat, ranges = [], [], [], [], [], []
        v_off = t_off = 0
        for p, tv, n, u, m, position, rotation in self.meshes:
            r = _yaw_pitch_roll(rotation[1], rotation[0], rotation[2])
            pos.append((p @ r.T + np.asarray(position, np.float32)).astype(np.float32))
            nh = n @ np.linalg.inv(r).T.T
            nh /= np.maximum(np.linalg.norm(nh, axis=-1, keepdims=True), 1e-20)
            nrm.append(nh.astype(np.float32))
            uv.append(u.astype(np.float32))
            tri.append(tv + v_off)
            mat.append(np.full(len(tv), m, np.int32))
            ranges.append((t_off, t_off + len(tv)))
            v_off += len(p)
            t_off += len(tv)
        positions, tri_v, tri_mat = np.concatenate(pos), np.concatenate(tri).astype(np.int32), np.concatenate(mat)
        mats = MaterialTable(
            albedo=np.asarray(self.mats["albedo"], np.float32).reshape(-1, 3),
            roughness=np.asarray(self.mats["roughness"], np.float32),
            metallic=np.asarray(self.mats["metallic"], np.float32),
            emission_color=np.asarray(self.mats["emission_color"], np.float32).reshape(-1, 3),
            emission_power=np.asarray(self.mats["emission_power"], np.float32))
        emission = (mats.emission_color * mats.emission_power[:, None]).astype(np.float32)
        lt = build_scene_light_tree(positions, tri_v, tri_mat, emission, ranges)
        if morton:
            tri_v, tri_mat, lt = _morton_order(positions, tri_v, tri_mat, lt)
        geo = Geometry(positions=positions, normals=np.concatenate(nrm), uvs=np.concatenate(uv),
                       tri_v=tri_v, tri_mat=tri_mat)
        return RefScene(geometry=geo, materials=mats, light_tree=lt)


def _morton_order(positions, tri_v, tri_mat, lt):
    """The triangles renumbered along the Z-order curve of their centroids
    (stable), with the light tree's triangle ids remapped."""
    import dataclasses

    cent = (positions[tri_v[:, 0]] + positions[tri_v[:, 1]] + positions[tri_v[:, 2]]) / 3.0
    perm = np.argsort(morton3d(cent, lo=cent.min(axis=0), hi=cent.max(axis=0) + 1e-6), kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    tri = np.where(lt.tri >= 0, inv[np.maximum(lt.tri, 0)], -1).astype(np.int32)
    return tri_v[perm], tri_mat[perm], dataclasses.replace(lt, tri=tri, leaf_of_tri=lt.leaf_of_tri[perm])


def cornell_box(width: int, height: int):
    """The Cornell room, a 0.6 x 0.6 area light under its ceiling and two
    spheres (rough diffuse, metallic); 1,164 triangles."""
    b = Builder()
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=1.0)
    red = b.add_material(albedo=(0.65, 0.05, 0.05), roughness=1.0)
    green = b.add_material(albedo=(0.12, 0.45, 0.15), roughness=1.0)
    light = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 1.0, 1.0), emission_power=5.0)
    q = quad(2.0, 2.0)
    b.add_mesh(*q, material=white, position=(0, 0, 0))
    b.add_mesh(*q, material=white, position=(0, 2, 0), rotation=(180, 0, 0))
    b.add_mesh(*q, material=white, position=(0, 1, -1), rotation=(90, 0, 0))
    b.add_mesh(*q, material=red, position=(-1, 1, 0), rotation=(0, 0, -90))
    b.add_mesh(*q, material=green, position=(1, 1, 0), rotation=(0, 0, 90))
    b.add_mesh(*quad(0.6, 0.6), material=light, position=(0, 1.98, 0), rotation=(180, 0, 0))
    rough = b.add_material(albedo=(0.8, 0.6, 0.2), roughness=0.4, metallic=0.0)
    metal = b.add_material(albedo=(0.9, 0.9, 0.9), roughness=0.15, metallic=1.0)
    s = uv_sphere(0.35, 12, 24)
    b.add_mesh(*s, material=rough, position=(-0.4, 0.35, -0.3))
    b.add_mesh(*s, material=metal, position=(0.45, 0.35, 0.25))
    cam = Camera(position=(0.0, 1.0, 2.6), forward=(0.0, 0.0, -1.0), vfov_deg=45.0, width=width, height=height)
    return b, cam


def stress(width: int, height: int):
    """Two layers of 7 x 7 UV spheres of 2,048 triangles each, in a lit
    4 x 4 x 4 shell with a 1.2 x 1.2 area light; 200,712 triangles."""
    b = Builder()
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=1.0)
    light = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 1.0, 1.0), emission_power=8.0)
    q = quad(4.0, 4.0)
    b.add_mesh(*q, material=white, position=(0, 0, 0))
    b.add_mesh(*q, material=white, position=(0, 4, 0), rotation=(180, 0, 0))
    b.add_mesh(*q, material=white, position=(0, 2, -2), rotation=(90, 0, 0))
    b.add_mesh(*quad(1.2, 1.2), material=light, position=(0, 3.96, 0), rotation=(180, 0, 0))
    s = uv_sphere(0.16, 32, 32)
    rng = np.random.default_rng(7)
    mats = [b.add_material(albedo=tuple(c), roughness=float(r), metallic=float(m))
            for c, r, m in zip(rng.uniform(0.2, 0.9, (8, 3)), rng.uniform(0.1, 1.0, 8), rng.uniform(0.0, 1.0, 8))]
    n = 0
    for iz in range(2):
        for iy in range(7):
            for ix in range(7):
                b.add_mesh(*s, material=mats[n % len(mats)],
                           position=(-1.5 + ix * 0.5, 0.5 + iy * 0.45, -1.2 + iz * 0.8))
                n += 1
    cam = Camera(position=(0.0, 2.0, 4.5), forward=(0.0, -0.1, -1.0), vfov_deg=50.0, width=width, height=height)
    return b, cam


SCENES = {"cornell_box": cornell_box, "stress": stress}


def build(config: dict, width: int, height: int):
    """``(RefScene on the host, Camera)`` of the configuration's scene."""
    builder, cam = SCENES[config["scene"]](width, height)
    return builder.compile(morton=config["morton"]), cam
