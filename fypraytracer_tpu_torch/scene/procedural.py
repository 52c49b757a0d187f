"""Procedural geometry and the Cornell box.

A copy of ``fypraytracer_tpu/scene/procedural.py``: ``quad``, ``box``,
``uv_sphere`` (Mesh.cpp:7-95 semantics), ``cornell_box`` (the structural
analog of the reference's hard-coded room, WalnutApp.cpp:43-521), the
200,712-triangle ``stress`` scene, ``single_triangle``, and ``room``, the
reference's authored scene.  ``room`` reads the reference's OBJ and PNG
files, which the repository does not hold: ``_find_asset`` looks for them
in ``$FYP_ASSETS`` and ``<repo>/assets`` only, and raises where they are
missing.
"""

from __future__ import annotations

import os

import numpy as np

from fypraytracer_tpu_torch.core.camera import Camera
from fypraytracer_tpu_torch.scene.build import SceneBuilder


def quad(size_x: float = 1.0, size_z: float = 1.0):
    """Unit quad in the XZ plane facing +Y, centered at origin."""
    hx, hz = size_x / 2.0, size_z / 2.0
    positions = np.array(
        [[-hx, 0, -hz], [hx, 0, -hz], [hx, 0, hz], [-hx, 0, hz]], np.float32)
    tri_v = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    normals = np.tile(np.float32([0, 1, 0]), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return positions, tri_v, normals, uvs


def box(size=(1.0, 1.0, 1.0)):
    """Axis-aligned box centered at origin, outward normals, 12 triangles."""
    sx, sy, sz = np.asarray(size, np.float32) / 2.0
    faces = []
    # (axis, sign): plane at axis=sign*half, normal = sign*axis
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            u = np.zeros(3, np.float32)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(n, u)
            half = np.float32([sx, sy, sz])
            c = n * half
            ue = u * half
            ve = v * half
            quad_pts = [c - ue - ve, c + ue - ve, c + ue + ve, c - ue + ve]
            faces.append((np.asarray(quad_pts, np.float32), n))
    positions, tri_v, normals, uvs = [], [], [], []
    for i, (pts, n) in enumerate(faces):
        base = 4 * i
        positions.append(pts)
        normals.append(np.tile(n, (4, 1)))
        uvs.append(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
        tri_v.append(np.array([[base, base + 1, base + 2], [base, base + 2, base + 3]], np.int32))
    return (np.concatenate(positions), np.concatenate(tri_v),
            np.concatenate(normals), np.concatenate(uvs))


def uv_sphere(radius: float = 1.0, rows: int = 16, cols: int = 32):
    """UV sphere with analytic normals (Mesh::GenerateSphereMesh semantics,
    Mesh.cpp:7-95: latitude rings × longitude segments, pole caps)."""
    positions, normals, uvs = [], [], []
    for r in range(rows + 1):
        theta = np.pi * r / rows
        for c in range(cols + 1):
            phi = 2.0 * np.pi * c / cols
            n = np.float32([np.sin(theta) * np.cos(phi), np.cos(theta),
                            np.sin(theta) * np.sin(phi)])
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


def cornell_box(width: int = 256, height: int = 256, light_power: float = 5.0,
                with_spheres: bool = True, sphere_res: tuple = (12, 24)):
    """The flagship benchmark scene: Cornell-box room + area light + two
    spheres (one rough diffuse, one metallic) — the structural analog of
    the reference's hard-coded room with area-light planes
    (WalnutApp.cpp:127-503).

    Returns ``(SceneBuilder, Camera)`` — call ``builder.compile()``.
    """
    b = SceneBuilder()
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=1.0)
    red = b.add_material(albedo=(0.65, 0.05, 0.05), roughness=1.0)
    green = b.add_material(albedo=(0.12, 0.45, 0.15), roughness=1.0)
    light = b.add_material(albedo=(0.0, 0.0, 0.0),
                           emission_color=(1.0, 1.0, 1.0),
                           emission_power=light_power)

    q = quad(2.0, 2.0)
    # floor (y=0, up), ceiling (y=2, down), back wall (z=-1), left red, right green
    b.add_mesh(*q, material=white, position=(0, 0, 0))
    b.add_mesh(*q, material=white, position=(0, 2, 0), rotation=(180, 0, 0))
    b.add_mesh(*q, material=white, position=(0, 1, -1), rotation=(90, 0, 0))
    b.add_mesh(*q, material=red, position=(-1, 1, 0), rotation=(0, 0, -90))
    b.add_mesh(*q, material=green, position=(1, 1, 0), rotation=(0, 0, 90))
    # area light just under the ceiling, facing down
    lq = quad(0.6, 0.6)
    b.add_mesh(*lq, material=light, position=(0, 1.98, 0), rotation=(180, 0, 0))

    if with_spheres:
        rough = b.add_material(albedo=(0.8, 0.6, 0.2), roughness=0.4, metallic=0.0)
        metal = b.add_material(albedo=(0.9, 0.9, 0.9), roughness=0.15, metallic=1.0)
        s = uv_sphere(0.35, *sphere_res)
        b.add_mesh(*s, material=rough, position=(-0.4, 0.35, -0.3))
        b.add_mesh(*s, material=metal, position=(0.45, 0.35, 0.25))

    cam = Camera(position=(0.0, 1.0, 2.6), forward=(0.0, 0.0, -1.0),
                 vfov_deg=45.0, width=width, height=height)
    return b, cam


def texture_quads(builder, big: int = 0, seed: int = 0) -> None:
    """Add textured quads to a Cornell-box builder (any builder with
    ``SceneBuilder``'s authoring calls, so the JAX package's too): the 64²
    checker on a 1×1 floor quad of tests/test_textured_megakernel.py:16-26,
    and with ``big`` > 0 a ``big``² texture of seeded noise
    (``numpy.random.default_rng(seed)``) on a 1.6×1.6 quad before the back
    wall, its UVs spanning [-1.5, 2.5] so that they wrap and go negative.
    A ``big`` above 256 is larger than the kernels' primary level
    (ops/texture.py::KERNEL_TEX_PAGE), which box-filters it."""
    h = w = 64
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    checker = ((xx // 8 + yy // 8) % 2).astype(np.float32)
    tid = builder.add_texture(np.stack([checker, 0.5 + 0.3 * checker, 1.0 - checker], axis=-1))
    tmat = builder.add_material(albedo=(0.2, 0.2, 0.2), roughness=0.8, albedo_map=tid)
    builder.add_mesh(*quad(1.0, 1.0), material=tmat, position=(0.0, 0.01, 0.3))
    if big > 0:
        noise = np.random.default_rng(seed).uniform(0.1, 0.9, (big, big, 3)).astype(np.float32)
        nid = builder.add_texture(noise)
        nmat = builder.add_material(albedo=(0.5, 0.5, 0.5), roughness=0.9, albedo_map=nid)
        pos, tri_v, nrm, uvs = quad(1.6, 1.6)
        builder.add_mesh(pos, tri_v, nrm, uvs * 4.0 - 1.5, material=nmat, position=(0.0, 1.0, -0.98),
                         rotation=(90, 0, 0))


def textured_cornell_box(width: int = 256, height: int = 256, big: int = 0, seed: int = 0,
                         sphere_res: tuple = (12, 24)):
    """``cornell_box`` with ``texture_quads``: the scene of the textured
    tests and of chip_smoke.py's textured phase.  Returns ``(SceneBuilder,
    Camera)``."""
    builder, cam = cornell_box(width, height, sphere_res=sphere_res)
    texture_quads(builder, big, seed)
    return builder, cam


def stress(width: int = 256, height: int = 256, grid: int = 7,
           sphere_res: tuple = (32, 32)):
    """Large-scene stress benchmark: a 2-layer grid² lattice of UV spheres
    (2·grid²·2·rows·cols triangles, 200,712 in all at the defaults) inside a
    lit Cornell shell (fypraytracer_tpu/scene/procedural.py:221-258)."""
    b = SceneBuilder()
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=1.0)
    light = b.add_material(albedo=(0.0, 0.0, 0.0),
                           emission_color=(1.0, 1.0, 1.0),
                           emission_power=8.0)
    q = quad(4.0, 4.0)
    b.add_mesh(*q, material=white, position=(0, 0, 0))
    b.add_mesh(*q, material=white, position=(0, 4, 0), rotation=(180, 0, 0))
    b.add_mesh(*q, material=white, position=(0, 2, -2), rotation=(90, 0, 0))
    lq = quad(1.2, 1.2)
    b.add_mesh(*lq, material=light, position=(0, 3.96, 0),
               rotation=(180, 0, 0))

    s = uv_sphere(0.16, *sphere_res)     # 2*rows*cols tris each
    rng = np.random.default_rng(7)
    mats = [b.add_material(albedo=tuple(c), roughness=float(r),
                           metallic=float(m))
            for c, r, m in zip(rng.uniform(0.2, 0.9, (8, 3)),
                               rng.uniform(0.1, 1.0, 8),
                               rng.uniform(0.0, 1.0, 8))]
    n = 0
    for iz in range(2):
        for iy in range(grid):
            for ix in range(grid):
                b.add_mesh(*s, material=mats[n % len(mats)],
                           position=(-1.5 + ix * 0.5, 0.5 + iy * 0.45,
                                     -1.2 + iz * 0.8))
                n += 1
    cam = Camera(position=(0.0, 2.0, 4.5), forward=(0.0, -0.1, -1.0),
                 vfov_deg=50.0, width=width, height=height)
    return b, cam


def single_triangle():
    """Minimal scene for unit tests: one diffuse triangle, no emitter."""
    b = SceneBuilder()
    mat = b.add_material(albedo=(1.0, 0.0, 0.0), roughness=1.0)
    positions = np.float32([[-1, -1, 0], [1, -1, 0], [0, 1, 0]])
    tri_v = np.int32([[0, 1, 2]])
    normals = np.tile(np.float32([0, 0, 1]), (3, 1))
    b.add_mesh(positions, tri_v, normals, material=mat)
    cam = Camera(position=(0, 0, 3), forward=(0, 0, -1), width=64, height=64)
    return b, cam


def _asset_dirs() -> list[str]:
    """Where ``room``'s assets are looked for: ``$FYP_ASSETS``, then
    ``<repo>/assets``."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return [d for d in (os.environ.get("FYP_ASSETS", ""), os.path.join(repo, "assets")) if d]


def _find_asset(name: str) -> str:
    for d in _asset_dirs():
        if os.path.exists(os.path.join(d, name)):
            return os.path.join(d, name)
    raise FileNotFoundError(
        f"asset {name!r} not found; searched {_asset_dirs()} (set FYP_ASSETS to the directory "
        "holding the reference's '3D Models/Test' assets)")


def room(width: int = 256, height: int = 256):
    """The reference's authored benchmark scene (WalnutApp.cpp:43-521;
    fypraytracer_tpu/scene/procedural.py:144-218): a 7.5-unit room (white
    floor/ceiling, red front +Z, magenta back -Z, blue left -X, green right
    +X), a textured banana (banana.obj + bananaDiffuse.png,
    WalnutApp.cpp:128-166) and toaster (toaster.obj + toasterBaseColor.png,
    :169-207), and 5 emissive ceiling planes (power 40, :485-520).  Camera
    start pose per WalnutApp.cpp:519-520.

    Returns ``(SceneBuilder, Camera)``; raises ``FileNotFoundError`` naming
    ``FYP_ASSETS`` where an asset is missing.
    """
    from fypraytracer_tpu_torch.scene.objloader import load_obj
    from fypraytracer_tpu_torch.utils.image import load_image

    b = SceneBuilder()
    # materials 0-8 in the reference's emplacement order (WalnutApp.cpp:46-91)
    magenta = b.add_material(albedo=(1, 0, 1), roughness=1.0)
    b.add_material(albedo=(0.2, 0.3, 1.0), roughness=0.75, metallic=0.2)  # unused sphere mat
    emissive = b.add_material(albedo=(1, 1, 1), emission_color=(1, 1, 1), emission_power=40.0)
    red = b.add_material(albedo=(1, 0, 0), roughness=1.0)
    green = b.add_material(albedo=(0, 1, 0), roughness=1.0)
    white = b.add_material(albedo=(1, 1, 1), roughness=1.0)
    blue = b.add_material(albedo=(0, 0, 1), roughness=1.0)
    banana_tex = b.add_texture(load_image(_find_asset("bananaDiffuse.png")).astype(np.float32) / 255.0)
    banana_mat = b.add_material(roughness=1.0, metallic=0.0, albedo_map=banana_tex)
    toaster_tex = b.add_texture(load_image(_find_asset("toasterBaseColor.png")).astype(np.float32) / 255.0)
    toaster_mat = b.add_material(roughness=0.15, metallic=0.85, albedo_map=toaster_tex)

    b.add_mesh(*load_obj(_find_asset("banana.obj")), material=banana_mat, position=(0, -3, 0), rotation=(90, 0, 0))
    b.add_mesh(*load_obj(_find_asset("toaster.obj")), material=toaster_mat, position=(-1.9, -3.0, 0),
               scale=(0.5, 0.5, 0.5))

    # room: six separate one-face meshes on a unit cube with inward normals
    # (WalnutApp.cpp:209-243 vertex table; faces :245-484)
    P = np.float32  # noqa: N806 - terse local alias for the vertex table
    faces = {
        # name: (4 corner positions, inward normal, material)
        "bottom": ([(-.5, -.5, -.5), (.5, -.5, -.5), (.5, -.5, .5), (-.5, -.5, .5)], (0, 1, 0), white),
        "top": ([(-.5, .5, -.5), (.5, .5, -.5), (.5, .5, .5), (-.5, .5, .5)], (0, -1, 0), white),
        "front": ([(-.5, -.5, .5), (.5, -.5, .5), (.5, .5, .5), (-.5, .5, .5)], (0, 0, -1), red),
        "back": ([(-.5, -.5, -.5), (.5, -.5, -.5), (.5, .5, -.5), (-.5, .5, -.5)], (0, 0, 1), magenta),
        "left": ([(-.5, -.5, -.5), (-.5, -.5, .5), (-.5, .5, .5), (-.5, .5, -.5)], (1, 0, 0), blue),
        "right": ([(.5, -.5, -.5), (.5, -.5, .5), (.5, .5, .5), (.5, .5, -.5)], (-1, 0, 0), green),
    }
    # per-face triangle indices as authored (winding varies per face)
    tris = {
        "bottom": [(0, 1, 2), (0, 2, 3)],
        "top": [(0, 2, 1), (0, 3, 2)],
        "front": [(0, 1, 2), (0, 2, 3)],
        "back": [(0, 2, 1), (0, 3, 2)],
        "left": [(0, 1, 2), (0, 2, 3)],
        "right": [(0, 2, 1), (0, 3, 2)],
    }
    uv4 = np.float32([(0, 0), (1, 0), (1, 1), (0, 1)])
    for name, (corners, nrm, mat) in faces.items():
        b.add_mesh(P(corners), np.int32(tris[name]), normals=np.tile(P(nrm), (4, 1)), uvs=uv4, material=mat,
                   position=(0, -1, 0), scale=(7.5, 7.5, 7.5))

    # 5 ceiling light planes (i = -2..2), rotated 180° about X so the +Y
    # quad normal points down (WalnutApp.cpp:485-520)
    plane_p = P([(-.5, 0, -.5), (.5, 0, -.5), (.5, 0, .5), (-.5, 0, .5)])
    plane_t = np.int32([(0, 1, 2), (0, 2, 3)])
    plane_n = np.tile(P((0, 1, 0)), (4, 1))
    for i in range(-2, 3):
        b.add_mesh(plane_p, plane_t, normals=plane_n, uvs=uv4, material=emissive, position=(i * 1.5, 2.7499, 0),
                   rotation=(180, 0, 0))

    cam = Camera(position=(1.752, -0.845, -2.812), forward=(-0.6, -0.451, 0.661), vfov_deg=45.0,
                 width=width, height=height)
    return b, cam
