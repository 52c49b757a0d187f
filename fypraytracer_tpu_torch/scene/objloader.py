"""Wavefront OBJ loader — replaces the reference's Assimp import path.

A copy of ``fypraytracer_tpu/scene/objloader.py`` (pure NumPy).

Semantics follow ``Mesh::GenerateMesh`` (Mesh.cpp:271-314) and its Assimp
flags: triangulate (polygon fans), smooth normals when absent
(aiProcess_GenSmoothNormals), flipped V texture coordinate
(aiProcess_FlipUVs), and the left-handed conversion with the explicit
z-flip (aiProcess_ConvertToLeftHanded + Mesh.cpp:299-304) — implemented
here as z-negation with winding reversal to keep outward normals.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str, flip_z: bool = True, flip_v: bool = True):
    """Parse an OBJ file.

    Returns ``(positions (V,3) f32, tri_v (T,3) i32, normals (V,3) f32 or
    None, uvs (V,2) f32 or None)`` with per-face vertex data deduplicated
    into a single index space (OBJ's independent v/vt/vn indices are
    re-welded per unique triple, as Assimp does).
    """
    raw_v: list = []
    raw_vt: list = []
    raw_vn: list = []
    faces: list = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                raw_v.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                vals = [float(x) for x in line.split()[1:3]]
                raw_vt.append(vals + [0.0] * (2 - len(vals)))
            elif line.startswith("vn "):
                raw_vn.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                corners = []
                for tok in line.split()[1:]:
                    parts = tok.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    corners.append((vi, ti, ni))
                # triangulate as a fan (aiProcess_Triangulate)
                for k in range(1, len(corners) - 1):
                    faces.append((corners[0], corners[k], corners[k + 1]))

    nv, nt, nn = len(raw_v), len(raw_vt), len(raw_vn)

    def resolve(idx: int, n: int) -> int:
        return idx - 1 if idx > 0 else n + idx  # negative = relative

    weld: dict = {}
    positions, uvs, normals = [], [], []
    tri_v = []
    has_uv = nt > 0
    has_n = nn > 0
    for tri in faces:
        ids = []
        for (vi, ti, ni) in tri:
            key = (vi, ti, ni)
            if key not in weld:
                weld[key] = len(positions)
                positions.append(raw_v[resolve(vi, nv)])
                if has_uv:
                    uvs.append(raw_vt[resolve(ti, nt)] if ti else [0.0, 0.0])
                if has_n:
                    normals.append(raw_vn[resolve(ni, nn)] if ni else [0.0, 0.0, 1.0])
            ids.append(weld[key])
        tri_v.append(ids)

    positions = np.asarray(positions, np.float32)
    tri_v = np.asarray(tri_v, np.int32)
    normals_arr = np.asarray(normals, np.float32) if has_n else None
    uvs_arr = np.asarray(uvs, np.float32) if has_uv else None

    if flip_v and uvs_arr is not None:
        uvs_arr = uvs_arr.copy()
        uvs_arr[:, 1] = 1.0 - uvs_arr[:, 1]  # aiProcess_FlipUVs

    if flip_z:
        positions = positions.copy()
        positions[:, 2] *= -1.0  # Mesh.cpp:299-304 left-handed conversion
        if normals_arr is not None:
            normals_arr = normals_arr.copy()
            normals_arr[:, 2] *= -1.0
        tri_v = tri_v[:, ::-1].copy()  # reverse winding to keep orientation

    return positions, tri_v, normals_arr, uvs_arr
