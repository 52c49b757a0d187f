"""ctypes binding of the C++ structure builders (``native/builders.cpp``).

The torch counterpart of ``fypraytracer_tpu/accel/native.py``, with the
same C entries and argtypes (:32-62): the two-level binned-SAH BVH, the
SAOH light tree and the PNG scanline unfilter, the roles the reference's
C++/OpenMP builders play (BVH.cpp, LightTree.cpp).  They are host code and
a build-throughput optimization: the BVH's topology differs from the
NumPy builder's (``accel/bvh.py``) by design, its closest hits do not, and
the light tree's pick distribution matches ``accel/lighttree.py``'s.

The library is compiled on first use with ``g++ -O3 -shared -fPIC`` into
``fypraytracer_tpu_torch/_build/``, its file name hashed over the source,
the flags and the compiler's version and target (a library built on
another machine is not taken), through a temporary file that is renamed
into place, so concurrent first calls cannot load a half-written library.
Nothing is written under ``native/``.  Every entry returns None when g++
or the library is missing or a build fails, and the scene compiler then
falls back to the NumPy builders, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from fypraytracer_tpu_torch.scene.types import FlatBVH, LightTreeArrays
from fypraytracer_tpu_torch.utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG), "native", "builders.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-O3", "-shared", "-fPIC"]

_LIB = None
_LIB_FAILED = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    return gxx


@functools.lru_cache(maxsize=None)
def _compiler_id(gxx: str) -> str:
    """g++'s version and target triple."""
    proc = subprocess.run([gxx, "-dumpfullversion", "-dumpmachine"], capture_output=True, text=True, timeout=60)
    return proc.stdout.strip()


def library_path() -> str:
    """Where the library of the current source, flags and compiler is built.
    Raises if g++ is missing."""
    h = hashlib.sha256(" ".join(FLAGS).encode() + _compiler_id(_gxx()).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libbuilders_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``native/builders.cpp`` unless its hashed library exists;
    returns the library path.  Raises if g++ is missing or fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    gxx = _gxx()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *FLAGS, "-o", tmp, SRC], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC} (rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    try:
        with profiling.setup_span("native.load"):     # the g++ build, where there is none, and the load
            lib = ctypes.CDLL(build())
        lib.build_scene_bvh.restype = ctypes.c_int
        lib.build_scene_bvh.argtypes = [
            _f32p, _f32p, ctypes.c_int64, _i64p, ctypes.c_int, ctypes.c_int,
            _f32p, _f32p, _i32p, _i32p, _i32p, _i32p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.build_light_tree.restype = ctypes.c_int
        lib.build_light_tree.argtypes = [
            _f32p, _i32p, ctypes.c_int64, _f32p, _i64p, ctypes.c_int,
            _f32p, _f32p, _f32p, _f32p, _f32p, _f32p,
            _i32p, _i32p, _i32p, _i32p, _i32p,
            ctypes.POINTER(ctypes.c_int64)]
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [_u8p, _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        _LIB = lib
    except Exception:
        _LIB_FAILED = True
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def build_scene_bvh_native(tri_lo, tri_hi, mesh_tri_ranges, leaf_size=4):
    """Native two-level BVH; returns a ``FlatBVH`` or None on failure."""
    lib = _load()
    if lib is None:
        return None
    n_tris = len(tri_lo)
    n_meshes = len(mesh_tri_ranges)
    if n_tris == 0:
        return None
    ranges = np.asarray(mesh_tri_ranges, np.int64).reshape(-1)
    max_nodes = 2 * n_tris + 2 * n_meshes + 2
    max_slots = (n_tris + n_meshes + 1) * leaf_size

    lo = np.empty((max_nodes, 3), np.float32)
    hi = np.empty((max_nodes, 3), np.float32)
    miss = np.empty(max_nodes, np.int32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    prim_idx = np.empty(max_slots, np.int32)
    n_nodes = ctypes.c_int64()
    n_slots = ctypes.c_int64()

    rc = lib.build_scene_bvh(
        np.ascontiguousarray(tri_lo, np.float32), np.ascontiguousarray(tri_hi, np.float32),
        n_tris, ranges, n_meshes, leaf_size,
        lo.reshape(-1), hi.reshape(-1), miss, first, count, prim_idx,
        ctypes.byref(n_nodes), ctypes.byref(n_slots))
    if rc != 0:
        return None
    n = n_nodes.value
    return FlatBVH(lo=lo[:n].copy(), hi=hi[:n].copy(), miss=miss[:n].copy(),
                   first=first[:n].copy(), count=count[:n].copy(),
                   prim_idx=prim_idx[:n_slots.value].copy(), leaf_size=leaf_size)


def png_unfilter_native(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray | None:
    """Reconstruct PNG scanlines from the inflated IDAT stream
    (``builders.cpp::png_unfilter``); returns (height*stride,) uint8 or None."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(height * stride, np.uint8)
    rc = lib.png_unfilter(np.ascontiguousarray(raw, np.uint8), out, height, stride, bpp)
    return out if rc == 0 else None


def build_light_tree_native(positions, tri_v, tri_mat, emission_per_mat, mesh_tri_ranges):
    """Native SAOH light tree; returns ``LightTreeArrays`` or None."""
    lib = _load()
    if lib is None:
        return None
    n_tris = len(tri_v)
    emission_per_tri = emission_per_mat[tri_mat]
    norm = np.linalg.norm(emission_per_tri, axis=-1).astype(np.float32)
    n_emissive = int((norm > 0).sum())
    if n_emissive == 0:
        return None
    ranges = np.asarray(mesh_tri_ranges, np.int64).reshape(-1)
    max_nodes = 2 * n_emissive + 2 * len(mesh_tri_ranges) + 2

    energy = np.empty(max_nodes, np.float32)
    axis = np.empty((max_nodes, 3), np.float32)
    theta_o = np.empty(max_nodes, np.float32)
    theta_e = np.empty(max_nodes, np.float32)
    box_lo = np.empty((max_nodes, 3), np.float32)
    box_hi = np.empty((max_nodes, 3), np.float32)
    left = np.empty(max_nodes, np.int32)
    right = np.empty(max_nodes, np.int32)
    tri = np.empty(max_nodes, np.int32)
    parent = np.empty(max_nodes, np.int32)
    leaf_of_tri = np.empty(n_tris, np.int32)
    n_nodes = ctypes.c_int64()

    depth = lib.build_light_tree(
        np.ascontiguousarray(positions, np.float32).reshape(-1),
        np.ascontiguousarray(tri_v, np.int32).reshape(-1),
        n_tris, norm, ranges, len(mesh_tri_ranges),
        energy, axis.reshape(-1), theta_o, theta_e, box_lo.reshape(-1), box_hi.reshape(-1),
        left, right, tri, parent, leaf_of_tri, ctypes.byref(n_nodes))
    if depth <= 0:
        return None
    n = n_nodes.value
    return LightTreeArrays(
        energy=energy[:n].copy(), axis=axis[:n].copy(), theta_o=theta_o[:n].copy(),
        theta_e=theta_e[:n].copy(), box_lo=box_lo[:n].copy(), box_hi=box_hi[:n].copy(),
        left=left[:n].copy(), right=right[:n].copy(), tri=tri[:n].copy(),
        parent=parent[:n].copy(), leaf_of_tri=leaf_of_tri.copy(), max_depth=int(depth))
