"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` into a
shared library with a plain C interface, then loaded with ``ctypes``.  The
library's file name carries a hash of every source in ``csrc/`` and of the
flags, so an edited ``.cu`` or ``.cuh`` rebuilds.  Libraries go to
``fypraytracer_tpu_torch/_build/``; a build writes a temporary file and
renames it, so concurrent first calls cannot load a half-written library.

Nothing here runs at import time: importing the package never needs nvcc.
A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from fypraytracer_tpu_torch.utils import profiling

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per source: restir_gi.cu fuses no product into a sum, so that its reservoir
# decisions round as its plain PyTorch version's do; megakernel_diff.cu
# neither, so that its loss and gradient round as its plain version's
EXTRA_FLAGS = {"restir_gi": ["-fmad=false"], "megakernel_diff": ["-fmad=false"]}

# per library: the loaded library, its C entries with their argtypes set, and
# the extra flags it was built with (a build with other flags, e.g.
# -DFYP_WALK_CHECKS for the walks' range checks in wide.cuh, is a library of
# its own, loaded in its place while EXTRA_FLAGS names them)
_libs: dict[str, tuple[ctypes.CDLL, dict, tuple]] = {}
# per library: {"path", "seconds" (0.0 when it was already built), "log"} of the
# build last made or loaded
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + repr(sorted(EXTRA_FLAGS.items())).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            h.update(fn.encode())
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists; returns
    the library path.  Raises on any compiler failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with profiling.setup_span("kernels.hash"):
        out = os.path.join(BUILD_DIR, f"lib{name}_{_source_hash()}.so")
    if os.path.exists(out):
        if build_info.get(name, {}).get("path") != out:     # the library last built or loaded
            log = ""
            if os.path.exists(out + ".log"):
                with open(out + ".log") as f:
                    log = f.read()
            build_info[name] = dict(path=out, seconds=0.0, log=log)
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    with profiling.setup_span("kernels.nvcc"):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).strip()
    with open(f"{tmp}.log", "w") as f:        # the compiler's report, for a later cached load
        f.write(log)
    os.replace(f"{tmp}.log", out + ".log")
    os.replace(tmp, out)
    build_info[name] = dict(path=out, seconds=time.perf_counter() - t0, log=log)
    return out


def load(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of library ``name`` with its argtypes set
    (every pointer and the stream must be ``c_void_p``); returns int.  The
    library is built and loaded (span ``kernels.load``), and the entry
    bound, once; the entry's first call in the process, where CUDA loads
    the library's module, is span ``kernels.first_launch``."""
    flags = tuple(EXTRA_FLAGS.get(name, ()))
    if name not in _libs or _libs[name][2] != flags:
        with profiling.setup_span("kernels.load"):
            path = build(name)
            with profiling.setup_span("kernels.dlopen"):
                _libs[name] = (ctypes.CDLL(path), {}, flags)
    lib, fns, _ = _libs[name]
    fn = fns.get(symbol)
    if fn is None:
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fn = fns[symbol] = _first_launch(fn, fns, symbol)
    return fn


def _first_launch(entry, fns: dict, symbol: str):
    """``entry`` behind a one-shot wrapper: its first call is span
    ``kernels.first_launch`` and puts the bare ``entry`` in ``fns`` for
    every later lookup, so later launches pay nothing for the span."""

    def first(*args):
        if fns.get(symbol) is entry:        # a caller that kept the wrapper
            return entry(*args)
        with profiling.setup_span("kernels.first_launch"):
            rc = entry(*args)
        fns[symbol] = entry
        return rc

    first.argtypes = entry.argtypes
    return first


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (its ``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_inputs(name: str, floats=(), ints=()) -> None:
    """Raise unless every tensor lies on one CUDA device, is contiguous and
    is float32 (``floats``) or int32 (``ints``)."""
    dev = (floats or ints)[0].device
    for ts, dtype in ((floats, torch.float32), (ints, torch.int32)):
        for t in ts:
            if t.device != dev or t.device.type != "cuda":
                raise ValueError(f"{name}: every input must be on one CUDA device, got {t.device}")
            if not t.is_contiguous() or t.dtype != dtype:
                raise ValueError(f"{name}: inputs must be contiguous {dtype}, got {t.dtype}")


# the libraries whose sources include csrc/shading.cuh, each with the test
# entry fyp_camera_rays
CAMERA_LIBS = ("megakernel", "restir_di", "restir_gi", "megakernel_diff")


def camera_rays(name: str, cam: torch.Tensor, width: int, height: int, pix0: int = 0,
                n_pix: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The (n_pix, 3) origins and directions that ``shading.cuh::camera_ray``
    gives pixels ``pix0 .. pix0 + n_pix - 1`` in library ``name``, built
    with that library's flags: the test entry that holds the kernels' rays
    against ``core/camera.py::generate_rays``.  ``cam`` is the (2, 4, 4)
    float32 inverse projection and view on a CUDA device."""
    n_pix = width * height - pix0 if n_pix is None else n_pix
    check_inputs("camera_rays", floats=(cam,))
    fn = load(name, "fyp_camera_rays", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    orig, dirs = (torch.empty((n_pix, 3), dtype=torch.float32, device=cam.device) for _ in range(2))
    check(fn(ptr(cam), width, height, pix0, n_pix, ptr(orig), ptr(dirs), stream_ptr(cam.device)), "camera_rays")
    return orig, dirs


def math_ops(name: str, x: torch.Tensor) -> torch.Tensor:
    """The (4, n) rows ``powf(x, 5)``, ``cosf(x)``, ``sinf(x)``, ``sqrtf(x)``
    of the device library, as library ``name`` is built (one of
    ``CAMERA_LIBS``): the test entry that holds the functions the shading
    code calls against PyTorch's on the same inputs."""
    check_inputs("math_ops", floats=(x,))
    fn = load(name, "fyp_math_ops", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    out = torch.empty((4, x.numel()), dtype=torch.float32, device=x.device)
    check(fn(ptr(x), x.numel(), ptr(out), stream_ptr(x.device)), "math_ops")
    return out
