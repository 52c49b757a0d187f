"""Megakernel renderer: N frames per pixel in one kernel launch.

The torch counterpart of ``fypraytracer_tpu/render/megakernel.py``'s
``MegakernelRenderer`` for every entry of its ``SAMPLER_OF`` (:2566):
brute force, uniform, cosine, GGX, BRDF, light-source sampling and NEE+MIS.
``megakernel`` wraps the hand-written CUDA kernel ``csrc/megakernel.cu``,
which replaces the TPU kernel ``make_megakernel`` (megakernel.py:1788,
launched at :2404): ``k2_lanes`` threads a pixel (up to four) each trace
the primary hit and run every lanes-th frame's paths, every ray walking
the scene's wide BVH (``Scene.wide``) alone, and add their sums.
Every sampler is also built textured: a scene whose materials map an
albedo launches that instantiation with the scene's kernel levels
(``Scene.tex``: mip 0 box-filtered to at most 256², and the bounce level),
which the scene builders make with the scene.

It takes a pixel slab (``pix0``, ``n_pix``), the TPU kernel's chunk
entry (:2372-2420): ``parallel/shard.py::sharded_megakernel_render`` gives
each rank its slab, and slabs join into the whole image bit for bit.

``megakernel_plain`` is its plain PyTorch version: the sum of ``n_frames``
frames of the matching wavefront integrator (``renderer.pixels_hdr``) with
the plain BVH walk.  The wrapper takes it for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  ``megakernel.launches`` counts
kernel launches.  A launch is prepared once (``PreparedK2``: the checked
inputs, the emission table, the walk records, the texture arguments and
the C entries' argument block) and kept by a ``K2Launcher`` while the
scene object, the settings' values, the lane count, the slab and the
camera's size stay as they were; ``MegakernelRenderer`` and
``sharded_megakernel_render`` keep one, and a call then uploads the
camera's matrices if they changed and makes one short C call.

The TPU kernel's packed tables (``P``/``AT``/``L``), frames-in-sublanes and
dispatch planning exist for the TPU and are not carried over: the kernel
reads the scene's SoA tensors directly.  ``morton_permuted_scene`` is kept
as a host function: the JAX megakernels render with the triangles in that
order, and exact t-ties go to the lowest id, so a caller that wants the
JAX megakernel's images hands the port the same numbering.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from fypraytracer_tpu_torch.accel.morton import morton3d
from fypraytracer_tpu_torch.accel.wide import build_wide
from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.core.camera import Camera
from fypraytracer_tpu_torch.ops import kernels
from fypraytracer_tpu_torch.ops.texture import check_scene_tex, tex_args, with_kernel_atlas
from fypraytracer_tpu_torch.ops.traverse import OverflowWatch, stack_depth, trace_rays, wide_records
from fypraytracer_tpu_torch.render.renderer import pixels_hdr
from fypraytracer_tpu_torch.render.restir_common import BLOCK_SMEM
from fypraytracer_tpu_torch.scene.types import Scene
from fypraytracer_tpu_torch.utils import profiling

# megakernel.py:2566; the int is csrc/megakernel.cu's Sampler
SAMPLER_OF = {
    SamplingTechnique.BRUTE_FORCE: "uniform",
    SamplingTechnique.UNIFORM: "uniform",
    SamplingTechnique.COSINE: "cosine",
    SamplingTechnique.GGX: "ggx",
    SamplingTechnique.BRDF: "brdf",
    SamplingTechnique.LIGHT_SOURCE: "light",
    SamplingTechnique.NEE_MIS: "nee",
}
_SAMPLER_ID = {"uniform": 0, "cosine": 1, "ggx": 2, "brdf": 3, "light": 4, "nee": 5}
# csrc/megakernel.cu: a block of K2_BLOCK threads holds their walks' stacks
# (8 bytes an entry) and each thread's kept primary surface and view
# (KeptSurf, 14 floats) in its shared memory, so a stack holds at most
# K2_MAX_STACK entries (220)
K2_BLOCK = 128
K2_MAX_STACK = (BLOCK_SMEM - 4 * K2_BLOCK * 14) // (8 * K2_BLOCK)


def k2_walk_records(scene: Scene):
    """The scene's wide BVH for K2 (``wide_records``), refused with the
    reason where a block's stacks would not fit beside its kept surfaces."""
    if scene.wide is not None and scene.wide.stack_need > K2_MAX_STACK:
        raise ValueError(f"megakernel: the wide BVH needs a stack of {scene.wide.stack_need} entries a thread, "
                         f"and a block of {K2_BLOCK} threads holds {K2_MAX_STACK} beside its kept surfaces")
    return wide_records(scene)


def k2_lanes(n_frames: int) -> int:
    """K2's threads a pixel (csrc/megakernel.cu), each with its share of
    the frames: four, or for a launch of fewer frames 2 or 1, so that no
    lane idles.  Measured so at every size on an H100, again after K2's
    one-walk-site redesign (chip_smoke.py's k2_walks, PERF.md): at Cornell
    1920x1088, 8 frames, four lanes beat one and two, and at one frame one
    lane beats four by 2.9x."""
    return 4 if n_frames >= 4 else 2 if n_frames >= 2 else 1


@profiling.setup_spanned("scene.morton")
def morton_permuted_scene(scene: Scene):
    """Host scene with its triangles reordered along the Z-order curve of
    their centroids, every triangle-id field remapped (megakernel.py:
    271-314); returns ``(scene', perm)``.  ``scene`` holds NumPy arrays (or
    CPU tensors), as ``SceneBuilder.compile`` returns it."""
    g = scene.geometry
    tv = np.asarray(g.tri_v)
    if tv.shape[0] == 0:
        return scene, np.zeros((0,), np.int64)
    pos = np.asarray(g.positions)
    cent = (pos[tv[:, 0]] + pos[tv[:, 1]] + pos[tv[:, 2]]) / 3.0
    code = morton3d(cent, lo=cent.min(axis=0), hi=cent.max(axis=0) + 1e-6)
    perm = np.argsort(code, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])

    def remap(ids):
        ids = np.asarray(ids)
        return np.where(ids >= 0, inv[np.maximum(ids, 0)], -1).astype(np.int32)

    lt = scene.light_tree
    new_lt = dataclasses.replace(lt, tri=remap(lt.tri), leaf_of_tri=np.asarray(lt.leaf_of_tri)[perm])
    new_g = dataclasses.replace(g, tri_v=tv[perm], tri_mat=np.asarray(g.tri_mat)[perm])
    new_bvh = dataclasses.replace(scene.bvh, prim_idx=remap(scene.bvh.prim_idx))
    new_scene = dataclasses.replace(scene, geometry=new_g, light_tree=new_lt, bvh=new_bvh,
                                    emissive_tris=remap(scene.emissive_tris),
                                    wide=build_wide(new_bvh, new_g))
    return new_scene, perm


def _sampler(settings: RenderSettings) -> str:
    tech = SamplingTechnique(settings.technique)
    if tech not in SAMPLER_OF:
        raise NotImplementedError(
            f"MegakernelRenderer renders techniques 0-6, not {tech.name}; ReSTIR DI is "
            "render.megakernel_restir.MegakernelReSTIRDI, ReSTIR GI "
            "render.megakernel_restir_gi.MegakernelReSTIRGI")
    return SAMPLER_OF[tech]


def slab(camera: Camera, pix0: int, n_pix: int | None) -> int:
    """The pixel count of the slab that starts at ``pix0`` (all the pixels
    after it when ``n_pix`` is None); raises unless it lies in the image."""
    total = camera.width * camera.height
    n_pix = total - pix0 if n_pix is None else n_pix
    if pix0 < 0 or n_pix < 0 or pix0 + n_pix > total:
        raise ValueError(f"megakernel: the slab of {n_pix} pixels at {pix0} leaves the {total}-pixel image")
    return n_pix


def megakernel_plain(scene: Scene, camera: Camera, frame0: int, n_frames: int,
                     settings: RenderSettings, pix0: int = 0, n_pix: int | None = None) -> torch.Tensor:
    """(n_pix, 3) HDR of the pixels ``pix0 .. pix0+n_pix-1`` (by default the
    whole image, (H*W, 3)) summed over frames ``frame0 ..
    frame0+n_frames-1``: the wavefront frame of ``settings.technique`` at
    those pixels with the plain BVH walk, in PyTorch, reading the kernel's
    texture levels (``with_kernel_atlas``; where every texture is at most
    256 a side they are the wavefront's)."""
    _sampler(settings)
    n_pix = slab(camera, pix0, n_pix)
    scene = with_kernel_atlas(scene)

    def trace(o, d):
        return trace_rays(scene.bvh, scene.geometry, o, d)["tri"]

    dev = scene.geometry.positions.device
    pixel_ids = torch.arange(pix0, pix0 + n_pix, device=dev)
    out = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    for f in range(n_frames):
        out = out + pixels_hdr(scene, camera, frame0 + f, settings, pixel_ids, trace_fn=trace)
    return out


_PREPARE_ARGTYPES = (
    [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_float] * 3
    + [ctypes.c_void_p] * 5          # geometry
    + [ctypes.c_void_p] * 5          # materials
    + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5         # texture
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]                # wide bvh
    + [ctypes.c_void_p] * 13 + [ctypes.c_int]               # light tree
    + [ctypes.c_void_p])             # the packed block
_LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _runs_plain(scene: Scene) -> bool:
    """Whether K2's calls on ``scene`` take the plain version: CPU tensors."""
    return scene.geometry.positions.device.type == "cpu"


def megakernel(scene: Scene, camera: Camera, frame0: int, n_frames: int,
               settings: RenderSettings, lanes: int | None = None, pix0: int = 0,
               n_pix: int | None = None, launcher: "K2Launcher | None" = None) -> torch.Tensor:
    """(n_pix, 3) HDR of the pixel slab ``pix0 .. pix0+n_pix-1`` (by default
    the whole image, (H*W, 3)) summed over ``n_frames`` frames of
    ``settings.technique`` starting at ``frame0``, through the CUDA kernel
    ``csrc/megakernel.cu`` with ``lanes`` threads a pixel (1, 2 or 4; by
    default ``k2_lanes``) (plain version for CPU tensors).  A slab's pixels
    are the same bits as the whole image's (the JAX kernel's chunk entry,
    ``pix0``).  A textured scene launches the textured instantiation with
    the levels of ``Scene.tex``.  ``launcher`` keeps the launch prepared
    for the next call (``K2Launcher``); without it the launch is prepared
    for this call alone."""
    _sampler(settings)
    n_pix = slab(camera, pix0, n_pix)
    if _runs_plain(scene):
        return megakernel_plain(scene, camera, frame0, n_frames, settings, pix0, n_pix)
    if lanes is None:
        lanes = k2_lanes(n_frames)
    if lanes not in (1, 2, 4):
        raise ValueError(f"megakernel: lanes must be 1, 2 or 4, got {lanes}")
    launcher = K2Launcher() if launcher is None else launcher
    out = launcher(scene, camera, frame0, n_frames, settings, lanes, pix0, n_pix)
    megakernel.launches += 1
    return out


megakernel.launches = 0


class PreparedK2:
    """One K2 launch with everything but its frames and output fixed.

    It holds the checked inputs (``check_inputs`` runs here, once), the
    emission table, the walk records and their stack depth, the texture
    arguments, the loaded C entries, and the argument block that
    ``fyp_megakernel_prepare`` packs from them: every pointer and int of a
    launch but its first frame, frame count, output and stream.  The block
    points at ``cam``, the (2, 4, 4) device tensor that holds the camera's
    inverse projection and view (``K2Launcher.set_camera``).  A launch
    then passes the block, its frames, its output and the stream
    (``_launch``).  What the kernel is given is what one call with every
    argument gave it."""

    def __init__(self, scene: Scene, cam: torch.Tensor, camera: Camera, settings: RenderSettings, lanes: int,
                 pix0: int, n_pix: int):
        g, m, lt, tex = scene.geometry, scene.materials, scene.light_tree, scene.tex
        wide = k2_walk_records(scene)
        self.scene, self.settings, self.lanes, self.pix0, self.n_pix = scene, settings, lanes, pix0, n_pix
        self.size = (camera.width, camera.height)
        self.sampler = _SAMPLER_ID[_sampler(settings)]
        self.device = g.positions.device
        self.cam = cam
        self.emission = m.emission().contiguous()
        kernels.check_inputs(
            "megakernel",
            floats=(self.cam, g.positions, g.normals, g.uvs, m.albedo, m.roughness, m.metallic, self.emission,
                    wide.nodes, wide.tris, lt.energy, lt.axis, *lt.cone_trig, lt.box_lo, lt.box_hi)
            + (() if tex is None else (tex.prim, tex.bounce)),
            ints=(g.tri_v, g.tri_mat, m.albedo_map, wide.overflow, lt.left, lt.right, lt.tri, lt.parent,
                  lt.leaf_of_tri))
        # brute force traces exactly 1 path a frame whatever the sample count
        # (megakernel.py:2603, Renderer.cu:565-701)
        samples = 1 if settings.technique == SamplingTechnique.BRUTE_FORCE else settings.samples
        n_bytes = kernels.load("megakernel", "fyp_megakernel_prepared_bytes", [])()
        self.block = (ctypes.c_uint64 * -(-n_bytes // 8))()          # 8-byte aligned, as the block's pointers
        self.block_ptr = ctypes.c_void_p(ctypes.addressof(self.block))
        P = kernels.ptr
        pack = kernels.load("megakernel", "fyp_megakernel_prepare", _PREPARE_ARGTYPES)
        kernels.check(pack(self.sampler, lanes, P(self.cam), camera.width, camera.height, pix0, n_pix,
                           settings.bounces, samples, *(float(c) for c in settings.sky_color),
                           P(g.positions), P(g.normals), P(g.tri_v), P(g.tri_mat), P(g.uvs),
                           P(m.albedo), P(m.roughness), P(m.metallic), P(self.emission), P(m.albedo_map),
                           *tex_args(tex),
                           P(wide.nodes), P(wide.tris), P(wide.overflow), stack_depth(wide),
                           P(lt.energy), P(lt.axis), *map(P, lt.cone_trig), P(lt.box_lo), P(lt.box_hi),
                           P(lt.left), P(lt.right), P(lt.tri), P(lt.parent), P(lt.leaf_of_tri), lt.max_depth,
                           self.block_ptr), "megakernel")
        self.fn = kernels.load("megakernel", "fyp_megakernel_launch", _LAUNCH_ARGTYPES)

    def fits(self, scene: Scene, camera: Camera, settings: RenderSettings, lanes: int, pix0: int,
             n_pix: int) -> bool:
        """Whether this launch renders ``scene``'s slab with ``settings``'
        values and ``lanes`` threads a pixel, for a camera of its size."""
        return (scene is self.scene and (settings is self.settings or settings == self.settings)
                and lanes == self.lanes and pix0 == self.pix0 and n_pix == self.n_pix
                and (camera.width, camera.height) == self.size)


class K2Launcher:
    """K2's launches, each prepared (``PreparedK2``) only when the last
    prepared one does not fit: another scene object (``set_scene``), other
    settings values, lane count or slab, or a camera of another size.  A
    call then uploads the camera's matrices into the launcher's one camera
    tensor if they changed, takes an output and makes one short C call.
    ``builds`` and ``camera_uploads`` count both.  Spans ``k2.prepare``
    (all before the C call) and ``k2.launch`` (``_launch``) while tracing
    is on."""

    def __init__(self):
        self.prepared: PreparedK2 | None = None
        self.cam: torch.Tensor | None = None        # the camera's matrices on the device
        self.cam_values = None                      # their bytes at the last upload
        self.builds = 0
        self.camera_uploads = 0

    def __call__(self, scene: Scene, camera: Camera, frame0: int, n_frames: int, settings: RenderSettings,
                 lanes: int, pix0: int, n_pix: int) -> torch.Tensor:
        with profiling.span("k2.prepare"):
            prep = self.prepared
            if prep is None or not prep.fits(scene, camera, settings, lanes, pix0, n_pix):
                dev = scene.geometry.positions.device
                if self.cam is None or self.cam.device != dev:
                    self.cam = torch.empty((2, 4, 4), dtype=torch.float32, device=dev)
                    self.cam_values = None
                prep = self.prepared = PreparedK2(scene, self.cam, camera, settings, lanes, pix0, n_pix)
                self.builds += 1
            self.camera_uploads += self.set_camera(camera)
            out = torch.empty((n_pix, 3), dtype=torch.float32, device=prep.device)
            stream = kernels.stream_ptr(prep.device)
        _launch(prep, frame0, n_frames, out, stream)
        return out

    def set_camera(self, camera: Camera) -> bool:
        """Upload the camera's inverse projection and view where their 32
        floats differ from the last upload's (``Camera`` is mutable, so
        its values are compared, not the object), through pinned memory
        on a card, behind the launches queued before; whether it did."""
        values = camera.inv_projection.tobytes() + camera.inv_view.tobytes()
        if values == self.cam_values:
            return False
        host = torch.from_numpy(np.stack([camera.inv_projection, camera.inv_view]).astype(np.float32))
        self.cam.copy_(host.pin_memory() if self.cam.is_cuda else host, non_blocking=True)
        self.cam_values = values
        return True


def _launch(prep: PreparedK2, frame0: int, n_frames: int, out: torch.Tensor, stream) -> None:
    """Launch ``prep`` over ``n_frames`` frames from ``frame0`` into
    ``out`` on ``stream``: the C call and its rc check, span
    ``k2.launch``."""
    with profiling.span("k2.launch"):
        kernels.check(prep.fn(prep.block_ptr, int(frame0) & 0xFFFFFFFF, n_frames, out.data_ptr(), stream),
                      "megakernel")


class MegakernelRenderer:
    """N frames of techniques 0-6 per launch, accumulated on the device.

    Usage::
        mk = MegakernelRenderer(scene, camera, settings, device="cuda")
        avg_hdr = mk.render_many(64)   # one kernel launch
    """

    def __init__(self, scene: Scene, camera: Camera, settings: RenderSettings, device="cuda"):
        _sampler(settings)
        self.device = torch.device(device)
        self.camera = camera
        self.settings = settings
        self.accum = torch.zeros((camera.height * camera.width, 3), dtype=torch.float32,
                                 device=self.device)
        self.k2 = K2Launcher()
        self.set_scene(scene)

    def set_scene(self, scene: Scene):
        """Render ``scene`` from now on (``SceneManager.apply``): on the
        device, with a new overflow watch and K2's launch prepared anew;
        accumulation restarts."""
        self.scene = scene.to(self.device)
        self.overflow = OverflowWatch(self.scene)
        check_scene_tex(self.scene)
        self.k2.prepared = None
        self.reset()

    @property
    def prepared_builds(self) -> int:
        """K2 launches prepared so far (``K2Launcher.builds``)."""
        return self.k2.builds

    @property
    def camera_uploads(self) -> int:
        """Uploads of the camera's matrices so far (``K2Launcher``)."""
        return self.k2.camera_uploads

    def reset(self):
        self.frame_index = 1
        self.accum.zero_()

    def render_many(self, n_frames: int) -> torch.Tensor:
        """Add ``n_frames`` frames to the accumulator; return the running
        average HDR image (H, W, 3).  K2's launch is prepared once and kept
        while it fits (``K2Launcher``).  Spans ``mk.call``, and in it
        ``mk.poll``, K2's ``k2.prepare`` and ``k2.launch`` (on a card) and
        ``mk.accumulate``, while tracing is on."""
        with profiling.span("mk.call"):
            with profiling.span("mk.poll"):
                self.overflow.poll()
            frames = megakernel(self.scene, self.camera, self.frame_index, n_frames, self.settings,
                                launcher=self.k2)
            with profiling.span("mk.accumulate"):
                self.accum += frames
                del frames          # freed before the average is allocated: one image less at the peak
                self.overflow.queue()
                self.frame_index += n_frames
                h, w = self.camera.height, self.camera.width
                return (self.accum / float(self.frame_index - 1)).reshape(h, w, 3)
