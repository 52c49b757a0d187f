"""ReSTIR DI megakernel renderer: two kernels per frame, state on the device.

The torch counterpart of ``fypraytracer_tpu/render/megakernel_restir.py``
(``MegakernelReSTIRDI``, the reference's two-kernel split, Renderer.cu:
166-224).  Each frame is two hand-written CUDA kernels from
``csrc/restir_di.cu``, launched by the host on PyTorch's current stream
with no synchronisation between them:

  * K3 ``restir_di_k3`` replaces the TPU kernel ``k1`` (:243, launched at
    :678): primary hit, M candidates uniform over the emissive list with
    p̂ at the emitter's centroid, temporal reuse through the tile-shared
    reprojection offset; it writes the stage buffer.  Its primary ray walks
    the scene's wide BVH (``Scene.wide``, one thread a ray), and each tile
    runs as one block, or split over a cluster of blocks of 128 threads
    where the tiles are too few to fill the card
    (``restir_common.tile_clustered``);
  * K4 ``restir_di_k4`` replaces ``k2`` (:417, launched at :718): spatial
    reuse over frame-shared neighbour offsets, a shadow ray to a random
    point on the chosen emitter through the wide BVH, the shade by W; it
    adds the frame to the output and writes the per-pixel state.  It runs
    every frame in blocks of 128 threads, ``C / 128`` a tile and no
    cluster (it sums nothing over a tile).

The semantics are the megakernel's, not the wavefront's
(``render/restir_di.py``): pixels are linear and a tile is
``pick_ray_lanes(B)`` consecutive pixels; the tile reads the previous state
at one rounded mean offset and a pixel keeps history only where that read
is its exact reprojected pixel; the spatial offsets are shared by all
pixels of a frame and a neighbour counts only where the tile's read is
unclamped and in the image; normals are not octahedral-quantized.  The
stage and state are (rows, B) float32 tensors whose rows are the ``S_*``
and ``ST_*`` constants (the same numbers as in ``csrc/restir_di.cu``).
Tiles, reprojection, neighbour offsets and the launch helpers are
``render/restir_common.py``'s, shared with ReSTIR GI.

A scene whose materials map an albedo launches K3's textured
instantiation, which fetches the primary hit's albedo from the kernel's
primary level (``Scene.tex``); K4 shades with the albedo K3
staged.

``restir_di_k3_plain``/``restir_di_k4_plain`` are the kernels' plain
PyTorch versions on whole images (the tile mean as ``(G, C)``
reductions, neighbour reads as index arithmetic with the same clamp);
``restir_di_megakernel_plain`` is the frame loop over them.  The wrappers
take the plain versions for CPU tensors only; for CUDA tensors they
launch the kernel or raise.  ``restir_di_k3.launches`` and
``restir_di_k4.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from fypraytracer_tpu_torch.config import RenderSettings
from fypraytracer_tpu_torch.core import rng
from fypraytracer_tpu_torch.core.camera import Camera
from fypraytracer_tpu_torch.core.mathutils import cook_torrance_brdf, cross3, dot3, normalize
from fypraytracer_tpu_torch.ops import kernels
from fypraytracer_tpu_torch.ops.texture import check_scene_tex, tex_args, with_kernel_atlas
from fypraytracer_tpu_torch.ops.traverse import OverflowWatch, trace_rays
from fypraytracer_tpu_torch.render.restir_common import (
    TILE_BLOCK,
    camera_matrices,
    camera_rays,
    hit_surface,
    pick_ray_lanes,
    pick_tile_launch,
    spatial_offsets,
    tile_history_index,
    tile_walk_records,
    wide_args,
)
from fypraytracer_tpu_torch.render.restir_di import _finalize_w, reservoir_update
from fypraytracer_tpu_torch.scene.types import Scene

# stage rows (K3 -> K4)
S_POS, S_NRM, S_ALB = 0, 3, 6          # 3 rows each
S_ROUGH, S_METAL, S_T, S_SHADE = 9, 10, 11, 12
S_EMIT = 13                            # 3 rows
S_HIT = 16
S_RIDX, S_RW, S_RPDF, S_RWSUM, S_RM = 17, 18, 19, 20, 21
S_ROWS = 22
# state rows (K4 -> the next frame's K3)
ST_RIDX, ST_RW, ST_RPDF, ST_RWSUM, ST_RM = 0, 1, 2, 3, 4
ST_NRM = 5                             # 3 rows
ST_T = 8
ST_ROWS = 9
# reservoir fields, in the row order of S_RIDX..S_RM and ST_RIDX..ST_RM
RES_FIELDS = ("index", "w", "pdf", "wsum", "m")

_NORMAL_TEMPORAL = 0.99    # Renderer.cu:1772
_NORMAL_SPATIAL = 0.906    # Renderer.cu:1935


@dataclasses.dataclass(frozen=True)
class EmissiveTable:
    """Per emissive triangle, in ``scene.emissive_tris`` order (SoA)."""

    p0: torch.Tensor        # (E, 3)
    e1: torch.Tensor        # (E, 3) p1 - p0
    e2: torch.Tensor        # (E, 3) p2 - p0
    area: torch.Tensor      # (E,)
    normal: torch.Tensor    # (E, 3) averaged vertex normal
    emission: torch.Tensor  # (E, 3)
    centroid: torch.Tensor  # (E, 3)
    tri: torch.Tensor       # (E,) int32 triangle id

    @property
    def n(self) -> int:
        return int(self.tri.shape[0])


def prepare_emissive_table(scene: Scene) -> EmissiveTable:
    """The emissive list's geometry and emission (megakernel_restir.py:
    129-158) on the scene's device, without the TPU's lane padding."""
    g = scene.geometry
    tri = torch.as_tensor(scene.emissive_tris, device=g.positions.device).to(torch.int32)
    if tri.shape[0] == 0:
        raise ValueError("ReSTIR DI needs at least one emissive triangle")
    tv = g.tri_v[tri.long()].long()
    p0, p1, p2 = (g.positions[tv[:, k]] for k in range(3))
    cr = cross3(p1 - p0, p2 - p0)
    area = 0.5 * torch.sqrt(torch.clamp_min(dot3(cr, cr, keepdims=False), 1e-20))
    mat = g.tri_mat[tri.long()].long()
    emission = scene.materials.emission_color[mat] * scene.materials.emission_power[mat][:, None]
    return EmissiveTable(
        p0=p0.contiguous(), e1=(p1 - p0).contiguous(), e2=(p2 - p0).contiguous(),
        area=area.contiguous(),
        normal=normalize(g.normals[tv[:, 0]] + g.normals[tv[:, 1]] + g.normals[tv[:, 2]]).contiguous(),
        emission=emission.contiguous(), centroid=((p0 + p1 + p2) / 3.0).contiguous(), tri=tri)


# ---- plain versions ------------------------------------------------------------

def _zeros(B, dev):
    """Empty reservoirs with float fields: the stage and state hold them as
    float32 rows in ``RES_FIELDS`` order."""
    return {k: torch.zeros(B, dtype=torch.float32, device=dev) for k in RES_FIELDS}


def _slot(em: EmissiveTable, idx):
    return torch.clamp(idx.to(torch.int64), 0, em.n - 1)


def _p_hat(em: EmissiveTable, e, pos, n, view, alb, rough, metal):
    """p̂ at the emitter's centroid (megakernel_restir.py:219-240)."""
    tl = em.centroid[e] - pos
    dist2 = torch.clamp_min(dot3(tl, tl, keepdims=False), 1e-20)
    l = tl * torch.rsqrt(dist2)[:, None]
    f = cook_torrance_brdf(n, view, l, alb, metal, rough)
    cos_x = torch.clamp_min(dot3(l, n, keepdims=False), 0.0)
    cos_y = torch.clamp_min(-dot3(l, em.normal[e], keepdims=False), 0.0)
    scale = cos_x * cos_y * torch.clamp_min(em.area[e], 1e-20) / dist2
    r = f * scale[:, None] * em.emission[e]
    return torch.sqrt(torch.clamp_min(dot3(r, r, keepdims=False), 0.0))


def restir_di_k3_plain(scene: Scene, em: EmissiveTable, camera: Camera, frame: int,
                       settings: RenderSettings, state: torch.Tensor, ppv) -> torch.Tensor:
    """K3 in PyTorch: the (S_ROWS, B) stage of frame ``frame`` from the
    previous frame's ``state``, reprojecting through ``ppv``; a textured
    albedo is read from the kernel's primary level (``with_kernel_atlas``)."""
    scene = with_kernel_atlas(scene)
    dev = state.device
    B = camera.width * camera.height
    o, d = camera_rays(camera, dev)
    tri = trace_rays(scene.bvh, scene.geometry, o, d)["tri"]
    s0 = hit_surface(scene, o, d, tri)
    hit, pos, n, alb, rough, metal, em0 = (s0[k] for k in ("hit", "pos", "n", "alb", "rough", "metal", "em"))
    shade = hit & ~(dot3(em0, em0, keepdims=False) > 0.0)
    view = -d
    pix = torch.arange(B, device=dev)

    key = rng.path_key(pix, frame, 0, stream=7001)
    ne = em.n
    res = _zeros(B, dev)
    for _ in range(settings.light_candidates):
        key, (u_sel, u_acc) = rng.uniforms(key, 2)
        cand = torch.clamp_max((u_sel * ne).to(torch.int32), ne - 1)
        ph = _p_hat(em, cand.long(), pos, n, view, alb, rough, metal)
        res = reservoir_update(res, cand.to(torch.float32), ph * float(ne), 1.0, ph, u_acc, shade)
    res = _finalize_w(res)

    if settings.temporal_reuse:
        q, prev_pix = tile_history_index(camera, ppv, pos, shade)
        pn = state[ST_NRM:ST_NRM + 3, q].T
        p_m = state[ST_RM, q]
        valid = (dot3(pn, n, keepdims=False) >= _NORMAL_TEMPORAL) & (p_m > 0.0) & shade \
            & (q == prev_pix)
        prev_m = torch.minimum(p_m, float(settings.temporal_history_limit) * res["m"])
        prev_idx, prev_w = state[ST_RIDX, q], state[ST_RW, q]

        key, (u1, u2) = rng.uniforms(key, 2)
        tmp = reservoir_update(_zeros(B, dev), res["index"], res["pdf"] * res["w"] * res["m"], res["m"],
                               res["pdf"], u1, valid)
        z = torch.where(valid & (res["pdf"] > 0.0), res["m"], 0.0)
        p_prev = _p_hat(em, _slot(em, prev_idx), pos, n, view, alb, rough, metal)
        tmp = reservoir_update(tmp, prev_idx, p_prev * prev_w * prev_m, prev_m, p_prev, u2, valid)
        z = z + torch.where(valid & (p_prev > 0.0), prev_m, 0.0)
        tmp = _finalize_w(tmp, 1.0 / torch.clamp_min(z, 1.0))
        res = {k: torch.where(valid, tmp[k], res[k]) for k in RES_FIELDS}

    return torch.stack([*pos.T, *n.T, *alb.T, rough, metal, s0["t"],
                        shade.to(torch.float32), *em0.T, hit.to(torch.float32),
                        *(res[k] for k in RES_FIELDS)])


def _emitter_ray(em: EmissiveTable, e, pos, up1, up2):
    """K4's shadow ray from ``pos`` towards the point of emitter ``e`` at the
    uniform draws ``up1``, ``up2``: its unit direction and its squared
    length, clamped to 1e-20."""
    su = torch.sqrt(up1)
    b1, b2 = su * (1.0 - up2), su * up2
    pt = em.p0[e] + em.e1[e] * b1[:, None] + em.e2[e] * b2[:, None]
    tl = pt - pos
    dist2 = torch.clamp_min(dot3(tl, tl, keepdims=False), 1e-20)
    return tl * torch.rsqrt(dist2)[:, None], dist2


def restir_di_k4_plain(scene: Scene, em: EmissiveTable, camera: Camera, frame: int,
                       settings: RenderSettings, stage: torch.Tensor, state: torch.Tensor,
                       accum: torch.Tensor) -> None:
    """K4 in PyTorch: spatial reuse and shade of frame ``frame`` from its
    ``stage``; adds the frame's HDR to ``accum`` (B, 3) and writes
    ``state`` in place."""
    dev = stage.device
    w, h = camera.width, camera.height
    B = w * h
    C = pick_ray_lanes(B)
    pos, n, alb = stage[S_POS:S_POS + 3].T, stage[S_NRM:S_NRM + 3].T, stage[S_ALB:S_ALB + 3].T
    rough, metal, t_own = stage[S_ROUGH], stage[S_METAL], stage[S_T]
    shade, hit = stage[S_SHADE] > 0.5, stage[S_HIT] > 0.5
    res = {k: stage[S_RIDX + i] for i, k in enumerate(RES_FIELDS)}
    _, d = camera_rays(camera, dev)
    view = -d
    pix = torch.arange(B, device=dev)
    key = rng.path_key(pix, frame, 0, stream=7002)

    if settings.spatial_reuse and settings.spatial_neighbors > 0:
        key, (u_acc,) = rng.uniforms(key, 1)
        sp = reservoir_update(_zeros(B, dev), res["index"], res["pdf"] * res["w"] * res["m"], res["m"],
                              res["pdf"], u_acc, shade)
        z = torch.where(shade & (res["pdf"] > 0.0), res["m"], 0.0)
        px, py, lane, tile = pix % w, pix // w, pix % C, pix // C
        for dx, dy in spatial_offsets(frame, settings.spatial_neighbors,
                                      float(settings.spatial_radius), stream=7002):
            s = tile * C + dy * w + dx
            sc = torch.clamp(s, 0, B - C)
            q = sc + lane
            in_img = (px + dx >= 0) & (px + dx < w) & (py + dy >= 0) & (py + dy < h)
            n_t = stage[S_T, q]
            depth_ok = (n_t <= 1.1 * t_own) & (n_t >= 0.9 * t_own)
            normal_ok = dot3(stage[S_NRM:S_NRM + 3, q].T, n, keepdims=False) >= _NORMAL_SPATIAL
            ok = shade & in_img & (s == sc) & depth_ok & normal_ok & (stage[S_SHADE, q] > 0.5)
            nb_idx, nb_w, nb_m = stage[S_RIDX, q], stage[S_RW, q], stage[S_RM, q]
            key, (u_acc,) = rng.uniforms(key, 1)
            p_n = _p_hat(em, _slot(em, nb_idx), pos, n, view, alb, rough, metal)
            sp = reservoir_update(sp, nb_idx, p_n * nb_w * nb_m, nb_m, p_n, u_acc, ok)
            z = z + torch.where(ok & (p_n > 0.0), nb_m, 0.0)
        sp = _finalize_w(sp, 1.0 / torch.clamp_min(z, 1.0))
        res = {k: torch.where(shade, sp[k], res[k]) for k in RES_FIELDS}

    # ---- final shade (Renderer.cu:1957-2031)
    key, (up1, up2) = rng.uniforms(key, 2)
    e = _slot(em, res["index"])
    l, dist2 = _emitter_ray(em, e, pos, up1, up2)
    f = cook_torrance_brdf(n, view, l, alb, metal, rough)
    cos_x = torch.clamp_min(dot3(l, n, keepdims=False), 0.0)
    cos_y = torch.clamp_min(-dot3(l, em.normal[e], keepdims=False), 0.0)
    thr_s = (cos_x * cos_y * torch.clamp_min(em.area[e], 1e-20) / dist2)[:, None]
    sh = trace_rays(scene.bvh, scene.geometry, pos + n * 1e-12, l)["tri"]
    sel_tri = em.tri[e]
    sky = torch.tensor(settings.sky_color, dtype=torch.float32, device=dev)
    hdr = torch.where((shade & (sh == sel_tri) & (sel_tri >= 0))[:, None],
                      f * thr_s * em.emission[e] * res["w"][:, None], 0.0)
    hdr = hdr + torch.where((shade & (sh < 0))[:, None], f * thr_s * sky, 0.0)
    hdr = torch.where(hit[:, None], hdr, sky)
    hdr = torch.where((hit & ~shade)[:, None], stage[S_EMIT:S_EMIT + 3].T, hdr)
    accum += hdr
    state.copy_(torch.stack([*(res[k] for k in RES_FIELDS), *n.T, t_own]))


# ---- kernels -------------------------------------------------------------------

_WIDE = [ctypes.c_void_p] * 3 + [ctypes.c_int]
_EM = [ctypes.c_void_p] * 8 + [ctypes.c_int]
_K3_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int]
                + [ctypes.c_void_p] * 10                                        # geometry, materials
                + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5    # texture
                + _WIDE + _EM + [ctypes.c_void_p] * 3)
_K4_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
                 ctypes.c_int, ctypes.c_float, ctypes.c_int]
                + [ctypes.c_float] * 3 + _WIDE + _EM + [ctypes.c_void_p] * 4)


def _em_args(em: EmissiveTable):
    P = kernels.ptr
    return (P(em.p0), P(em.e1), P(em.e2), P(em.area), P(em.normal), P(em.emission),
            P(em.centroid), P(em.tri), em.n)


def _check(name, scene, em, wide, tensors, ints=()):
    """Raise unless the kernel's inputs lie on one CUDA device, contiguous,
    in their dtypes: ``tensors``, the scene's tables, the wide BVH ``wide``
    and the emissive table."""
    g, m = scene.geometry, scene.materials
    kernels.check_inputs(
        name,
        floats=(*tensors, g.positions, g.normals, m.albedo, m.roughness, m.metallic, wide.nodes, wide.tris,
                em.p0, em.e1, em.e2, em.area, em.normal, em.emission, em.centroid),
        ints=(*ints, g.tri_v, g.tri_mat, wide.overflow, em.tri))


def restir_di_k3(scene: Scene, em: EmissiveTable, camera: Camera, frame: int,
                 settings: RenderSettings, state: torch.Tensor, ppv, *,
                 cam: torch.Tensor | None = None) -> torch.Tensor:
    """The (S_ROWS, B) stage of frame ``frame`` through the CUDA kernel K3
    (plain version for CPU tensors), its textured instantiation for a
    textured scene, each tile one block or split over a cluster as
    ``restir_common.tile_clustered`` picks.  ``ppv`` may be an array or a
    tensor on the card, ``cam`` the camera's ``camera_matrices`` on the card
    (made from ``camera`` when None)."""
    if state.device.type == "cpu":
        return restir_di_k3_plain(scene, em, camera, frame, settings, state, ppv)
    dev = state.device
    B = camera.width * camera.height
    cam = camera_matrices(camera, dev) if cam is None else cam
    pv = torch.as_tensor(ppv, dtype=torch.float32, device=dev)
    emission = scene.materials.emission().contiguous()
    stage = torch.empty((S_ROWS, B), dtype=torch.float32, device=dev)
    tex = scene.tex
    lay = pick_tile_launch(scene, B, dev)
    wide = tile_walk_records("restir_di_k3", scene, lay["threads"])
    _check("restir_di_k3", scene, em, wide, (cam, pv, emission, state, stage, scene.geometry.uvs)
           + (() if tex is None else (tex.prim, tex.bounce)), ints=(scene.materials.albedo_map,))
    if state.shape != (ST_ROWS, B):
        raise ValueError(f"restir_di_k3: state must be ({ST_ROWS}, {B}), got {tuple(state.shape)}")
    _launch_k3(scene, em, camera, frame, settings, cam, pv, emission, state, stage,
               kernels.stream_ptr(dev), tex, lay["clustered"])
    return stage


def _launch_k3(scene, em, camera, frame, settings, cam, pv, emission, state, stage, stream, tex, clustered):
    """Launch ``fyp_restir_di_k3`` on ``stream``, textured with the tables
    ``tex`` unless it is None, each tile split over a cluster where
    ``clustered`` (inputs already checked; the walk reads ``scene.wide``)."""
    g, m = scene.geometry, scene.materials
    P = kernels.ptr
    fn = kernels.load("restir_di", "fyp_restir_di_k3", _K3_ARGTYPES)
    rc = fn(P(cam), P(pv), camera.width, camera.height, int(frame) & 0xFFFFFFFF,
            pick_ray_lanes(camera.width * camera.height), int(clustered), settings.light_candidates,
            float(settings.temporal_history_limit), int(settings.temporal_reuse),
            P(g.positions), P(g.normals), P(g.tri_v), P(g.tri_mat), P(g.uvs),
            P(m.albedo), P(m.roughness), P(m.metallic), P(emission), P(m.albedo_map), *tex_args(tex),
            *wide_args(scene.wide), *_em_args(em), P(state), P(stage), stream)
    restir_di_k3.launches += 1
    kernels.check(rc, "restir_di_k3")


def restir_di_k4(scene: Scene, em: EmissiveTable, camera: Camera, frame: int,
                 settings: RenderSettings, stage: torch.Tensor, state: torch.Tensor,
                 accum: torch.Tensor, *, cam: torch.Tensor | None = None) -> None:
    """Spatial reuse and shade of frame ``frame`` through the CUDA kernel K4
    (plain version for CPU tensors): adds the frame to ``accum`` (B, 3) and
    writes ``state`` in place, in blocks of ``TILE_BLOCK`` threads.
    ``cam`` as for ``restir_di_k3``."""
    if stage.device.type == "cpu":
        return restir_di_k4_plain(scene, em, camera, frame, settings, stage, state, accum)
    dev = stage.device
    B = camera.width * camera.height
    cam = camera_matrices(camera, dev) if cam is None else cam
    wide = tile_walk_records("restir_di_k4", scene, TILE_BLOCK)
    _check("restir_di_k4", scene, em, wide, (cam, stage, state, accum))
    if stage.shape != (S_ROWS, B) or state.shape != (ST_ROWS, B) or accum.shape != (B, 3):
        raise ValueError("restir_di_k4: stage, state and accum must be "
                         f"({S_ROWS}, {B}), ({ST_ROWS}, {B}) and ({B}, 3)")
    _launch_k4(scene, em, camera, frame, settings, cam, stage, state, accum,
               kernels.stream_ptr(dev))


def _launch_k4(scene, em, camera, frame, settings, cam, stage, state, accum, stream):
    """Launch ``fyp_restir_di_k4`` on ``stream`` (inputs already checked;
    the walk reads ``scene.wide``)."""
    P = kernels.ptr
    fn = kernels.load("restir_di", "fyp_restir_di_k4", _K4_ARGTYPES)
    rc = fn(P(cam), camera.width, camera.height, int(frame) & 0xFFFFFFFF,
            pick_ray_lanes(camera.width * camera.height), settings.spatial_neighbors,
            float(settings.spatial_radius), int(settings.spatial_reuse),
            *(float(c) for c in settings.sky_color), *wide_args(scene.wide), *_em_args(em), P(stage), P(state),
            P(accum), stream)
    restir_di_k4.launches += 1
    kernels.check(rc, "restir_di_k4")


restir_di_k3.launches = 0
restir_di_k4.launches = 0


def _frames(k3, k4, scene, em, camera, state, frame0, n_frames, settings, ppv0, ppv1):
    B = camera.width * camera.height
    out = torch.zeros((B, 3), dtype=torch.float32, device=state.device)
    for i in range(n_frames):
        # only the first frame after a move reprojects through the previous
        # pose; later frames' previous frame was rendered at this one
        # (megakernel_restir.py:847-855)
        stage = k3(scene, em, camera, frame0 + i, settings, state, ppv0 if i == 0 else ppv1)
        k4(scene, em, camera, frame0 + i, settings, stage, state, out)
    return out


def restir_di_megakernel_plain(scene: Scene, em: EmissiveTable, camera: Camera,
                               state: torch.Tensor, frame0: int, n_frames: int,
                               settings: RenderSettings, ppv0, ppv1) -> torch.Tensor:
    """(B, 3) HDR summed over ``n_frames`` frames from ``frame0``, PyTorch
    only; ``state`` is advanced in place.  ``ppv0`` is proj@view of the
    frame before ``frame0``, ``ppv1`` the camera's current one."""
    return _frames(restir_di_k3_plain, restir_di_k4_plain, scene, em, camera, state, frame0,
                   n_frames, settings, ppv0, ppv1)


def restir_di_megakernel(scene: Scene, em: EmissiveTable, camera: Camera, state: torch.Tensor,
                         frame0: int, n_frames: int, settings: RenderSettings,
                         ppv0, ppv1) -> torch.Tensor:
    """As ``restir_di_megakernel_plain``, each frame through K3 then K4 on
    the current stream (the plain versions for CPU tensors).  The camera and
    the two proj @ view go to the device once, before the frames: a copy
    to the card waits for the stream to drain."""
    dev = state.device
    cam = camera_matrices(camera, dev)
    ppv0, ppv1 = (torch.as_tensor(p, dtype=torch.float32, device=dev) for p in (ppv0, ppv1))
    return _frames(functools.partial(restir_di_k3, cam=cam), functools.partial(restir_di_k4, cam=cam),
                   scene, em, camera, state, frame0, n_frames, settings, ppv0, ppv1)


class MegakernelReSTIRDI:
    """ReSTIR DI, two kernels a frame, reservoirs kept on the device across
    ``render_many`` calls.

    Usage::
        mk = MegakernelReSTIRDI(scene, camera, settings, device="cuda")
        avg_hdr = mk.render_many(64)
        mk.camera.move_to(...)        # the next call reprojects its first frame
        avg_hdr = mk.render_many(64)
    """

    def __init__(self, scene: Scene, camera: Camera, settings: RenderSettings, device="cuda"):
        self.device = torch.device(device)
        self.camera = camera
        self.settings = settings
        B = camera.width * camera.height
        pick_ray_lanes(B)
        self.state = torch.zeros((ST_ROWS, B), dtype=torch.float32, device=self.device)
        self.accum = torch.zeros((B, 3), dtype=torch.float32, device=self.device)
        self.set_scene(scene)

    def set_scene(self, scene: Scene):
        """Render ``scene`` from now on (``SceneManager.apply``): on the
        device, with its emissive table and overflow watch made anew; the
        reservoirs and accumulation restart."""
        self.scene = scene.to(self.device)
        self.emitters = prepare_emissive_table(self.scene)
        self.overflow = OverflowWatch(self.scene)
        check_scene_tex(self.scene)
        self.reset()

    def reset(self):
        self.frame_index = 1
        self.accum.zero_()
        self.state.zero_()

    def render_many(self, n_frames: int) -> torch.Tensor:
        """Add ``n_frames`` frames to the accumulator; return the running
        average HDR image (H, W, 3)."""
        self.overflow.poll()
        self.accum += restir_di_megakernel(
            self.scene, self.emitters, self.camera, self.state, self.frame_index, n_frames,
            self.settings, self.camera.prev_proj_view, self.camera.proj_view)
        self.overflow.queue()
        self.frame_index += n_frames
        self.camera.commit_frame()
        h, w = self.camera.height, self.camera.width
        return (self.accum / float(self.frame_index - 1)).reshape(h, w, 3)
