"""ReSTIR GI megakernel renderer: one kernel a frame (mono) or two.

The torch counterpart of ``fypraytracer_tpu/render/megakernel_restir_gi.py``
(``MegakernelReSTIRGI``).  Its frames are hand-written CUDA kernels from
``csrc/restir_gi.cu``, launched by the host on PyTorch's current stream:

  * K5 ``restir_gi_mono`` (the default, ``mono=True``) replaces the TPU
    kernel ``make_restir_gi_mono → kernel`` (:917, launched at :1490): the
    whole frame in one launch — primary hit, one BRDF path sample over
    ``bounces``, temporal reuse, the stage out, then spatial reuse LAGGED
    by one frame (neighbours are read from the previous frame's stage),
    the shade and the state out.  Visibility of a neighbour's reconnection
    is traced per neighbour (the reference's rejection, Renderer.cu:
    2356-2366), or with ``final_vis`` once for the winner (the original RIS
    form, ``--gi-fast``).  Its walks go through the scene's wide BVH
    (``Scene.wide``, one thread a ray, the segment test of
    ``ops/traverse.py::segment_visible_wide``), and each tile runs as one
    block, or split over a cluster of blocks of 128 threads where the tiles
    are too few to fill the card (``restir_common.tile_clustered``);
  * K6 ``restir_gi_k1`` replaces ``make_restir_gi_megakernel::k1`` (:169,
    launched at :748): K5's first half, writing the stage, its walks and
    tiles as K5's;
  * K7 ``restir_gi_k2`` replaces ``k2a`` (:447 → :758) and ``k2b`` (:544 →
    :794): same-frame spatial reuse from K6's stage with per-neighbour
    visibility (the wide segment test, as K5's), the shade, the state out
    (``mono=False``, the reference's own two-stage split), in blocks of 128
    threads: it sums nothing over a tile.  ``k2a`` only gathers neighbour
    rows; a GPU thread reads them itself, so it folds into K7.

The estimator is the wavefront's (``render/restir_gi.py``: radiance stored
without the visible-point BRDF, W = wsum/(Z·p̂), sky-only first bounces
shaded outside the reservoir); the semantics are the JAX megakernels': a
tile is ``pick_ray_lanes(B)`` consecutive pixels and reads the previous
state at one rounded mean reprojection offset, spatial offsets are shared
by the frame (``spatial_offsets(..., stream=8002)``), a neighbour counts
only where the tile's read is unclamped and in the image, normals are raw,
and a sample point is hit + n·1e-12 + d·t.  The stage and state are (rows,
B) float32 tensors whose rows are the ``GS_*`` and ``GT_*`` constants (the
JAX rows without its padding; ``from_tiled``/``to_tiled`` carry the JAX
(G·rows, C) layout across).  K5 reads the previous state and stage while
other blocks write this frame's, so its frame loop ping-pongs two pairs of
buffers.

A scene whose materials map an albedo launches K5's and K6's textured
instantiations: the primary hit reads the kernel's primary level, the
path's hits after a scatter the bounce level (``Scene.tex``);
K7 shades with the albedo K6 staged.

``restir_gi_mono_plain``, ``restir_gi_k1_plain`` and ``restir_gi_k2_plain``
are the kernels' plain PyTorch versions on whole images;
``restir_gi_megakernel_plain`` is the frame loop over them.  The wrappers
take the plain versions for CPU tensors only; for CUDA tensors they launch
the kernel or raise.  ``restir_gi_mono.launches``, ``restir_gi_k1.launches``
and ``restir_gi_k2.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fypraytracer_tpu_torch.config import RenderSettings
from fypraytracer_tpu_torch.core import rng
from fypraytracer_tpu_torch.core.camera import Camera
from fypraytracer_tpu_torch.core.mathutils import brdf_sample_hemisphere, cook_torrance_brdf, dot3
from fypraytracer_tpu_torch.ops import kernels
from fypraytracer_tpu_torch.ops.texture import check_scene_tex, tex_args, with_kernel_atlas
from fypraytracer_tpu_torch.ops.traverse import OverflowWatch, segment_visible, trace_rays
from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
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
from fypraytracer_tpu_torch.scene.types import Scene

# stage rows (K1 part -> spatial reuse and shade)
GS_POS, GS_NRM, GS_ALB = 0, 3, 6       # 3 rows each
GS_ROUGH, GS_METAL, GS_T, GS_SHADE = 9, 10, 11, 12
GS_EMIT = 13                           # 3 rows: primary emission
GS_HIT = 16
GS_SKY = 17                            # 3 rows: the non-reusable first-bounce sky term
GS_SP, GS_SN, GS_RAD = 20, 23, 26      # 3 rows each: the reservoir's path sample
GS_PHAT, GS_W, GS_M, GS_WSUM = 29, 30, 31, 32
GS_ROWS = 33
# state rows (shade -> the next frame's temporal reuse)
GT_SP, GT_SN, GT_RAD = 0, 3, 6
GT_PHAT, GT_W, GT_M, GT_WSUM = 9, 10, 11, 12
GT_NRM = 13                            # 3 rows
GT_ROWS = 16
# rows per tile of the JAX megakernels' (G·rows, C) buffers (:85, :96)
JAX_GS_ROWS, JAX_GT_ROWS = 40, 16

_EPS = 1e-12                # ray-origin offset (integrators.ORIGIN_EPS)
_NORMAL_TEMPORAL = 0.99
_NORMAL_SPATIAL = 0.906
_STREAM_PATH, _STREAM_SPATIAL = 8001, 8002


# ---- reservoir helpers (megakernel_restir_gi.py:101-131) -------------------------

def gi_res_update(res, cand, weight, count, pdf, u, active):
    """Streaming path-sample reservoir update (ReSTIR_GI_Reservoir.cu:5-33).
    ``res``: sp/sn/rad (B, 3), phat/w/m/wsum (B,); ``cand``: sp/sn/rad."""
    wsum2 = res["wsum"] + torch.where(active, weight, 0.0)
    m2 = res["m"] + torch.where(active, count, 0.0)
    accept = active & (wsum2 > 0.0) & (u < weight / torch.where(wsum2 > 0.0, wsum2, 1.0))
    out = {k: torch.where(accept[:, None], cand[k], res[k]) for k in ("sp", "sn", "rad")}
    return dict(out, phat=torch.where(accept, pdf, res["phat"]), w=res["w"], m=m2, wsum=wsum2)


def w_of(res):
    """W = wsum / (M · p̂)."""
    p = res["phat"]
    return torch.where(p > 0.0, res["wsum"] / (torch.clamp_min(res["m"], 1.0)
                                               * torch.where(p > 0.0, p, 1.0)), 0.0)


def rad_norm(rad):
    return torch.sqrt(torch.clamp_min(dot3(rad, rad, keepdims=False), 0.0))


def from_tiled(a, tile_rows: int, rows: int) -> torch.Tensor:
    """A JAX megakernel buffer, (G·tile_rows, C) with tile g's row r at
    g·tile_rows + r, as the port's (rows, B) on the CPU: the first ``rows``
    rows."""
    a = torch.as_tensor(np.array(a, np.float32))
    C = a.shape[1]
    G = a.shape[0] // tile_rows
    return a.reshape(G, tile_rows, C)[:, :rows].permute(1, 0, 2).reshape(rows, G * C).contiguous()


def to_tiled(x: torch.Tensor, tile_rows: int) -> np.ndarray:
    """The port's (rows, B) buffer in the JAX (G·tile_rows, C) layout,
    padding rows zero."""
    rows, B = x.shape
    C = pick_ray_lanes(B)
    out = np.zeros((B // C, tile_rows, C), np.float32)
    out[:, :rows] = x.detach().cpu().numpy().reshape(rows, B // C, C).transpose(1, 0, 2)
    return out.reshape(-1, C)


# ---- plain versions ------------------------------------------------------------

def _rows3(buf, row, q=None):
    x = buf[row:row + 3] if q is None else buf[row:row + 3, q]
    return x.T


def _trace_where(scene: Scene, o, d, mask):
    """Closest-hit triangle ids of the rays where ``mask``, -1 elsewhere."""
    tri = torch.full(mask.shape, -1, dtype=torch.int32, device=o.device)
    idx = mask.nonzero()[:, 0]
    if idx.numel():
        tri[idx] = trace_rays(scene.bvh, scene.geometry, o[idx], d[idx])["tri"]
    return tri


def _visible_where(scene: Scene, o, d, dist, mask):
    """``segment_visible`` where ``mask``, False elsewhere."""
    vis = torch.zeros(mask.shape, dtype=torch.bool, device=o.device)
    idx = mask.nonzero()[:, 0]
    if idx.numel():
        vis[idx] = segment_visible(scene.bvh, scene.geometry, o[idx], d[idx], dist[idx])
    return vis


def _k1_part(scene: Scene, camera: Camera, frame: int, settings: RenderSettings,
             state: torch.Tensor, ppv):
    """The first half of a GI frame on whole images (K6; K5 before its
    spatial reuse): the (GS_ROWS, B) stage and each pixel's key after its
    draws.  Pixels that do not shade keep an empty reservoir and no sky
    term, and trace nothing beyond the primary ray.  A textured albedo is
    read from the kernel's levels (``with_kernel_atlas``): the primary
    level at the primary hit, the bounce level after a scatter."""
    scene = with_kernel_atlas(scene)
    dev = state.device
    B = camera.width * camera.height
    o, d = camera_rays(camera, dev)
    s0 = hit_surface(scene, o, d, trace_rays(scene.bvh, scene.geometry, o, d)["tri"])
    hit, pos, n = s0["hit"], s0["pos"], s0["n"]
    shade = hit & ~(dot3(s0["em"], s0["em"], keepdims=False) > 0.0)
    view = -d
    sky = torch.tensor(settings.sky_color, dtype=torch.float32, device=dev)

    # ---- the BRDF path sample (megakernel_restir_gi.py:993-1083)
    key = rng.path_key(torch.arange(B, device=dev), frame, 0, stream=_STREAM_PATH)
    key, (u_sel, u1, u2) = rng.uniforms(key, 3)
    d0, pdf0 = brdf_sample_hemisphere(n, view, s0["alb"], s0["metal"], s0["rough"], u_sel, u1, u2)
    f0 = cook_torrance_brdf(n, view, d0, s0["alb"], s0["metal"], s0["rough"])
    cos0 = torch.clamp_min(dot3(d0, n, keepdims=False), 0.0)
    o1 = pos + n * _EPS
    s1 = hit_surface(scene, o1, d0, _trace_where(scene, o1, d0, shade), bounce=True)
    hit1 = s1["hit"]
    reconnect = hit1 & (pdf0 > 0.0)
    fterm = cos0 / torch.clamp_min(pdf0, 1e-12)
    sky_direct = torch.where((shade & ~hit1 & (pdf0 > 0.0))[:, None], f0 * fterm[:, None] * sky, 0.0)

    # the path continues from the sample point with unit throughput
    em1_hit = dot3(s1["em"], s1["em"], keepdims=False) > 0.0
    rad = torch.where((reconnect & em1_hit)[:, None], s1["em"], 0.0)
    active = reconnect & ~em1_hit
    thr = torch.ones_like(pos)
    cur, cd = s1, d0
    for _ in range(settings.bounces - 1):
        key, (r1, r2, r3) = rng.uniforms(key, 3)
        bv = -cd
        l, pdf = brdf_sample_hemisphere(cur["n"], bv, cur["alb"], cur["metal"], cur["rough"], r1, r2, r3)
        f = cook_torrance_brdf(cur["n"], bv, l, cur["alb"], cur["metal"], cur["rough"])
        scale = torch.clamp_min(dot3(l, cur["n"], keepdims=False), 0.0) / torch.clamp_min(pdf, 1e-12)
        thr = thr * f * scale[:, None]
        active = active & (pdf > 0.0)
        no = cur["pos"] + cur["n"] * _EPS
        nxt = hit_surface(scene, no, l, _trace_where(scene, no, l, active), bounce=True)
        rad = rad + torch.where((active & ~nxt["hit"])[:, None], thr * sky, 0.0)
        active = active & nxt["hit"]
        em_hit = dot3(nxt["em"], nxt["em"], keepdims=False) > 0.0
        rad = rad + torch.where((active & em_hit)[:, None], thr * nxt["em"], 0.0)
        active = active & ~em_hit
        cur, cd = nxt, l

    rad = torch.where(reconnect[:, None], rad, 0.0)
    src_pdf = torch.where(reconnect, pdf0, 0.0)
    p_hat = rad_norm(rad)
    key, (u0,) = rng.uniforms(key, 1)
    w_ris = torch.where(src_pdf > 0.0, p_hat / torch.clamp_min(src_pdf, 1e-12), 0.0)
    zero = torch.zeros(B, dtype=torch.float32, device=dev)
    res = dict(sp=torch.zeros_like(pos), sn=torch.zeros_like(pos), rad=torch.zeros_like(pos),
               phat=zero, w=zero, m=zero, wsum=zero)
    res = gi_res_update(res, dict(sp=s1["pos"], sn=s1["n"], rad=rad), w_ris, 1.0, p_hat, u0, shade)
    res["w"] = w_of(res)

    # ---- temporal reuse through the tile-shared reprojection (:1095-1164)
    if settings.temporal_reuse:
        q, prev_pix = tile_history_index(camera, ppv, pos, shade)
        p_m = state[GT_M, q]
        valid = (dot3(_rows3(state, GT_NRM, q), n, keepdims=False) >= _NORMAL_TEMPORAL) \
            & (p_m > 0.0) & shade & (q == prev_pix)
        prev_m = torch.minimum(p_m, float(settings.temporal_history_limit) * torch.clamp_min(res["m"], 1.0))
        prev = dict(sp=_rows3(state, GT_SP, q), sn=_rows3(state, GT_SN, q), rad=_rows3(state, GT_RAD, q))
        p_prev, w_prev = state[GT_PHAT, q], state[GT_W, q]
        key, (ut,) = rng.uniforms(key, 1)
        merged = gi_res_update(res, prev, p_prev * w_prev * prev_m, prev_m, p_prev, ut, valid)
        merged["w"] = w_of(merged)
        res = {k: torch.where(valid[:, None] if v.dim() == 2 else valid, merged[k], v)
               for k, v in res.items()}

    stage = torch.stack([*pos.T, *n.T, *s0["alb"].T, s0["rough"], s0["metal"], s0["t"],
                         shade.to(torch.float32), *s0["em"].T, hit.to(torch.float32),
                         *sky_direct.T, *res["sp"].T, *res["sn"].T, *res["rad"].T,
                         res["phat"], res["w"], res["m"], res["wsum"]])
    return stage, key


def _k2_part(scene: Scene, camera: Camera, frame: int, settings: RenderSettings,
             stage: torch.Tensor, nb_stage: torch.Tensor, key, final_vis: bool,
             accum: torch.Tensor, state: torch.Tensor) -> None:
    """The second half of a GI frame on whole images (K7; K5 after its
    stage): spatial reuse of ``stage``'s reservoirs over neighbours read
    from ``nb_stage``, the shade added to ``accum``, the state written."""
    dev = stage.device
    w, h = camera.width, camera.height
    B = w * h
    C = pick_ray_lanes(B)
    pos, n, alb = _rows3(stage, GS_POS), _rows3(stage, GS_NRM), _rows3(stage, GS_ALB)
    rough, metal, t_own = stage[GS_ROUGH], stage[GS_METAL], stage[GS_T]
    shade, hit = stage[GS_SHADE] > 0.5, stage[GS_HIT] > 0.5
    res = dict(sp=_rows3(stage, GS_SP), sn=_rows3(stage, GS_SN), rad=_rows3(stage, GS_RAD),
               phat=stage[GS_PHAT], w=stage[GS_W], m=stage[GS_M], wsum=stage[GS_WSUM])
    view = -camera_rays(camera, dev)[1]
    n_nbr = settings.spatial_neighbors if settings.spatial_reuse else 0

    if n_nbr > 0:
        pix = torch.arange(B, device=dev)
        px, py, lane, tile = pix % w, pix // w, pix % C, pix // C
        z = torch.where(shade, res["m"], 0.0)
        for dx, dy in spatial_offsets(frame, n_nbr, float(settings.spatial_radius),
                                      stream=_STREAM_SPATIAL):
            s = tile * C + dy * w + dx
            sc = torch.clamp(s, 0, B - C)
            q = sc + lane
            in_img = (px + dx >= 0) & (px + dx < w) & (py + dy >= 0) & (py + dy < h)
            n_t = nb_stage[GS_T, q]
            ok = shade & in_img & (s == sc) & (n_t <= 1.1 * t_own) & (n_t >= 0.9 * t_own) \
                & (dot3(_rows3(nb_stage, GS_NRM, q), n, keepdims=False) >= _NORMAL_SPATIAL) \
                & (nb_stage[GS_SHADE, q] > 0.5) & (nb_stage[GS_M, q] > 0.0)

            # Jacobian of path reconnection (eq. 11, Renderer.cu:2343-2353)
            spn, snn, radn = _rows3(nb_stage, GS_SP, q), _rows3(nb_stage, GS_SN, q), _rows3(nb_stage, GS_RAD, q)
            dq = _rows3(nb_stage, GS_POS, q) - spn
            dr = pos - spn
            dist_q = torch.sqrt(torch.clamp_min(dot3(dq, dq, keepdims=False), 1e-20))
            dist_r = torch.sqrt(torch.clamp_min(dot3(dr, dr, keepdims=False), 1e-20))
            cos_q = dot3(snn, dq, keepdims=False) / dist_q
            cos_r = dot3(snn, dr, keepdims=False) / dist_r
            jac = torch.where(cos_q > 0.0, cos_r / torch.clamp_min(cos_q, 1e-12), 0.0) \
                * (dist_q * dist_q) / torch.clamp_min(dist_r * dist_r, 1e-20)
            p_n = torch.where(jac > 0.0, rad_norm(radn) / torch.clamp_min(jac, 1e-12), 0.0)
            if not final_vis:
                # neighbour's sample point -> this visible point, traced only
                # where it can change the merge
                vis = _visible_where(scene, spn + snn * _EPS, dr / dist_r[:, None], dist_r,
                                     ok & (p_n > 0.0))
                p_n = torch.where(vis, p_n, 0.0)
            nb_w, nb_m = nb_stage[GS_W, q], nb_stage[GS_M, q]
            z = z + torch.where(ok, nb_m, 0.0)
            key, (u_acc,) = rng.uniforms(key, 1)
            res = gi_res_update(res, dict(sp=spn, sn=snn, rad=radn), p_n * nb_w * nb_m, nb_m, p_n,
                                u_acc, ok)
        p_sel = res["phat"]
        res["w"] = torch.where(p_sel > 0.0, res["wsum"] / (torch.clamp_min(z, 1.0)
                                                           * torch.where(p_sel > 0.0, p_sel, 1.0)), 0.0)

    # ---- shade (restir_gi._shade)
    ts = res["sp"] - pos
    dist = torch.sqrt(torch.clamp_min(dot3(ts, ts, keepdims=False), 1e-20))
    sd = ts / dist[:, None]
    f = cook_torrance_brdf(n, view, sd, alb, metal, rough)
    cos_t = torch.clamp_min(dot3(sd, n, keepdims=False), 0.0)
    lane_ok = shade & (res["w"] > 0.0)
    if final_vis and n_nbr > 0:
        # one visibility trace for the winner: its sample point -> this point
        lane_ok = _visible_where(scene, res["sp"] + res["sn"] * _EPS, -sd, dist, lane_ok)
    gi = torch.where(lane_ok[:, None], f * cos_t[:, None] * res["w"][:, None] * res["rad"], 0.0)
    hdr = gi + torch.where(shade[:, None], _rows3(stage, GS_SKY), 0.0)
    sky = torch.tensor(settings.sky_color, dtype=torch.float32, device=dev)
    hdr = torch.where(hit[:, None], hdr, sky)
    hdr = torch.where((hit & ~shade)[:, None], _rows3(stage, GS_EMIT), hdr)
    accum += hdr
    state.copy_(torch.stack([*res["sp"].T, *res["sn"].T, *res["rad"].T, res["phat"], res["w"],
                             res["m"], res["wsum"], *n.T]))


def restir_gi_k1_plain(scene: Scene, camera: Camera, frame: int, settings: RenderSettings,
                       state: torch.Tensor, ppv, stage: torch.Tensor | None = None) -> torch.Tensor:
    """K6 in PyTorch: the (GS_ROWS, B) stage of frame ``frame`` from the
    previous frame's ``state``, reprojecting through ``ppv``; written into
    ``stage`` when one is given."""
    out, _ = _k1_part(scene, camera, frame, settings, state, ppv)
    return out if stage is None else stage.copy_(out)


def restir_gi_k2_plain(scene: Scene, camera: Camera, frame: int, settings: RenderSettings,
                       stage: torch.Tensor, state: torch.Tensor, accum: torch.Tensor) -> None:
    """K7 in PyTorch: same-frame spatial reuse with per-neighbour visibility
    and the shade of frame ``frame`` from its ``stage``; adds the frame's
    HDR to ``accum`` (B, 3) and writes ``state`` in place."""
    pix = torch.arange(camera.width * camera.height, device=stage.device)
    key = rng.path_key(pix, frame, 0, stream=_STREAM_SPATIAL)
    _k2_part(scene, camera, frame, settings, stage, stage, key, False, accum, state)


def restir_gi_mono_plain(scene: Scene, camera: Camera, frame: int, settings: RenderSettings,
                         state_prev: torch.Tensor, stage_prev: torch.Tensor, ppv,
                         accum: torch.Tensor, state: torch.Tensor, stage: torch.Tensor,
                         final_vis: bool = False) -> None:
    """K5 in PyTorch: frame ``frame`` from the previous frame's
    ``state_prev`` and ``stage_prev``; adds its HDR to ``accum`` and writes
    this frame's ``state`` and ``stage``."""
    st, key = _k1_part(scene, camera, frame, settings, state_prev, ppv)
    stage.copy_(st)
    _k2_part(scene, camera, frame, settings, st, stage_prev, rng.fold(key, _STREAM_SPATIAL),
             final_vis, accum, state)


# ---- kernels -------------------------------------------------------------------

# csrc/restir_gi.cu's kernel selector
_K5, _K5_FINAL_VIS, _K6, _K7 = 0, 1, 2, 3
_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
              ctypes.c_float, ctypes.c_int]
             + [ctypes.c_float] * 3
             + [ctypes.c_void_p] * 10                           # geometry, materials
             + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5    # texture
             + [ctypes.c_void_p] * 3 + [ctypes.c_int]           # wide bvh
             + [ctypes.c_void_p] * 6)                           # buffers, stream


def _check(name, scene, camera, tensors, shapes, tex, wide):
    """Raise unless the kernel's inputs lie on one CUDA device, contiguous,
    in their dtypes and shapes: ``tensors`` (``shapes``: their rows, 3 for
    a (B, 3) image) and the scene's tables with the wide BVH ``wide``."""
    g, m = scene.geometry, scene.materials
    kernels.check_inputs(
        name, floats=(*tensors, g.positions, g.normals, g.uvs, m.albedo, m.roughness, m.metallic, wide.nodes,
                      wide.tris) + (() if tex is None else (tex.prim, tex.bounce)),
        ints=(g.tri_v, g.tri_mat, m.albedo_map, wide.overflow))
    B = camera.width * camera.height
    for t, rows in zip(tensors, shapes):
        want = (B, 3) if rows == 3 else (rows, B)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: expected a {want} buffer, got {tuple(t.shape)}")


def _launch(which, wrapper, scene, camera, frame, settings, cam, ppv, state_in, stage_in,
            state_out, stage_out, accum, stream, tex, wide, clustered):
    """Launch one kernel of ``fyp_restir_gi`` on ``stream`` (inputs already
    checked); buffers a kernel does not use may be None.  ``cam``: the
    camera's ``camera_matrices`` on the card, or None to make them here;
    ``ppv``: an array or a tensor on the card, None for K7.  K5 and K6 run
    their textured instantiation with the tables ``tex`` unless it is None;
    K7 reads the staged albedo and takes None.  ``wide``: the wide BVH the
    kernel walks; ``clustered``: K5 or K6 splits each tile over a cluster
    (K7 always runs blocks of ``TILE_BLOCK`` threads)."""
    g, m = scene.geometry, scene.materials
    dev = g.positions.device
    P = kernels.ptr

    def opt(t):
        return ctypes.c_void_p(None) if t is None else P(t)

    # the launch reads these on the stream: keep them referenced here
    cam = camera_matrices(camera, dev) if cam is None else cam
    pv = None if ppv is None else torch.as_tensor(ppv, dtype=torch.float32, device=dev)
    emission = m.emission().contiguous()
    fn = kernels.load("restir_gi", "fyp_restir_gi", _ARGTYPES)
    rc = fn(which, P(cam), opt(pv), camera.width, camera.height, int(frame) & 0xFFFFFFFF,
            pick_ray_lanes(camera.width * camera.height), int(clustered), settings.bounces,
            settings.spatial_neighbors if settings.spatial_reuse else 0,
            float(settings.spatial_radius), float(settings.temporal_history_limit),
            int(settings.temporal_reuse), *(float(c) for c in settings.sky_color),
            P(g.positions), P(g.normals), P(g.tri_v), P(g.tri_mat), P(g.uvs),
            P(m.albedo), P(m.roughness), P(m.metallic), P(emission), P(m.albedo_map),
            *tex_args(tex), *wide_args(wide), opt(state_in), opt(stage_in), opt(state_out),
            opt(stage_out), opt(accum), stream)
    wrapper.launches += 1
    kernels.check(rc, wrapper.__name__)


def restir_gi_mono(scene: Scene, camera: Camera, frame: int, settings: RenderSettings,
                   state_prev: torch.Tensor, stage_prev: torch.Tensor, ppv, accum: torch.Tensor,
                   state: torch.Tensor, stage: torch.Tensor, final_vis: bool = False, *,
                   cam: torch.Tensor | None = None) -> None:
    """Frame ``frame`` through the CUDA kernel K5 (plain version for CPU
    tensors): reads ``state_prev``/``stage_prev``, adds the HDR to ``accum``,
    writes ``state``/``stage``, which must be other buffers.  ``ppv`` may be
    an array or a tensor on the card, ``cam`` the camera's
    ``camera_matrices`` on the card (made from ``camera`` when None).  A
    textured scene runs K5's textured instantiation with ``Scene.tex``.
    Each tile runs as one block or split over a cluster as
    ``restir_common.tile_clustered`` picks."""
    if accum.device.type == "cpu":
        return restir_gi_mono_plain(scene, camera, frame, settings, state_prev, stage_prev, ppv,
                                    accum, state, stage, final_vis)
    tex = scene.tex
    lay = pick_tile_launch(scene, camera.width * camera.height, accum.device)
    wide = tile_walk_records("restir_gi_mono", scene, lay["threads"])
    _check("restir_gi_mono", scene, camera, (state_prev, stage_prev, accum, state, stage),
           (GT_ROWS, GS_ROWS, 3, GT_ROWS, GS_ROWS), tex, wide)
    if state.data_ptr() == state_prev.data_ptr() or stage.data_ptr() == stage_prev.data_ptr():
        raise ValueError("restir_gi_mono: the frame's state and stage need buffers of their own "
                         "(other blocks still read the previous ones)")
    _launch(_K5_FINAL_VIS if final_vis else _K5, restir_gi_mono, scene, camera, frame, settings, cam,
            ppv, state_prev, stage_prev, state, stage, accum, kernels.stream_ptr(accum.device), tex, wide,
            lay["clustered"])


def restir_gi_k1(scene: Scene, camera: Camera, frame: int, settings: RenderSettings,
                 state: torch.Tensor, ppv, stage: torch.Tensor | None = None, *,
                 cam: torch.Tensor | None = None) -> torch.Tensor:
    """The stage of frame ``frame`` through the CUDA kernel K6 (plain version
    for CPU tensors), into ``stage`` when one is given.  ``ppv`` and ``cam``
    as for ``restir_gi_mono``; the texturing and the tiles' launch as
    K5's."""
    if state.device.type == "cpu":
        return restir_gi_k1_plain(scene, camera, frame, settings, state, ppv, stage)
    B = camera.width * camera.height
    if stage is None:
        stage = torch.empty((GS_ROWS, B), dtype=torch.float32, device=state.device)
    tex = scene.tex
    lay = pick_tile_launch(scene, B, state.device)
    wide = tile_walk_records("restir_gi_k1", scene, lay["threads"])
    _check("restir_gi_k1", scene, camera, (state, stage), (GT_ROWS, GS_ROWS), tex, wide)
    _launch(_K6, restir_gi_k1, scene, camera, frame, settings, cam, ppv, state, None, None, stage, None,
            kernels.stream_ptr(state.device), tex, wide, lay["clustered"])
    return stage


def restir_gi_k2(scene: Scene, camera: Camera, frame: int, settings: RenderSettings,
                 stage: torch.Tensor, state: torch.Tensor, accum: torch.Tensor, *,
                 cam: torch.Tensor | None = None) -> None:
    """Spatial reuse and shade of frame ``frame`` through the CUDA kernel K7
    (plain version for CPU tensors): adds the frame to ``accum`` (B, 3) and
    writes ``state`` in place.  ``cam`` as for ``restir_gi_mono``.  Its
    walks go through the scene's wide BVH, in blocks of ``TILE_BLOCK``
    threads; a tree whose stacks do not fit such a block is refused before
    anything launches."""
    if stage.device.type == "cpu":
        return restir_gi_k2_plain(scene, camera, frame, settings, stage, state, accum)
    wide = tile_walk_records("restir_gi_k2", scene, TILE_BLOCK)
    _check("restir_gi_k2", scene, camera, (stage, state, accum), (GS_ROWS, GT_ROWS, 3), None, wide)
    _launch(_K7, restir_gi_k2, scene, camera, frame, settings, cam, None, None, stage, state, None,
            accum, kernels.stream_ptr(stage.device), None, wide, False)


restir_gi_mono.launches = 0
restir_gi_k1.launches = 0
restir_gi_k2.launches = 0


def _frames(k5, k6, k7, scene, camera, state, stage, frame0, n_frames, settings, ppv0, ppv1,
            mono, final_vis):
    B = camera.width * camera.height
    out = torch.zeros((B, 3), dtype=torch.float32, device=state.device)
    # only the first frame after a move reprojects through the previous
    # pose; later frames' previous frame was rendered at this one
    ppvs = [ppv0] + [ppv1] * (n_frames - 1)
    if mono:
        # K5 reads the previous pair while writing the next: two pairs of
        # buffers, swapped every frame; the caller's pair is only read
        pairs = [(torch.empty_like(state), torch.empty_like(stage)) for _ in range(min(n_frames, 2))]
        for i in range(n_frames):
            nxt = pairs[i % 2]
            k5(scene, camera, frame0 + i, settings, state, stage, ppvs[i], out, *nxt, final_vis=final_vis)
            state, stage = nxt
        return out, state, stage
    # K6 reads the state and writes the stage; K7 reads the stage and
    # writes the state (own pixel): the launch order keeps them apart
    state, stage = state.clone(), torch.empty_like(stage)
    for i in range(n_frames):
        k6(scene, camera, frame0 + i, settings, state, ppvs[i], stage)
        k7(scene, camera, frame0 + i, settings, stage, state, out)
    return out, state, stage


def restir_gi_megakernel_plain(scene: Scene, camera: Camera, state: torch.Tensor,
                               stage: torch.Tensor, frame0: int, n_frames: int,
                               settings: RenderSettings, ppv0, ppv1, mono: bool = True,
                               final_vis: bool = False):
    """``n_frames`` GI frames from ``frame0`` in PyTorch: returns the (B, 3)
    HDR summed over them and the last frame's state and stage (the given
    ones are left as they were).  ``ppv0`` is proj@view of the frame before
    ``frame0``, ``ppv1`` the camera's current one."""
    return _frames(restir_gi_mono_plain, restir_gi_k1_plain, restir_gi_k2_plain, scene, camera,
                   state, stage, frame0, n_frames, settings, ppv0, ppv1, mono, final_vis)


def restir_gi_megakernel(scene: Scene, camera: Camera, state: torch.Tensor, stage: torch.Tensor,
                         frame0: int, n_frames: int, settings: RenderSettings, ppv0, ppv1,
                         mono: bool = True, final_vis: bool = False):
    """As ``restir_gi_megakernel_plain``, each frame through K5, or K6 then
    K7, on the current stream (the plain versions for CPU tensors).  The
    camera and the two proj @ view go to the device once, before the frames:
    a copy to the card waits for the stream to drain."""
    dev = state.device
    cam = camera_matrices(camera, dev)
    ppv0, ppv1 = (torch.as_tensor(p, dtype=torch.float32, device=dev) for p in (ppv0, ppv1))
    k5, k6, k7 = (functools.partial(k, cam=cam) for k in (restir_gi_mono, restir_gi_k1, restir_gi_k2))
    return _frames(k5, k6, k7, scene, camera, state, stage, frame0, n_frames, settings, ppv0, ppv1,
                   mono, final_vis)


class MegakernelReSTIRGI:
    """ReSTIR GI, one kernel a frame (``mono``, the default) or two, the
    reservoirs kept on the device across ``render_many`` calls.

    Usage::
        mk = MegakernelReSTIRGI(scene, camera, settings)          # on the card
        avg_hdr = mk.render_many(64)
        mk.camera.move_to(...)        # the next call reprojects its first frame
        avg_hdr = mk.render_many(64)

    ``final_vis=True`` (mono only) traces one visibility ray for the spatial
    winner instead of one per neighbour (``--gi-fast``).  The scene's
    triangles are renumbered in Morton order, as the JAX class numbers them
    (megakernel_restir_gi.py:1574), so exact t-ties resolve alike.
    """

    def __init__(self, scene: Scene, camera: Camera, settings: RenderSettings, device="cuda",
                 mono: bool = True, final_vis: bool = False):
        if final_vis and not mono:
            raise ValueError("final_vis is a mode of the mono kernel; mono=False traces per neighbour")
        self.device = torch.device(device)
        self.camera = camera
        self.settings = settings
        self.mono = mono
        self.final_vis = final_vis
        B = camera.width * camera.height
        pick_ray_lanes(B)
        self.state = torch.zeros((GT_ROWS, B), dtype=torch.float32, device=self.device)
        self.stage = torch.zeros((GS_ROWS, B), dtype=torch.float32, device=self.device)
        self.accum = torch.zeros((B, 3), dtype=torch.float32, device=self.device)
        self.set_scene(scene)

    def set_scene(self, scene: Scene):
        """Render ``scene`` from now on (``SceneManager.apply``): renumbered
        in Morton order and put on the device, with a new overflow watch;
        the reservoirs, stage and accumulation restart."""
        self.scene = morton_permuted_scene(scene.to("cpu"))[0].to(self.device)
        self.overflow = OverflowWatch(self.scene)
        check_scene_tex(self.scene)
        self.reset()

    def reset(self):
        self.frame_index = 1
        self.accum.zero_()
        self.state.zero_()
        self.stage.zero_()

    def render_many(self, n_frames: int) -> torch.Tensor:
        """Add ``n_frames`` frames to the accumulator; return the running
        average HDR image (H, W, 3)."""
        self.overflow.poll()
        hdr, self.state, self.stage = restir_gi_megakernel(
            self.scene, self.camera, self.state, self.stage, self.frame_index, n_frames,
            self.settings, self.camera.prev_proj_view, self.camera.proj_view, self.mono,
            self.final_vis)
        self.accum += hdr
        self.overflow.queue()
        self.frame_index += n_frames
        self.camera.commit_frame()
        h, w = self.camera.height, self.camera.width
        return (self.accum / float(self.frame_index - 1)).reshape(h, w, 3)
