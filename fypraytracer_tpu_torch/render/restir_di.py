"""ReSTIR DI on tensors — reservoir-based spatiotemporal direct light.

The torch counterpart of ``fypraytracer_tpu/render/restir_di.py``, the
reference's two-kernel pipeline (PerPixel_ReSTIR_DI_Part1/2,
Renderer.cu:1628-2041) as two whole-image stages with the state kept on
the device between frames:

  * part 1 — M candidate emitters drawn uniformly from the emissive list,
    target p̂ at the triangle centroid, streaming RIS; temporal reuse by
    reprojection through the previous frame's proj@view, normal-dot ≥ 0.99
    history check, history clamp limit·M and Algorithm 6's 1/Z weights;
  * part 2 — spatial reuse over N random neighbours per pixel within a
    radius, depth ±10% / normal-dot ≥ 0.906 rejection against the
    octahedral-quantized normal, then the final shade: a random point on
    the chosen emitter, a shadow ray, radiance × W.

The JAX package's documented fixes are kept (``floor(u·E)`` candidate
pick; a neighbour's sample re-evaluated at this pixel).  The JAX version
chunks pixels for the TPU's tile padding; the result does not depend on
that, and the port runs whole images.  On a CUDA device every trace is
the kernel ``csrc/trace.cu``.
"""

from __future__ import annotations

import torch

from fypraytracer_tpu_torch.core import rng
from fypraytracer_tpu_torch.core.mathutils import (
    cook_torrance_brdf,
    cross3,
    decode_octahedral,
    dot3,
    encode_octahedral,
    ndc_to_uv,
    normalize,
    world_to_ndc,
)
from fypraytracer_tpu_torch.ops.hit import hit_payload
from fypraytracer_tpu_torch.render.integrators import (
    ORIGIN_EPS,
    _sample_point_on_triangle,
    fetch_albedo,
    material_emission,
)
from fypraytracer_tpu_torch.scene.types import Scene

_NORMAL_TEMPORAL = 0.99    # Renderer.cu:1772
_NORMAL_SPATIAL = 0.906    # Renderer.cu:1935
_DEPTH_TOL = 0.1           # ±10%, Renderer.cu:1928-1929

_RES_KEYS = ("index", "w", "pdf", "wsum", "m")


def reservoir_zeros(shape, device):
    """Fresh reservoirs (ResetReservoir, ReSTIR_DI_Reservoir.cu:39-47)."""
    return dict(
        index=torch.zeros(shape, dtype=torch.int32, device=device),   # emissive-list slot
        w=torch.zeros(shape, dtype=torch.float32, device=device),     # W
        pdf=torch.zeros(shape, dtype=torch.float32, device=device),   # p̂ of the sample
        wsum=torch.zeros(shape, dtype=torch.float32, device=device),
        m=torch.zeros(shape, dtype=torch.int32, device=device),       # M
    )


def reservoir_update(res, cand_index, weight, count, pdf, u, active):
    """Streaming RIS update (ReSTIR_DI_Reservoir.cu:22-37); ``active``
    lanes update, the others pass through unchanged."""
    wsum = res["wsum"] + torch.where(active, weight, 0.0)
    m = res["m"] + torch.where(active, count, 0).to(res["m"].dtype)
    accept = active & (u < weight / torch.where(wsum > 0.0, wsum, 1.0)) & (wsum > 0.0)
    return dict(index=torch.where(accept, cand_index, res["index"]), w=res["w"],
                pdf=torch.where(accept, pdf, res["pdf"]), wsum=wsum, m=m)


def target_pdf_centroid(scene: Scene, emissive_slot, shade_pos, shade_normal, view,
                        albedo, metal, rough):
    """p̂ = ‖brdf · cosθ_x · cosθ_y / (dist²/area) · emission‖ at the
    emitter's centroid (Renderer.cu:1684-1731)."""
    n_em = scene.emissive_tris.shape[0]
    tri = scene.emissive_tris[torch.clamp(emissive_slot, 0, n_em - 1).long()].long()
    tv = scene.geometry.tri_v[tri].long()
    p0 = scene.geometry.positions[tv[..., 0]]
    p1 = scene.geometry.positions[tv[..., 1]]
    p2 = scene.geometry.positions[tv[..., 2]]
    centroid = (p0 + p1 + p2) / 3.0

    to_l = centroid - shade_pos
    dist2 = torch.clamp_min(dot3(to_l, to_l, keepdims=False), 1e-20)
    ldir = to_l / torch.sqrt(dist2)[..., None]
    n = scene.geometry.normals
    lnormal = normalize(n[tv[..., 0]] + n[tv[..., 1]] + n[tv[..., 2]])

    brdf = cook_torrance_brdf(shade_normal, view, ldir, albedo, metal, rough)
    cos_x = torch.clamp_min(dot3(ldir, shade_normal, keepdims=False), 0.0)
    cos_y = torch.clamp_min(dot3(-ldir, lnormal, keepdims=False), 0.0)
    cr = cross3(p1 - p0, p2 - p0)
    area = 0.5 * torch.sqrt(torch.clamp_min(dot3(cr, cr, keepdims=False), 1e-20))
    solid_pdf = (1.0 / area) * dist2

    emission = material_emission(scene, scene.geometry.tri_mat[tri])
    radiance = brdf * (cos_x * cos_y / torch.clamp_min(solid_pdf, 1e-20))[..., None] * emission
    sq = dot3(radiance, radiance, keepdims=False)
    return torch.where(sq > 0.0, torch.sqrt(torch.where(sq > 0.0, sq, 1.0)), 0.0)


def _finalize_w(res, m_inv=None):
    """W = (1/p̂)·(wsum/M), or Algorithm 6's (1/p̂)·(wsum/Z) when ``m_inv``
    (= 1/Z) is given (Renderer.cu:1744, 1862-1865)."""
    if m_inv is None:
        scale = res["wsum"] / torch.clamp_min(res["m"].to(res["wsum"].dtype), 1.0)
    else:
        scale = m_inv * res["wsum"]
    pos = res["pdf"] > 0.0
    return dict(res, w=torch.where(pos, scale / torch.where(pos, res["pdf"], 1.0), 0.0))


def _prim_setup(scene: Scene, directions, prim):
    """Per-pixel shading context from the primary payload."""
    prim_miss = prim["t"] < 0.0
    prim_emission = material_emission(scene, prim["mat"])
    prim_emissive = dot3(prim_emission, prim_emission, keepdims=False) > 0.0
    m = torch.clamp_min(prim["mat"], 0).long()
    return dict(miss=prim_miss, emission=prim_emission, emissive=prim_emissive,
                shade=~(prim_miss | prim_emissive), albedo=fetch_albedo(scene, prim["mat"], prim["uv"]),
                rough=scene.materials.roughness[m], metal=scene.materials.metallic[m],
                view=-directions)


def _p_hat(scene, slot, prim, ctx):
    return target_pdf_centroid(scene, slot, prim["position"], prim["normal"], ctx["view"],
                               ctx["albedo"], ctx["metal"], ctx["rough"])


def restir_di_part1(scene: Scene, trace_fn, origins, directions, pixel_ids, frame, settings,
                    state, width: int, height: int, prev_proj_view):
    """Stage 1: primary trace, M candidates by RIS, temporal reuse
    (PerPixel_ReSTIR_DI_Part1, Renderer.cu:1628-1873).  ``state`` is read
    with global pixel ids: the whole image's, or a shard's with its halo
    behind a global-index view (``parallel/restir_shard.py``)."""
    dev = origins.device
    num_emissive = max(scene.emissive_tris.shape[0], 1)
    prim = hit_payload(scene.geometry, origins, directions, trace_fn(origins, directions))
    ctx = _prim_setup(scene, directions, prim)

    key = rng.path_key(pixel_ids, frame, 0, stream=7001)
    res = reservoir_zeros(pixel_ids.shape, dev)
    for _ in range(settings.light_candidates):
        key, (u_sel, u_acc) = rng.uniforms(key, 2)
        cand = torch.clamp_max((u_sel * num_emissive).to(torch.int32), num_emissive - 1)
        p_hat = _p_hat(scene, cand, prim, ctx)
        res = reservoir_update(res, cand, p_hat * float(num_emissive), 1, p_hat, u_acc,
                               ctx["shade"])
    res = _finalize_w(res)

    if settings.temporal_reuse:
        uv_prev = ndc_to_uv(world_to_ndc(prev_proj_view, prim["position"]))
        px = torch.clamp((uv_prev[..., 0] * width).to(torch.int32), 0, width - 1)
        py = torch.clamp(((1.0 - uv_prev[..., 1]) * height).to(torch.int32), 0, height - 1)
        prev_idx = (px + py * width).long()

        prev_n = decode_octahedral(state["normal_oct"][prev_idx])
        prev_res = {k: v[prev_idx] for k, v in state["reservoir"].items()}
        valid = (dot3(prev_n, prim["normal"], keepdims=False) >= _NORMAL_TEMPORAL) \
            & (prev_res["m"] > 0) & ctx["shade"]
        prev_m = torch.minimum(prev_res["m"], settings.temporal_history_limit * res["m"])

        tmp = reservoir_zeros(pixel_ids.shape, dev)
        key, (u1, u2) = rng.uniforms(key, 2)
        tmp = reservoir_update(tmp, res["index"], res["pdf"] * res["w"] * res["m"].float(),
                               res["m"], res["pdf"], u1, valid)
        z = torch.where(valid & (res["pdf"] > 0.0), res["m"], 0)
        p_prev = _p_hat(scene, prev_res["index"], prim, ctx)
        tmp = reservoir_update(tmp, prev_res["index"], p_prev * prev_res["w"] * prev_m.float(),
                               prev_m, p_prev, u2, valid)
        z = z + torch.where(valid & (p_prev > 0.0), prev_m, 0)
        tmp = _finalize_w(tmp, 1.0 / torch.clamp_min(z.float(), 1.0))
        res = {k: torch.where(valid, tmp[k], res[k]) for k in res}

    return dict(res, t=prim["t"], mat=prim["mat"], position=prim["position"],
                normal=prim["normal"], uv=prim["uv"])


def restir_di_part2(scene: Scene, trace_fn, origins, directions, pixel_ids, frame, settings,
                    g, full_g, width: int, height: int):
    """Stage 2: spatial reuse and the final shade (PerPixel_ReSTIR_DI_Part2,
    Renderer.cu:1875-2041).  ``g`` holds stage 1's arrays of these pixels,
    ``full_g`` what the neighbour gathers index with global pixel ids: the
    whole image's arrays, or a shard's with its halo behind a global-index
    view (``parallel/restir_shard.py``)."""
    num_emissive = max(scene.emissive_tris.shape[0], 1)
    prim = dict(t=g["t"], mat=g["mat"], position=g["position"], normal=g["normal"], uv=g["uv"])
    ctx = _prim_setup(scene, directions, prim)
    res = {k: g[k] for k in _RES_KEYS}

    key = rng.path_key(pixel_ids, frame, 0, stream=7002)
    if settings.spatial_reuse:
        px_self = (pixel_ids % width).to(torch.int32)
        py_self = (pixel_ids // width).to(torch.int32)
        radius = float(settings.spatial_radius)

        sp = reservoir_zeros(pixel_ids.shape, origins.device)
        key, (u_acc,) = rng.uniforms(key, 1)
        sp = reservoir_update(sp, res["index"], res["pdf"] * res["w"] * res["m"].float(),
                              res["m"], res["pdf"], u_acc, ctx["shade"])
        z = torch.where(ctx["shade"] & (res["pdf"] > 0.0), res["m"], 0)

        for _ in range(settings.spatial_neighbors):
            key, (ux, uy, u_acc) = rng.uniforms(key, 3)
            ox = torch.clamp(px_self + ((ux * 2.0 - 1.0) * radius).to(torch.int32), 0, width - 1)
            oy = torch.clamp(py_self + ((uy * 2.0 - 1.0) * radius).to(torch.int32), 0, height - 1)
            nidx = (ox + oy * width).long()

            n_depth = full_g["t"][nidx]
            # the reference reads the oct-encoded normal G-buffer: quantize
            n_normal = decode_octahedral(encode_octahedral(full_g["normal"][nidx]))
            depth_ok = (n_depth <= (1.0 + _DEPTH_TOL) * prim["t"]) \
                & (n_depth >= (1.0 - _DEPTH_TOL) * prim["t"])
            normal_ok = dot3(prim["normal"], n_normal, keepdims=False) >= _NORMAL_SPATIAL
            ok = ctx["shade"] & depth_ok & normal_ok

            n_res = {k: full_g[k][nidx] for k in _RES_KEYS}
            p_n = _p_hat(scene, n_res["index"], prim, ctx)      # at THIS pixel (fix)
            sp = reservoir_update(sp, n_res["index"], p_n * n_res["w"] * n_res["m"].float(),
                                  n_res["m"], p_n, u_acc, ok)
            z = z + torch.where(ok & (p_n > 0.0), n_res["m"], 0)

        sp = _finalize_w(sp, 1.0 / torch.clamp_min(z.float(), 1.0))
        res = {k: torch.where(ctx["shade"], sp[k], res[k]) for k in res}

    # ---- final shade (Renderer.cu:1957-2031)
    key, (up1, up2) = rng.uniforms(key, 2)
    sel_tri = scene.emissive_tris[torch.clamp(res["index"], 0, num_emissive - 1).long()]
    point, lnormal, area = _sample_point_on_triangle(scene.geometry, sel_tri, up1, up2)
    to_l = point - prim["position"]
    dist2 = torch.clamp_min(dot3(to_l, to_l, keepdims=False), 1e-20)
    ldir = to_l / torch.sqrt(dist2)[..., None]

    brdf = cook_torrance_brdf(prim["normal"], ctx["view"], ldir, ctx["albedo"], ctx["metal"],
                              ctx["rough"])
    cos_x = torch.clamp_min(dot3(ldir, prim["normal"], keepdims=False), 0.0)
    cos_y = torch.clamp_min(dot3(-ldir, lnormal, keepdims=False), 0.0)
    solid_pdf = (1.0 / torch.clamp_min(area, 1e-20)) * dist2
    thr = brdf * (cos_x * cos_y / torch.clamp_min(solid_pdf, 1e-20))[..., None]

    vis_tri = trace_fn(prim["position"] + prim["normal"] * ORIGIN_EPS, ldir)
    visible = vis_tri == sel_tri
    sky = torch.as_tensor(settings.sky_color, dtype=origins.dtype, device=origins.device)
    emission = material_emission(scene, scene.geometry.tri_mat[sel_tri.long()])
    lit = torch.where((ctx["shade"] & visible)[..., None], thr * emission * res["w"][..., None], 0.0)
    lit = lit + torch.where((ctx["shade"] & (vis_tri < 0))[..., None], thr * sky, 0.0)

    out = torch.where(ctx["miss"][..., None], sky, lit)
    return torch.where(ctx["emissive"][..., None], ctx["emission"], out), res


def render_restir_di(scene: Scene, trace_fn, origins, directions, pixel_ids, frame, settings,
                     state, width: int, height: int, prev_proj_view):
    """A ReSTIR DI frame: part 1, the stage barrier, part 2.

    ``state``: ``reservoir`` (the previous frame's final reservoirs),
    ``depth`` (B,) and ``normal_oct`` (B, 2) of the previous frame.
    Returns ((B, 3) HDR, new state).
    """
    g = restir_di_part1(scene, trace_fn, origins, directions, pixel_ids, frame, settings, state,
                        width, height, prev_proj_view)
    out, res = restir_di_part2(scene, trace_fn, origins, directions, pixel_ids, frame, settings,
                               g, g, width, height)
    return out, dict(reservoir=res, depth=g["t"], normal_oct=encode_octahedral(g["normal"]))


def init_state(num_pixels: int, device="cpu"):
    """Zero-initialized state (Renderer.cu:286-356)."""
    return dict(reservoir=reservoir_zeros((num_pixels,), device),
                depth=torch.zeros((num_pixels,), dtype=torch.float32, device=device),
                normal_oct=torch.zeros((num_pixels, 2), dtype=torch.float32, device=device))
