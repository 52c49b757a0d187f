"""ReSTIR GI on tensors — spatiotemporal path-sample resampling for global
illumination (Ouyang et al. 2021).

The torch counterpart of ``fypraytracer_tpu/render/restir_gi.py``, the
reference's two-stage pipeline (PerPixel_ReSTIR_GI_Part1/2, Renderer.cu:
2043-2387) and its PathSample payload {visiblePoint, visibleNormal(oct),
samplePoint, sampleNormal(oct), outgoingRadiance, samplePDF}
(ReSTIR_GI_Reservoir.cuh:11-22):

  * part 1 — one BRDF-sampled path per pixel from the primary hit; the
    first bounce's hit is the reconnectable *sample point*; temporal reuse
    by reprojection with normal-dot ≥ 0.99 validation and history clamping
    (Renderer.cu:2230-2289);
  * part 2 — spatial reuse over N neighbours (depth ±10% / normal ≥ 0.906
    against the octahedral-quantized normal) with the path-reconnection
    Jacobian of paper eq. 11 (Renderer.cu:2343-2353) and a visibility
    re-trace from the neighbour's sample point to this pixel's visible
    point (Renderer.cu:2356-2366); 1/Z bias correction.

The JAX package's three documented fixes of the reference's estimator are
kept:
  * the stored radiance is the radiance arriving *from the sample point*
    (path traced with unit initial throughput), without the visible-point
    BRDF, which is re-applied at shade time (the reference bakes it in,
    Renderer.cu:2131-2136, invalid under reuse at another pixel);
  * W = weightSum / (Z · p̂(selected)), the paper's weight (the reference's
    collapses to 1/Z, Renderer.cu:2371-2372);
  * sky-only paths (the first bounce misses) are not reconnectable; their
    sky term is added to the pixel directly, outside the reservoir.

The JAX version chunks pixels for the TPU's tile padding; the result does
not depend on that, and the port runs whole images.  On a CUDA device every
trace is the kernel ``csrc/trace.cu`` (``trace_fn``).
"""

from __future__ import annotations

import torch

from fypraytracer_tpu_torch.core import rng
from fypraytracer_tpu_torch.core.mathutils import (
    brdf_sample_hemisphere,
    cook_torrance_brdf,
    decode_octahedral,
    dot3,
    encode_octahedral,
    ndc_to_uv,
    world_to_ndc,
)
from fypraytracer_tpu_torch.ops.hit import hit_payload
from fypraytracer_tpu_torch.render.integrators import ORIGIN_EPS, fetch_albedo, material_emission
from fypraytracer_tpu_torch.scene.types import Scene

_NORMAL_TEMPORAL = 0.99    # Renderer.cu:2245
_NORMAL_SPATIAL = 0.906    # Renderer.cu:2330
_DEPTH_TOL = 0.1           # ±10%


def sample_zeros(n: int, device="cpu"):
    """PathSample SoA (ReSTIR_GI_Reservoir.cuh:11-22)."""
    def z(*shape):
        return torch.zeros((n, *shape), dtype=torch.float32, device=device)

    return dict(vis_point=z(3), vis_normal=z(2),          # octahedral
                sample_point=z(3), sample_normal=z(2),    # octahedral
                radiance=z(3),                            # L_o from the sample point
                pdf=z())                                  # target p̂ of the sample


def reservoir_zeros(n: int, device="cpu"):
    return dict(sample=sample_zeros(n, device),
                w=torch.zeros(n, dtype=torch.float32, device=device),
                m=torch.zeros(n, dtype=torch.int32, device=device),
                wsum=torch.zeros(n, dtype=torch.float32, device=device))


def _select_sample(dst, src, accept):
    return {k: torch.where(accept[:, None] if v.dim() == 2 else accept, src[k], v)
            for k, v in dst.items()}


def reservoir_update(res, cand_sample, weight, count, p_hat, u, active):
    """Streaming update (ReSTIR_GI_Reservoir.cu:5-33); ``active`` lanes
    update, the others pass through unchanged."""
    wsum = res["wsum"] + torch.where(active, weight, 0.0)
    m = res["m"] + torch.where(active, count, 0).to(res["m"].dtype)
    accept = active & (wsum > 0.0) & (u < weight / torch.where(wsum > 0.0, wsum, 1.0))
    sample = _select_sample(res["sample"], dict(cand_sample, pdf=p_hat), accept)
    return dict(sample=sample, w=res["w"], m=m, wsum=wsum)


def _luminance_norm(radiance):
    """‖radiance‖, 0 for a zero vector."""
    sq = dot3(radiance, radiance, keepdims=False)
    return torch.where(sq > 0.0, torch.sqrt(torch.where(sq > 0.0, sq, 1.0)), 0.0)


def _trace_sample_path(scene: Scene, trace_fn, prim, view, key, settings):
    """One BRDF path from the primary hit (Renderer.cu:2087-2216).

    Returns (key, sample dict, sky_direct (B, 3), src_pdf (B,)):
      * sample.radiance = radiance arriving at the visible point FROM the
        sample point (visible-point BRDF not included);
      * src_pdf = solid-angle pdf of the initial BRDF direction;
      * sky_direct = first-bounce sky contribution (not reusable), with the
        visible-point BRDF applied, divided by src_pdf.
    """
    sky = torch.as_tensor(settings.sky_color, dtype=view.dtype, device=view.device)
    mats = scene.materials
    m0 = torch.clamp_min(prim["mat"], 0).long()
    albedo0 = fetch_albedo(scene, prim["mat"], prim["uv"])

    key, (u_sel, u1, u2) = rng.uniforms(key, 3)
    dir0, pdf0 = brdf_sample_hemisphere(prim["normal"], view, albedo0, mats.metallic[m0],
                                        mats.roughness[m0], u_sel, u1, u2)
    f0 = cook_torrance_brdf(prim["normal"], view, dir0, albedo0, mats.metallic[m0],
                            mats.roughness[m0])
    cos0 = torch.clamp_min(dot3(dir0, prim["normal"], keepdims=False), 0.0)

    ray_o = prim["position"] + prim["normal"] * ORIGIN_EPS
    ray_d = dir0
    pay1 = hit_payload(scene.geometry, ray_o, ray_d, trace_fn(ray_o, ray_d))
    first_miss = pay1["t"] < 0.0
    reconnectable = ~first_miss & (pdf0 > 0.0)

    # sky contribution of non-reconnectable paths, shaded now
    f_term = f0 * (cos0 / torch.clamp_min(pdf0, 1e-12))[:, None]
    sky_direct = torch.where((first_miss & (pdf0 > 0.0))[:, None], f_term * sky, 0.0)

    # the path continues from the sample point with unit throughput
    radiance = torch.zeros_like(view)
    throughput = torch.ones_like(view)
    active = reconnectable
    pay = pay1

    emission1 = material_emission(scene, pay1["mat"])
    em1 = dot3(emission1, emission1, keepdims=False) > 0.0
    radiance = radiance + torch.where((active & em1)[:, None], emission1, 0.0)
    active = active & ~em1

    for _ in range(max(settings.bounces - 1, 0)):
        view_b = -ray_d
        mb = torch.clamp_min(pay["mat"], 0).long()
        albedo_b = fetch_albedo(scene, pay["mat"], pay["uv"], bounce=True)
        key, (s1, s2, s3) = rng.uniforms(key, 3)
        l, pdf = brdf_sample_hemisphere(pay["normal"], view_b, albedo_b, mats.metallic[mb],
                                        mats.roughness[mb], s1, s2, s3)
        f = cook_torrance_brdf(pay["normal"], view_b, l, albedo_b, mats.metallic[mb],
                               mats.roughness[mb])
        cos_t = torch.clamp_min(dot3(l, pay["normal"]), 0.0)
        throughput = throughput * f * cos_t / torch.clamp_min(pdf, 1e-12)[:, None]
        active = active & (pdf > 0.0)

        ray_o = pay["position"] + pay["normal"] * ORIGIN_EPS
        ray_d = l
        pay = hit_payload(scene.geometry, ray_o, ray_d, trace_fn(ray_o, ray_d))
        miss = pay["t"] < 0.0
        radiance = radiance + torch.where((active & miss)[:, None], throughput * sky, 0.0)
        active = active & ~miss
        emission = material_emission(scene, pay["mat"])
        em = dot3(emission, emission, keepdims=False) > 0.0
        radiance = radiance + torch.where((active & em)[:, None], throughput * emission, 0.0)
        active = active & ~em

    radiance = torch.where(reconnectable[:, None], radiance, 0.0)
    sample = dict(vis_point=prim["position"], vis_normal=encode_octahedral(prim["normal"]),
                  sample_point=pay1["position"], sample_normal=encode_octahedral(pay1["normal"]),
                  radiance=radiance)
    return key, sample, sky_direct, torch.where(reconnectable, pdf0, 0.0)


def _shade(scene: Scene, prim, view, res, shade_lanes):
    """f(visible → sample dir)·cosθ·L_o·W (the paper's shade step)."""
    s = res["sample"]
    to_s = s["sample_point"] - prim["position"]
    dist = torch.sqrt(torch.clamp_min(dot3(to_s, to_s, keepdims=False), 1e-20))
    d = to_s / dist[:, None]
    m0 = torch.clamp_min(prim["mat"], 0).long()
    f = cook_torrance_brdf(prim["normal"], view, d, fetch_albedo(scene, prim["mat"], prim["uv"]),
                           scene.materials.metallic[m0], scene.materials.roughness[m0])
    cos_t = torch.clamp_min(dot3(d, prim["normal"], keepdims=False), 0.0)
    lane = shade_lanes & (res["w"] > 0.0)
    return torch.where(lane[:, None], f * (cos_t * res["w"])[:, None] * s["radiance"], 0.0)


def _prim_lanes(scene: Scene, prim):
    """(miss, emission, emissive, shade) of the primary payload."""
    miss = prim["t"] < 0.0
    emission = material_emission(scene, prim["mat"])
    emissive = dot3(emission, emission, keepdims=False) > 0.0
    return miss, emission, emissive, ~(miss | emissive)


def restir_gi_part1(scene: Scene, trace_fn, origins, directions, pixel_ids, frame, settings,
                    state, width: int, height: int, prev_proj_view):
    """Stage 1: primary trace, initial BRDF path, temporal reuse
    (PerPixel_ReSTIR_GI_Part1, Renderer.cu:2043-2293).  ``state`` is read
    with global pixel ids: the whole image's, or a shard's with its halo
    behind a global-index view (``parallel/restir_shard.py``)."""
    prim = hit_payload(scene.geometry, origins, directions, trace_fn(origins, directions))
    shade_lanes = _prim_lanes(scene, prim)[3]
    view = -directions

    key = rng.path_key(pixel_ids, frame, 0, stream=8001)
    key, sample, sky_direct, src_pdf = _trace_sample_path(scene, trace_fn, prim, view, key,
                                                          settings)

    p_hat = _luminance_norm(sample["radiance"])
    res = reservoir_zeros(pixel_ids.shape[0], origins.device)
    key, (u0,) = rng.uniforms(key, 1)
    w_ris = torch.where(src_pdf > 0.0, p_hat / torch.clamp_min(src_pdf, 1e-12), 0.0)
    res = reservoir_update(res, sample, w_ris, 1, p_hat, u0, shade_lanes)
    res["w"] = _w_of(res)

    if settings.temporal_reuse:
        uv_prev = ndc_to_uv(world_to_ndc(prev_proj_view, prim["position"]))
        px = torch.clamp((uv_prev[:, 0] * width).to(torch.int32), 0, width - 1)
        py = torch.clamp(((1.0 - uv_prev[:, 1]) * height).to(torch.int32), 0, height - 1)
        prev_idx = (px + py * width).long()

        prev_n = decode_octahedral(state["normal_oct"][prev_idx])
        pr = state["reservoir"]
        prev_res = dict(sample={k: v[prev_idx] for k, v in pr["sample"].items()},
                        w=pr["w"][prev_idx], m=pr["m"][prev_idx], wsum=pr["wsum"][prev_idx])
        # geometric validity only: a zero-radiance history sample is still a
        # valid sample ("this path found nothing") and counts in M
        valid = (dot3(prev_n, prim["normal"], keepdims=False) >= _NORMAL_TEMPORAL) \
            & (prev_res["m"] > 0) & shade_lanes

        cap = settings.temporal_history_limit * torch.clamp_min(res["m"], 1)
        prev_m = torch.minimum(prev_res["m"], cap)
        p_prev = prev_res["sample"]["pdf"]
        key, (ut,) = rng.uniforms(key, 1)
        merged = reservoir_update(res, prev_res["sample"],
                                  p_prev * prev_res["w"] * prev_m.to(torch.float32),
                                  prev_m, p_prev, ut, valid)
        merged["w"] = _w_of(merged)
        res = _where_res(valid, merged, res)

    out = dict(w=res["w"], m=res["m"], wsum=res["wsum"], t=prim["t"], mat=prim["mat"],
               position=prim["position"], normal=prim["normal"], uv=prim["uv"],
               sky_direct=sky_direct)
    for k, v in res["sample"].items():
        out["s_" + k] = v
    return out


def restir_gi_part2(scene: Scene, trace_fn, origins, directions, pixel_ids, frame, settings,
                    g, full_g, width: int, height: int):
    """Stage 2: spatial reuse with the reconnection Jacobian and the shade
    (PerPixel_ReSTIR_GI_Part2, Renderer.cu:2295-2387).  ``g`` holds stage
    1's arrays of these pixels, ``full_g`` what the neighbour gathers index
    with global pixel ids: the whole image's arrays, or a shard's with its
    halo behind a global-index view (``parallel/restir_shard.py``)."""
    sky = torch.as_tensor(settings.sky_color, dtype=origins.dtype, device=origins.device)
    prim = dict(t=g["t"], mat=g["mat"], position=g["position"], normal=g["normal"], uv=g["uv"])
    prim_miss, prim_emission, prim_emissive, shade_lanes = _prim_lanes(scene, prim)
    view = -directions

    sample_keys = [k[2:] for k in g if k.startswith("s_")]
    res = dict(sample={k: g["s_" + k] for k in sample_keys}, w=g["w"], m=g["m"], wsum=g["wsum"])

    key = rng.path_key(pixel_ids, frame, 0, stream=8002)
    if settings.spatial_reuse:
        px_self = (pixel_ids % width).to(torch.int32)
        py_self = (pixel_ids // width).to(torch.int32)
        radius = float(settings.spatial_radius)

        # own M always counts (see the zero-radiance note in part 1)
        z = torch.where(shade_lanes, res["m"], 0)
        for _ in range(settings.spatial_neighbors):
            key, (ux, uy, u_acc) = rng.uniforms(key, 3)
            ox = torch.clamp(px_self + ((ux * 2.0 - 1.0) * radius).to(torch.int32), 0, width - 1)
            oy = torch.clamp(py_self + ((uy * 2.0 - 1.0) * radius).to(torch.int32), 0, height - 1)
            nidx = (ox + oy * width).long()

            n_depth = full_g["t"][nidx]
            # the reference reads the oct-encoded normal G-buffer: quantize
            n_normal = decode_octahedral(encode_octahedral(full_g["normal"][nidx]))
            nr = dict(sample={k: full_g["s_" + k][nidx] for k in sample_keys},
                      w=full_g["w"][nidx], m=full_g["m"][nidx], wsum=full_g["wsum"][nidx])
            n_rad_len = _luminance_norm(nr["sample"]["radiance"])
            # geometric acceptance only — zero-radiance neighbours still count
            # in Z (their merge weight is 0, the M accounting is not)
            ok = shade_lanes \
                & (n_depth <= (1.0 + _DEPTH_TOL) * prim["t"]) \
                & (n_depth >= (1.0 - _DEPTH_TOL) * prim["t"]) \
                & (dot3(prim["normal"], n_normal, keepdims=False) >= _NORMAL_SPATIAL) \
                & (nr["m"] > 0)

            # Jacobian of path reconnection (eq. 11, Renderer.cu:2343-2353)
            ns = nr["sample"]
            n_sn = decode_octahedral(ns["sample_normal"])
            d_q = ns["vis_point"] - ns["sample_point"]
            d_r = prim["position"] - ns["sample_point"]
            dist_q = torch.sqrt(torch.clamp_min(dot3(d_q, d_q, keepdims=False), 1e-20))
            dist_r = torch.sqrt(torch.clamp_min(dot3(d_r, d_r, keepdims=False), 1e-20))
            cos_q = dot3(n_sn, d_q / dist_q[:, None], keepdims=False)
            cos_r = dot3(n_sn, d_r / dist_r[:, None], keepdims=False)
            jac = torch.where(cos_q > 0.0, cos_r / torch.clamp_min(cos_q, 1e-12), 0.0) \
                * (dist_q * dist_q) / torch.clamp_min(dist_r * dist_r, 1e-20)
            p_n = torch.where(jac > 0.0, n_rad_len / torch.clamp_min(jac, 1e-12), 0.0)

            # visibility re-trace: neighbour sample point → this visible point
            vis_o = ns["sample_point"] + n_sn * ORIGIN_EPS
            vis_d = d_r / dist_r[:, None]
            vis_pay = hit_payload(scene.geometry, vis_o, vis_d, trace_fn(vis_o, vis_d))
            tol = torch.clamp_min(dist_r * 1e-3, 1e-4)
            p_n = torch.where(torch.abs(vis_pay["t"] - dist_r) <= tol, p_n, 0.0)

            z = z + torch.where(ok, nr["m"], 0)
            res = reservoir_update(res, ns, p_n * nr["w"] * nr["m"].to(torch.float32), nr["m"],
                                   p_n, u_acc, ok)

        # paper eq. 7 with Z (fixes Renderer.cu:2371-2372, module docstring)
        p_sel = res["sample"]["pdf"]
        res["w"] = torch.where(p_sel > 0.0,
                               res["wsum"] / (torch.clamp_min(z.to(torch.float32), 1.0)
                                              * torch.where(p_sel > 0.0, p_sel, 1.0)), 0.0)

    # ---- shade ------------------------------------------------------------
    gi = _shade(scene, prim, view, res, shade_lanes)
    out = gi + torch.where(shade_lanes[:, None], g["sky_direct"], 0.0)
    out = torch.where(prim_miss[:, None], sky, out)
    out = torch.where(prim_emissive[:, None], prim_emission, out)

    flat_res = dict(w=res["w"], m=res["m"], wsum=res["wsum"])
    for k, v in res["sample"].items():
        flat_res["s_" + k] = v
    return out, flat_res


def render_restir_gi(scene: Scene, trace_fn, origins, directions, pixel_ids, frame, settings,
                     state, width: int, height: int, prev_proj_view):
    """A ReSTIR GI frame: part 1, the stage barrier, part 2.

    ``state``: ``reservoir`` (the previous frame's final reservoirs),
    ``depth`` (B,) and ``normal_oct`` (B, 2) of the previous frame.
    Returns ((B, 3) HDR, new state).
    """
    g = restir_gi_part1(scene, trace_fn, origins, directions, pixel_ids, frame, settings, state,
                        width, height, prev_proj_view)
    out, flat_res = restir_gi_part2(scene, trace_fn, origins, directions, pixel_ids, frame,
                                    settings, g, g, width, height)
    sample = {k[2:]: v for k, v in flat_res.items() if k.startswith("s_")}
    new_state = dict(reservoir=dict(sample=sample, w=flat_res["w"], m=flat_res["m"],
                                    wsum=flat_res["wsum"]),
                     depth=g["t"], normal_oct=encode_octahedral(g["normal"]))
    return out, new_state


def _w_of(res):
    """W = weightSum / (M · p̂) (the standard RIS weight)."""
    p = res["sample"]["pdf"]
    return torch.where(p > 0.0,
                       res["wsum"] / (torch.clamp_min(res["m"].to(res["wsum"].dtype), 1.0)
                                      * torch.where(p > 0.0, p, 1.0)), 0.0)


def _where_res(cond, a, b):
    return dict(sample=_select_sample(b["sample"], a["sample"], cond),
                w=torch.where(cond, a["w"], b["w"]), m=torch.where(cond, a["m"], b["m"]),
                wsum=torch.where(cond, a["wsum"], b["wsum"]))


def init_state(num_pixels: int, device="cpu"):
    """Zero-initialized state (Renderer.cu:286-420)."""
    return dict(reservoir=reservoir_zeros(num_pixels, device),
                depth=torch.zeros(num_pixels, dtype=torch.float32, device=device),
                normal_oct=torch.zeros((num_pixels, 2), dtype=torch.float32, device=device))
