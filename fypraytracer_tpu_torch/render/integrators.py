"""Wavefront path-tracing integrators on tensors — the technique zoo.

The torch counterpart of ``fypraytracer_tpu/render/integrators.py``:
``radiance_hemisphere`` (brute force, uniform, cosine, GGX and BRDF,
Renderer.cu:565-1284), ``radiance_light_source`` (Renderer.cu:1287-1408)
and ``radiance_nee_mis`` (Renderer.cu:1411-1626), with their helpers.
Divergent CUDA ``break``s are per-lane ``active`` masks; the bounce and
sample loops are Python loops over whole ray batches.  ``fetch_albedo``
reads a material's albedo map through ``ops/texture.py::sample_bilinear``
at the hit's UV, from mip 0 at the primary hit and from the prefiltered
bounce level at later hits (the TextureAtlas policy).

Kept exactly as the JAX package has them (see its docstring for why):
the next-ray origin offset ``ORIGIN_EPS`` (a no-op in float32 at |p| ≈ 1;
only ``t > T_EPSILON`` guards against self-intersection), the MIS pdf of
a BRDF-found emitter taken at the actual hit, and the cosθ clamp of the
continuation.
"""

from __future__ import annotations

import torch

from fypraytracer_tpu_torch.core import rng
from fypraytracer_tpu_torch.core.mathutils import (
    brdf_hemisphere_pdf,
    brdf_sample_hemisphere,
    cook_torrance_brdf,
    cosine_hemisphere_pdf,
    cosine_sample_hemisphere,
    cross3,
    dot3,
    ggx_sample_hemisphere,
    normalize,
    uniform_hemisphere_pdf,
    uniform_sample_hemisphere,
)
from fypraytracer_tpu_torch.ops.hit import hit_payload
from fypraytracer_tpu_torch.ops.lighttree import emitter_pmf, pick_light
from fypraytracer_tpu_torch.ops.texture import sample_bilinear
from fypraytracer_tpu_torch.scene.types import Scene

ORIGIN_EPS = 1e-12  # Renderer.cu:636 — kept for parity


def material_emission(scene: Scene, mat_id):
    """emission = color · power, zero for miss lanes (Material.cu:5-18)."""
    m = torch.clamp_min(mat_id, 0).long()
    em = scene.materials.emission_color[m] * scene.materials.emission_power[m][..., None]
    return torch.where((mat_id >= 0)[..., None], em, 0.0)


def fetch_albedo(scene: Scene, mat_id, uv, bounce: bool = False):
    """Flat albedo or bilinear texture fetch (Renderer.cu:609-621).

    ``bounce=True`` reads the prefiltered bounce mip level, the sampling
    policy (scene/types.py::TextureAtlas) every render path follows.  A
    scene without kernel levels (``Scene.tex`` None: no material maps an
    albedo) reads the flat albedo alone, which is what the fetch would
    select on every lane."""
    m = torch.clamp_min(mat_id, 0).long()
    flat = scene.materials.albedo[m]
    if scene.tex is None:
        return flat
    tex_id = scene.materials.albedo_map[m]
    textured = sample_bilinear(scene.textures, tex_id, uv[..., 0], uv[..., 1], bounce=bounce)
    return torch.where((tex_id >= 0)[..., None], textured, flat)


def _scatter(scene: Scene, pay, view, key, sampler: str, bounce: bool = False):
    """Draw one scatter direction at a hit; returns (key, L, pdf, albedo,
    roughness, metallic).  Uniform, cosine and GGX take two uniforms, the
    BRDF mixture three (u_sel first); ``bounce`` selects the texture mip
    per the TextureAtlas policy."""
    normal = pay["normal"]
    m = torch.clamp_min(pay["mat"], 0).long()
    rough = scene.materials.roughness[m]
    metal = scene.materials.metallic[m]
    albedo = fetch_albedo(scene, pay["mat"], pay["uv"], bounce=bounce)

    if sampler == "uniform":
        key, (u1, u2) = rng.uniforms(key, 2)
        l = uniform_sample_hemisphere(normal, u1, u2)
        pdf = torch.full(normal.shape[:-1], uniform_hemisphere_pdf(), dtype=normal.dtype,
                         device=normal.device)
    elif sampler == "cosine":
        key, (u1, u2) = rng.uniforms(key, 2)
        l = cosine_sample_hemisphere(normal, u1, u2)
        pdf = cosine_hemisphere_pdf(torch.clamp_min(dot3(normal, l, keepdims=False), 0.0))
    elif sampler == "ggx":
        key, (u1, u2) = rng.uniforms(key, 2)
        l, pdf = ggx_sample_hemisphere(normal, view, rough, u1, u2)
    elif sampler == "brdf":
        key, (u_sel, u1, u2) = rng.uniforms(key, 3)
        l, pdf = brdf_sample_hemisphere(normal, view, albedo, metal, rough, u_sel, u1, u2)
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    return key, l, pdf, albedo, rough, metal


def sampler_pdf(scene: Scene, pay, view, l, sampler: str):
    """pdf the scatter sampler assigns to direction ``l`` (for MIS)."""
    normal = pay["normal"]
    m = torch.clamp_min(pay["mat"], 0).long()
    cos_t = torch.clamp_min(dot3(normal, l, keepdims=False), 0.0)
    if sampler == "uniform":
        return torch.full_like(cos_t, uniform_hemisphere_pdf())
    if sampler == "cosine":
        return cosine_hemisphere_pdf(cos_t)
    if sampler == "brdf":
        return brdf_hemisphere_pdf(normal, view, l, fetch_albedo(scene, pay["mat"], pay["uv"]),
                                   scene.materials.metallic[m], scene.materials.roughness[m])
    raise ValueError(f"unknown sampler {sampler!r}")


def _primary(scene: Scene, trace_fn, origins, directions):
    """Primary payload and its early-out lanes (Renderer.cu:589-598)."""
    prim = hit_payload(scene.geometry, origins, directions, trace_fn(origins, directions))
    prim_miss = prim["t"] < 0.0
    prim_emission = material_emission(scene, prim["mat"])
    prim_emissive = dot3(prim_emission, prim_emission, keepdims=False) > 0.0
    return prim, prim_miss, prim_emission, prim_emissive


def radiance_hemisphere(scene: Scene, trace_fn, origins, directions, pixel_ids,
                        frame, settings, sampler: str):
    """Shared body of the brute-force / uniform / cosine / GGX / BRDF
    kernels (Renderer.cu:565-1284), (B, 3) HDR radiance of one frame.

    ``sampler="brute"`` is the uniform sampler at exactly one path per
    frame whatever ``settings.samples`` says (Renderer.cu:565-701).
    """
    sky = torch.as_tensor(settings.sky_color, dtype=origins.dtype, device=origins.device)
    brute = sampler == "brute"
    eff_sampler = "uniform" if brute else sampler
    num_samples = 1 if brute else settings.samples

    prim, prim_miss, prim_emission, prim_emissive = _primary(scene, trace_fn, origins, directions)
    path_lanes = ~(prim_miss | prim_emissive)
    radiance = torch.zeros_like(origins)

    for s in range(num_samples):
        key = rng.path_key(pixel_ids, frame, s)
        active = path_lanes
        throughput = torch.ones_like(origins)

        pay = prim
        view = -directions
        key, l, pdf, albedo, rough, metal = _scatter(scene, pay, view, key, eff_sampler)
        brdf = cook_torrance_brdf(pay["normal"], view, l, albedo, metal, rough)
        cos_t = torch.clamp_min(dot3(l, pay["normal"]), 0.0)
        ok = pdf > 0.0
        throughput = throughput * brdf * cos_t / torch.where(ok, pdf, 1.0)[..., None]
        active = active & ok
        ray_o = pay["position"] + pay["normal"] * ORIGIN_EPS
        ray_d = l

        for _b in range(settings.bounces):
            pay = hit_payload(scene.geometry, ray_o, ray_d, trace_fn(ray_o, ray_d))
            miss = pay["t"] < 0.0
            radiance = radiance + torch.where((active & miss)[..., None], throughput * sky, 0.0)
            active = active & ~miss

            emission = material_emission(scene, pay["mat"])
            is_emissive = dot3(emission, emission, keepdims=False) > 0.0
            radiance = radiance + torch.where((active & is_emissive)[..., None],
                                              throughput * emission, 0.0)
            active = active & ~is_emissive

            view = -ray_d
            key, l, pdf, albedo, rough, metal = _scatter(scene, pay, view, key, eff_sampler, bounce=True)
            brdf = cook_torrance_brdf(pay["normal"], view, l, albedo, metal, rough)
            cos_t = torch.clamp_min(dot3(l, pay["normal"]), 0.0)
            ok = pdf > 0.0
            throughput = throughput * brdf * cos_t / torch.where(ok, pdf, 1.0)[..., None]
            active = active & ok
            ray_o = pay["position"] + pay["normal"] * ORIGIN_EPS
            ray_d = l

    if num_samples > 1:
        radiance = radiance / float(num_samples)
    out = torch.where(prim_miss[..., None], sky, radiance)
    return torch.where(prim_emissive[..., None], prim_emission, out)


def _sample_point_on_triangle(geometry, tri_ids, u1, u2):
    """Uniform point via the sqrt warp (Triangle.cuh:20-34), averaged face
    normal (:36-43) and area (:45-51); lanes with tri_ids < 0 give
    arbitrary data (callers mask)."""
    tv = geometry.tri_v[torch.clamp_min(tri_ids, 0).long()].long()
    p0 = geometry.positions[tv[..., 0]]
    p1 = geometry.positions[tv[..., 1]]
    p2 = geometry.positions[tv[..., 2]]
    su = torch.sqrt(u1)[..., None]
    point = p0 * (1.0 - su) + p1 * (su * (1.0 - u2[..., None])) + p2 * (su * u2[..., None])

    n0 = geometry.normals[tv[..., 0]]
    n1 = geometry.normals[tv[..., 1]]
    n2 = geometry.normals[tv[..., 2]]
    normal = normalize(n0 + n1 + n2)

    cross = cross3(p1 - p0, p2 - p0)
    area = 0.5 * torch.sqrt(dot3(cross, cross, keepdims=False))
    return point, normal, area


def radiance_light_source(scene: Scene, trace_fn, origins, directions, pixel_ids,
                          frame, settings):
    """Light-tree direct-light sampling (PerPixel_LightSourceSampling,
    Renderer.cu:1287-1408), (B, 3) HDR radiance of one frame: one bounce
    of direct light; emitter picked by importance descent, uniform point
    on the triangle, pdf = pmf·dist²/area with both geometry cosines in the
    contribution, visibility by identity check; a shadow ray that escapes
    adds the sky (Renderer.cu:1388-1392)."""
    sky = torch.as_tensor(settings.sky_color, dtype=origins.dtype, device=origins.device)
    prim, prim_miss, prim_emission, prim_emissive = _primary(scene, trace_fn, origins, directions)
    path_lanes = ~(prim_miss | prim_emissive)

    albedo = fetch_albedo(scene, prim["mat"], prim["uv"])
    m = torch.clamp_min(prim["mat"], 0).long()
    rough = scene.materials.roughness[m]
    metal = scene.materials.metallic[m]
    view = -directions

    radiance = torch.zeros_like(origins)
    for s in range(settings.samples):
        key = rng.path_key(pixel_ids, frame, s)
        key, (u_pick, u1, u2) = rng.uniforms(key, 3)
        lt_tri, pmf = pick_light(scene.light_tree, prim["position"], u_pick)

        point, l_normal, area = _sample_point_on_triangle(scene.geometry, lt_tri, u1, u2)
        to_light = point - prim["position"]
        dist = torch.sqrt(torch.clamp_min(dot3(to_light, to_light, keepdims=False), 1e-20))
        l_dir = to_light / dist[..., None]

        brdf = cook_torrance_brdf(prim["normal"], view, l_dir, albedo, metal, rough)
        cos_x = torch.clamp_min(dot3(l_dir, prim["normal"], keepdims=False), 0.0)
        cos_y = torch.clamp_min(dot3(-l_dir, l_normal, keepdims=False), 0.0)
        pdf = pmf * (1.0 / torch.clamp_min(area, 1e-20)) * dist * dist
        contrib = brdf * (cos_x * cos_y / torch.clamp_min(pdf, 1e-20))[..., None]

        vis_tri = trace_fn(prim["position"] + prim["normal"] * ORIGIN_EPS, l_dir)
        visible = (vis_tri == lt_tri) & (lt_tri >= 0)
        lt_mat = torch.where(lt_tri >= 0,
                             scene.geometry.tri_mat[torch.clamp_min(lt_tri, 0).long()], -1)
        emission = material_emission(scene, lt_mat)
        lane = path_lanes & visible & (pmf > 0.0)
        radiance = radiance + torch.where(lane[..., None], contrib * emission, 0.0)
        sky_lane = path_lanes & (vis_tri < 0)
        radiance = radiance + torch.where(sky_lane[..., None], contrib * sky, 0.0)

    radiance = radiance / float(settings.samples)
    out = torch.where(prim_miss[..., None], sky, radiance)
    return torch.where(prim_emissive[..., None], prim_emission, out)


def radiance_nee_mis(scene: Scene, trace_fn, origins, directions, pixel_ids,
                     frame, settings):
    """One frame of NEE with balance-heuristic MIS, (B, 3) HDR radiance.

    Per bounce: (a) a shadow-rayed light-tree sample weighted by
    pdf_direct/(pdf_direct+pdf_brdf) (Renderer.cu:1519-1524,1539); (b) a
    BRDF-mixture continuation, weighted on an emitter hit by
    pdf_brdf/(pdf_brdf+pdf_direct) with pdf_direct replayed through the
    light tree (Renderer.cu:1613-1617).  With bounces == 1 this is plain
    light-source sampling with no MIS weight (Renderer.cu:1530-1536).

    trace_fn: (origins, dirs) -> (B,) i32 triangle ids (-1 miss);
    pixel_ids: (B,) RNG counter; frame: frame index (int or tensor).
    """
    sky = torch.as_tensor(settings.sky_color, dtype=origins.dtype, device=origins.device)
    mats = scene.materials

    prim, prim_miss, prim_emission, prim_emissive = _primary(scene, trace_fn, origins, directions)
    path_lanes = ~(prim_miss | prim_emissive)

    radiance = torch.zeros_like(origins)
    single_bounce = settings.bounces == 1

    for s in range(settings.samples):
        key = rng.path_key(pixel_ids, frame, s)
        active = path_lanes
        throughput = torch.ones_like(origins)
        pay = prim
        ray_d = directions

        for _b in range(settings.bounces):
            view = -ray_d
            mclamp = torch.clamp_min(pay["mat"], 0).long()
            rough = mats.roughness[mclamp]
            metal = mats.metallic[mclamp]
            albedo = fetch_albedo(scene, pay["mat"], pay["uv"], bounce=_b > 0)

            # ---- direct light sample -------------------------------------
            key, (u_pick, u1, u2) = rng.uniforms(key, 3)
            lt_tri, pmf = pick_light(scene.light_tree, pay["position"], u_pick)
            point, l_normal, area = _sample_point_on_triangle(scene.geometry, lt_tri, u1, u2)
            to_light = point - pay["position"]
            dist = torch.sqrt(torch.clamp_min(dot3(to_light, to_light, keepdims=False), 1e-20))
            l_dir = to_light / dist[..., None]

            shadow_o = pay["position"] + pay["normal"] * ORIGIN_EPS
            vis_tri = trace_fn(shadow_o, l_dir)
            visible = (vis_tri == lt_tri) & (lt_tri >= 0)

            brdf_d = cook_torrance_brdf(pay["normal"], view, l_dir, albedo, metal, rough)
            cos_x = torch.clamp_min(dot3(l_dir, pay["normal"], keepdims=False), 0.0)
            cos_y = torch.clamp_min(dot3(-l_dir, l_normal, keepdims=False), 1e-12)
            pdf_direct = pmf * (1.0 / torch.clamp_min(area, 1e-20)) * dist * dist / cos_y
            pdf_brdf_l = brdf_hemisphere_pdf(pay["normal"], view, l_dir, albedo, metal, rough)

            lt_mat = torch.where(lt_tri >= 0,
                                 scene.geometry.tri_mat[torch.clamp_min(lt_tri, 0).long()], -1)
            l_emission = material_emission(scene, lt_mat)
            w_direct = (torch.ones_like(pdf_direct) if single_bounce else
                        pdf_direct / torch.clamp_min(pdf_brdf_l + pdf_direct, 1e-12))
            direct = (w_direct / torch.clamp_min(pdf_direct, 1e-20) * cos_x)[..., None] \
                * brdf_d * l_emission
            lane = active & visible & (pmf > 0.0)
            radiance = radiance + torch.where(lane[..., None], throughput * direct, 0.0)

            if single_bounce:
                break

            # ---- BRDF continuation ---------------------------------------
            key, (u_sel, v1, v2) = rng.uniforms(key, 3)
            l, pdf_brdf = brdf_sample_hemisphere(pay["normal"], view, albedo,
                                                 metal, rough, u_sel, v1, v2)
            brdf_c = cook_torrance_brdf(pay["normal"], view, l, albedo, metal, rough)
            cos_t = torch.clamp_min(dot3(l, pay["normal"]), 0.0)
            ok = pdf_brdf > 0.0
            throughput = throughput * brdf_c * cos_t / torch.clamp_min(pdf_brdf, 1e-12)[..., None]
            active = active & ok

            ray_o = pay["position"] + pay["normal"] * ORIGIN_EPS
            ray_d = l
            tri = trace_fn(ray_o, ray_d)
            new_pay = hit_payload(scene.geometry, ray_o, ray_d, tri)
            miss = new_pay["t"] < 0.0

            radiance = radiance + torch.where((active & miss)[..., None], throughput * sky, 0.0)
            active = active & ~miss

            emission = material_emission(scene, new_pay["mat"])
            hit_emissive = dot3(emission, emission, keepdims=False) > 0.0
            # MIS for the BRDF-found emitter: light pdf at the ACTUAL hit
            cos_y2 = torch.clamp_min(dot3(-ray_d, new_pay["normal"], keepdims=False), 1e-12)
            tv2 = scene.geometry.tri_v[torch.clamp_min(tri, 0).long()].long()
            p_0 = scene.geometry.positions[tv2[..., 0]]
            cr = cross3(scene.geometry.positions[tv2[..., 1]] - p_0,
                        scene.geometry.positions[tv2[..., 2]] - p_0)
            area2 = 0.5 * torch.sqrt(torch.clamp_min(dot3(cr, cr, keepdims=False), 1e-20))
            dist2 = torch.clamp_min(new_pay["t"], 0.0)
            pmf2 = emitter_pmf(scene.light_tree, tri, pay["position"])
            pdf_direct2 = pmf2 * (1.0 / area2) * dist2 * dist2 / cos_y2
            w_brdf = pdf_brdf / torch.clamp_min(pdf_brdf + pdf_direct2, 1e-12)
            radiance = radiance + torch.where((active & hit_emissive)[..., None],
                                              throughput * emission * w_brdf[..., None], 0.0)
            active = active & ~hit_emissive
            pay = new_pay

    radiance = radiance / float(settings.samples)
    out = torch.where(prim_miss[..., None], sky, radiance)
    return torch.where(prim_emissive[..., None], prim_emission, out)
