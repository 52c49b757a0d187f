"""Plain NEE with balance-heuristic MIS: the reference of the render cells.

A frozen copy of the path tracer's published wavefront estimator (next-
event estimation through the light tree, a BRDF-mixture continuation,
balance-heuristic MIS on both, emitters found by the continuation weighted
with the light pdf replayed at the actual hit), written once more in plain
PyTorch over a flat batch of (pixel, frame) lanes.  Every random draw is
keyed on (pixel, frame, sample, stream), so a lane traces the same path
the renderer traces for that pixel and frame.  Only live lanes are traced.
The type of the scene's float arrays sets the type of the arithmetic:
float32 for the reference, bfloat16 for its control.
"""

from __future__ import annotations

import torch

from gpubench.reference import rng
from gpubench.reference.bvh import closest_hit, moller_trumbore, tree
from gpubench.reference.camera import generate_rays
from gpubench.reference.lighttree import emitter_pmf, pick_light
from gpubench.reference.mathutils import (brdf_hemisphere_pdf, brdf_sample_hemisphere, cook_torrance_brdf, cross3,
                                          dot3, normalize)

ORIGIN_EPS = 1e-12
LANES = 1 << 18      # (pixel, frame) lanes a block of pixel_sums


def material_emission(scene, mat_id):
    m = torch.clamp_min(mat_id, 0).long()
    em = scene.materials.emission_color[m] * scene.materials.emission_power[m][..., None]
    return torch.where((mat_id >= 0)[..., None], em, 0.0)


def hit_payload(geometry, origins, directions, tri):
    """t (-1 on a miss), position, interpolated normal and material of the
    rays' hits on triangles ``tri``."""
    valid = tri >= 0
    tid = torch.clamp_min(tri, 0).long()
    tv = geometry.tri_v[tid].long()
    p0, p1, p2 = (geometry.positions[tv[..., k]] for k in range(3))
    t, u, v, _ = moller_trumbore(origins, directions, p0, p1, p2)
    t = torch.where(valid, t, -1.0)
    w = 1.0 - u - v
    n0, n1, n2 = (geometry.normals[tv[..., k]] for k in range(3))
    normal = normalize(n0 * w[..., None] + n1 * u[..., None] + n2 * v[..., None])
    position = origins + directions * t[..., None]
    mat = torch.where(valid, geometry.tri_mat[tid], -1)
    return dict(t=t, position=position, normal=normal, mat=mat)


def _point_on_triangle(geometry, tri_ids, u1, u2):
    tv = geometry.tri_v[torch.clamp_min(tri_ids, 0).long()].long()
    p0, p1, p2 = (geometry.positions[tv[..., k]] for k in range(3))
    su = torch.sqrt(u1)[..., None]
    point = p0 * (1.0 - su) + p1 * (su * (1.0 - u2[..., None])) + p2 * (su * u2[..., None])
    normal = normalize(geometry.normals[tv[..., 0]] + geometry.normals[tv[..., 1]] + geometry.normals[tv[..., 2]])
    cross = cross3(p1 - p0, p2 - p0)
    return point, normal, 0.5 * torch.sqrt(dot3(cross, cross, keepdims=False))


def radiance(scene, trace, origins, directions, pixel_ids, frames, bounces: int, samples: int, sky_color):
    """(B, 3) radiance of one frame per lane."""
    dt = origins.dtype
    sky = torch.as_tensor(sky_color, dtype=dt, device=origins.device)
    mats, geo = scene.materials, scene.geometry
    prim = hit_payload(geo, origins, directions, trace(origins, directions, None))
    prim_miss = prim["t"] < 0.0
    prim_emission = material_emission(scene, prim["mat"])
    prim_emissive = dot3(prim_emission, prim_emission, keepdims=False) > 0.0
    path_lanes = ~(prim_miss | prim_emissive)
    out = torch.zeros_like(origins)
    single = bounces == 1
    for s in range(samples):
        key = rng.path_key(pixel_ids, frames, s)
        active = path_lanes
        thr = torch.ones_like(origins)
        pay, ray_d = prim, directions
        for b in range(bounces):
            view = -ray_d
            m = torch.clamp_min(pay["mat"], 0).long()
            rough, metal, albedo = mats.roughness[m], mats.metallic[m], mats.albedo[m]
            key, (u_pick, u1, u2) = rng.uniforms(key, 3, dt)
            lt_tri, pmf = pick_light(scene.light_tree, pay["position"], u_pick)
            point, l_normal, area = _point_on_triangle(geo, lt_tri, u1, u2)
            to_light = point - pay["position"]
            dist = torch.sqrt(torch.clamp_min(dot3(to_light, to_light, keepdims=False), 1e-20))
            l_dir = to_light / dist[..., None]
            vis_tri = trace(pay["position"] + pay["normal"] * ORIGIN_EPS, l_dir, active)
            visible = (vis_tri == lt_tri) & (lt_tri >= 0)
            brdf_d = cook_torrance_brdf(pay["normal"], view, l_dir, albedo, metal, rough)
            cos_x = torch.clamp_min(dot3(l_dir, pay["normal"], keepdims=False), 0.0)
            cos_y = torch.clamp_min(dot3(-l_dir, l_normal, keepdims=False), 1e-12)
            pdf_direct = pmf * (1.0 / torch.clamp_min(area, 1e-20)) * dist * dist / cos_y
            pdf_brdf_l = brdf_hemisphere_pdf(pay["normal"], view, l_dir, albedo, metal, rough)
            lt_mat = torch.where(lt_tri >= 0, geo.tri_mat[torch.clamp_min(lt_tri, 0).long()], -1)
            w_direct = (torch.ones_like(pdf_direct) if single else
                        pdf_direct / torch.clamp_min(pdf_brdf_l + pdf_direct, 1e-12))
            direct = (w_direct / torch.clamp_min(pdf_direct, 1e-20) * cos_x)[..., None] * brdf_d \
                * material_emission(scene, lt_mat)
            out = out + torch.where((active & visible & (pmf > 0.0))[..., None], thr * direct, 0.0)
            if single:
                break
            key, (u_sel, v1, v2) = rng.uniforms(key, 3, dt)
            l, pdf_brdf = brdf_sample_hemisphere(pay["normal"], view, albedo, metal, rough, u_sel, v1, v2)
            brdf_c = cook_torrance_brdf(pay["normal"], view, l, albedo, metal, rough)
            cos_t = torch.clamp_min(dot3(l, pay["normal"]), 0.0)
            thr = thr * brdf_c * cos_t / torch.clamp_min(pdf_brdf, 1e-12)[..., None]
            active = active & (pdf_brdf > 0.0)
            ray_o = pay["position"] + pay["normal"] * ORIGIN_EPS
            ray_d = l
            tri = trace(ray_o, ray_d, active)
            new = hit_payload(geo, ray_o, ray_d, tri)
            miss = new["t"] < 0.0
            out = out + torch.where((active & miss)[..., None], thr * sky, 0.0)
            active = active & ~miss
            emission = material_emission(scene, new["mat"])
            hit_emissive = dot3(emission, emission, keepdims=False) > 0.0
            cos_y2 = torch.clamp_min(dot3(-ray_d, new["normal"], keepdims=False), 1e-12)
            tv2 = geo.tri_v[torch.clamp_min(tri, 0).long()].long()
            q0 = geo.positions[tv2[..., 0]]
            cr = cross3(geo.positions[tv2[..., 1]] - q0, geo.positions[tv2[..., 2]] - q0)
            area2 = 0.5 * torch.sqrt(torch.clamp_min(dot3(cr, cr, keepdims=False), 1e-20))
            dist2 = torch.clamp_min(new["t"], 0.0)
            pmf2 = emitter_pmf(scene.light_tree, tri, pay["position"])
            pdf_direct2 = pmf2 * (1.0 / area2) * dist2 * dist2 / cos_y2
            w_brdf = pdf_brdf / torch.clamp_min(pdf_brdf + pdf_direct2, 1e-12)
            out = out + torch.where((active & hit_emissive)[..., None], thr * emission * w_brdf[..., None], 0.0)
            active = active & ~hit_emissive
            pay = new
    out = out / float(samples)
    out = torch.where(prim_miss[..., None], sky, out)
    return torch.where(prim_emissive[..., None], prim_emission, out)


def pixel_sums(scene, camera, pixel_ids, frame0: int, n_frames: int, traffic: dict):
    """(P, 3) float64: each pixel's radiance summed over frames ``frame0 ..
    frame0 + n_frames - 1``, in blocks of at most ``LANES`` (pixel, frame)
    lanes.  ``scene`` lies on the device in the type the sums are taken in."""
    dev = scene.geometry.positions.device
    dt = scene.geometry.positions.dtype
    geo = scene.geometry
    bvh = tree(geo)

    def trace(o, d, live):
        return closest_hit(bvh, geo.positions, geo.tri_v, o, d, live)

    pixel_ids = torch.as_tensor(pixel_ids, dtype=torch.int64, device=dev)
    P = pixel_ids.shape[0]
    o_all, d_all = generate_rays(camera.inv_projection, camera.inv_view, camera.width, camera.height, device=dev,
                                 pixel_x=pixel_ids % camera.width, pixel_y=pixel_ids // camera.width)
    sums = torch.zeros((P, 3), dtype=torch.float64, device=dev)
    per = max(1, LANES // P)
    for f in range(0, n_frames, per):
        nf = min(per, n_frames - f)
        frames = frame0 + f + torch.arange(nf, device=dev).repeat_interleave(P)
        px = pixel_ids.repeat(nf)
        o = o_all.repeat(nf, 1).to(dt)
        d = d_all.repeat(nf, 1).to(dt)
        r = radiance(scene, trace, o, d, px, frames, traffic["bounces"], traffic["samples"], traffic["sky"])
        sums += r.double().reshape(nf, P, 3).sum(0)
    return sums
