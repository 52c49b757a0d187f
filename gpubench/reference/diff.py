"""Plain inverse-rendering step: the reference of the training cell.

The loss of one cosine-sampled frame (1 spp, ``bounces`` scatters) against
a target, ``sum((r - target)^2) / (3 H W)``, as a function of the material
albedo, and its gradient by autograd: the path tracer's published
estimator written once more in plain PyTorch, with its own closest-hit
walk, in blocks of rows so that the autograd graph fits.  Directions do
not depend on the albedo under cosine sampling, so only the shading is
differentiated.  ``sgd`` follows the program's update, ``albedo - lr *
grad``, clamped to the traffic's bounds as the training loop clamps it,
for as many steps as it is given frames.
"""

from __future__ import annotations

import torch

from gpubench.reference import rng
from gpubench.reference.bvh import closest_hit, tree
from gpubench.reference.camera import generate_rays
from gpubench.reference.mathutils import INV_PI, cosine_sample_hemisphere, dot3
from gpubench.reference.nee import ORIGIN_EPS, hit_payload

ROWS = 1088     # image rows a block of the autograd graph: 1080p in one (1.3 GB; on an H100
                # 1.75 s a step, 6.68 s in blocks of 128)


def _norm3(v):
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    return v * torch.rsqrt(x * x + y * y + z * z + 1e-20)[:, None]


def brdf(n, view, l, alb, rough, metal):
    """Cook–Torrance (Lambert + GGX) of one scatter, (B, 3), in the path
    tracer's published training kernel's order of operations, term for
    term: the metallic sphere's lobe (roughness 0.15) reaches thousands
    under cosine sampling, so the reference rounds as the kernel is
    published to, and autograd differentiates it."""
    h = _norm3(view + l)
    ndl = torch.clamp_min(dot3(n, l, keepdims=False), 0.0)
    ndv = torch.clamp_min(dot3(n, view, keepdims=False), 0.0)
    ndh = torch.clamp_min(dot3(n, h, keepdims=False), 0.0)
    vdh = torch.clamp_min(dot3(view, h, keepdims=False), 0.0)
    a = rough * rough
    a2 = a * a
    k = rough * 0.5
    g = (ndv / torch.clamp_min(ndv * (1.0 - k) + k, 1e-12)) * (ndl / torch.clamp_min(ndl * (1.0 - k) + k, 1e-12))
    den = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 * INV_PI / torch.clamp_min(den * den, 1e-12)
    spec_s = (d * g / torch.clamp_min(4.0 * ndv * ndl, 1e-12))[:, None]
    s5 = ((1.0 - vdh) ** 5.0)[:, None]
    live = ((ndl > 0.0) & (ndv > 0.0))[:, None]
    m = metal[:, None]
    f0 = 0.04 * (1.0 - m) + alb * m
    fr = f0 + (1.0 - f0) * s5
    return torch.where(live, (1.0 - fr) * alb * INV_PI + spec_s * fr, 0.0)


def _surface(scene, albedo, o, d, tri):
    pay = hit_payload(scene.geometry, o, d, tri)
    hit = tri >= 0
    m = torch.clamp_min(pay["mat"], 0).long()
    mats = scene.materials

    def on_hit(x):
        return torch.where(hit if x.dim() == 1 else hit[:, None], x, 0.0)

    return dict(hit=hit, pos=on_hit(pay["position"]), n=on_hit(pay["normal"]), alb=on_hit(albedo[m]),
                rough=on_hit(mats.roughness[m]), metal=on_hit(mats.metallic[m]), em=on_hit(mats.emission()[m]))


def render(scene, albedo, camera, ids, frame: int, bounces: int, sky_color, trace):
    """(P, 3) radiance of one cosine-sampled frame at pixels ``ids``, with
    the material albedo ``albedo`` (M, 3) (differentiable) and the closest-
    hit function ``trace(origins, directions, live)``."""
    dev = scene.geometry.positions.device
    dt = scene.geometry.positions.dtype
    W, H = camera.width, camera.height
    sky = torch.as_tensor(sky_color, dtype=dt, device=dev)
    o, d = generate_rays(camera.inv_projection, camera.inv_view, W, H, device=dev, pixel_x=ids % W, pixel_y=ids // W)
    o, d = o.to(dt), d.to(dt)
    tri0 = trace(o, d, None)
    surf = _surface(scene, albedo, o, d, tri0)
    prim_emissive = surf["hit"] & (dot3(surf["em"], surf["em"], keepdims=False) > 0.0)
    em0 = surf["em"]
    active = surf["hit"] & ~prim_emissive
    key = rng.path_key(ids, frame, 0)
    thr = torch.ones_like(o)
    rad = torch.zeros_like(o)
    view = -d
    for _ in range(bounces):
        key, (u1, u2) = rng.uniforms(key, 2, dt)
        l = cosine_sample_hemisphere(surf["n"], u1, u2)
        cos_t = torch.clamp_min(dot3(l, surf["n"], keepdims=False), 0.0)
        pdf = cos_t * INV_PI
        ok = pdf > 0.0
        f = brdf(surf["n"], view, l, surf["alb"], surf["rough"], surf["metal"])
        active = active & ok
        g = torch.where(active[:, None], f * (cos_t / torch.where(ok, pdf, 1.0))[:, None], 0.0)
        thr = thr * g
        ray_o = surf["pos"] + surf["n"] * ORIGIN_EPS
        hit_tri = trace(ray_o, l, active)
        nxt = _surface(scene, albedo, ray_o, l, hit_tri)
        em_hit = nxt["hit"] & (dot3(nxt["em"], nxt["em"], keepdims=False) > 0.0)
        rad = rad + torch.where((active & ~nxt["hit"])[:, None], thr * sky, 0.0) \
            + torch.where((active & em_hit)[:, None], thr * nxt["em"], 0.0)
        active = active & nxt["hit"] & ~em_hit
        view, surf = -l, nxt
    out = torch.where((tri0 >= 0)[:, None], rad, sky)
    return torch.where(prim_emissive[:, None], em0, out)


def loss_and_grad(scene, camera, albedo, target, frame: int, bounces: int, sky_color):
    """``(loss, d loss / d albedo)`` of one frame, both float64 on the host,
    taken in blocks of ``ROWS`` rows."""
    dev = scene.geometry.positions.device
    dt = scene.geometry.positions.dtype
    geo = scene.geometry
    bvh = tree(geo)
    W, H = camera.width, camera.height
    leaf = albedo.detach().to(device=dev, dtype=dt).requires_grad_(True)
    loss = 0.0

    def trace(o, d, live):
        return closest_hit(bvh, geo.positions, geo.tri_v, o, d, live)

    for y0 in range(0, H, ROWS):
        ids = torch.arange(y0 * W, min(H, y0 + ROWS) * W, device=dev)
        out = render(scene, leaf, camera, ids, frame, bounces, sky_color, trace)
        err = out - target[ids].to(dev, dt)
        part = (err * err).sum() / float(3 * W * H)
        part.backward()
        loss += float(part.detach().double())
    return loss, leaf.grad.detach().double().cpu()


def sgd(scene, camera, albedo, target, frames, bounces: int, sky_color, lr: float, clamp=None):
    """The losses and the albedos after each step of plain SGD from
    ``albedo``, one step a frame of ``frames``, each new albedo clamped to
    ``clamp = (lo, hi)`` where given: ``(losses, albedos, grads)``, the
    albedos float64 on the host with ``albedo`` first, and each step's
    gradient before the update."""
    a = albedo.detach().double().cpu()
    losses, albedos, grads = [], [a], []
    for f in frames:
        loss, grad = loss_and_grad(scene, camera, a.float(), target, f, bounces, sky_color)
        new = a.float() - lr * grad.float()
        if clamp is not None:
            new = torch.clamp(new, *clamp)
        a = new.double()
        losses.append(loss)
        albedos.append(a)
        grads.append(grad)
    return losses, albedos, grads
