"""Sampling / BRDF math on torch tensors.

A frozen copy of the path tracer's published sampling and BRDF formulas
(the reference renderer's ``MathUtils.cuh``), in their published order of
operations, trimmed to what the benchmark's reference uses.

Conventions (as in the JAX package):
  * vectors are ``(..., 3)`` float32 tensors; functions broadcast;
  * samplers take explicit uniforms (``core.rng``), the caller owns the
    draw order;
  * invalid samples are reported by ``pdf == 0``.
"""

from __future__ import annotations

import torch

PI = 3.1415926535  # matches MathUtils.cuh:17
INV_PI = 1.0 / PI
TWO_PI = 2.0 * PI


def _tail1(x, like):
    """Broadcast a per-lane scalar field to shape (..., 1) matching ``like``."""
    if not isinstance(x, torch.Tensor):
        return x
    if x.ndim == like.ndim - 1:
        return x[..., None]
    return x


def dot3(a, b, keepdims=True):
    """Sum of products in the fixed order ((x + y) + z), on every device —
    the order ``csrc/`` uses, so a kernel can reproduce it bit for bit."""
    d = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return d[..., None] if keepdims else d


def sqrt0(x):
    """sqrt(max(x, 0)) whose gradient at 0 is 0, not inf.  The value has
    the same bits; a plain sqrt's infinite slope at 0 turns a gradient into
    NaN (0 · inf) wherever a sample lands exactly on it."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def sqrt_rn(x):
    """The float32 square root rounded once from the exact root, on every
    device (a float64 root rounded to float32 is that: 53 >= 2·24 + 2
    bits), as CUDA's ``sqrtf`` gives it.  PyTorch's float32 ``sqrt`` on
    the CPU is not correctly rounded for every input."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def normalize(v, eps=1e-20):
    return v / torch.sqrt(torch.clamp_min(dot3(v, v), eps))


def cross3(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def reflect(i, n):
    """glm::reflect — reflect incident ``i`` about normal ``n``."""
    return i - 2.0 * dot3(i, n) * n


def build_onb(n):
    """Orthonormal basis from a unit normal (MathUtils.cuh:61-71)."""
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    zeros = torch.zeros_like(nx)
    t_a = normalize(torch.cat([-ny, nx, zeros], dim=-1))
    t_b = normalize(torch.cat([zeros, -nz, ny], dim=-1))
    cond = (nx * nx) > (nz * nz)
    tangent = torch.where(cond, t_a, t_b)
    bitangent = normalize(cross3(n, tangent))
    return tangent, bitangent


def to_world(n, local_x, local_y, local_z):
    """Map tangent-space components onto the ONB around ``n``."""
    tangent, bitangent = build_onb(n)
    return normalize(tangent * local_x + bitangent * local_y + n * local_z)


def cosine_sample_hemisphere(normal, u1, u2):
    """Cosine-weighted direction about ``normal`` (MathUtils.cuh:73-90)."""
    u1 = _tail1(u1, normal)
    u2 = _tail1(u2, normal)
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    return to_world(normal, x, y, z)


def cosine_hemisphere_pdf(cos_theta):
    """pdf = cosθ/π (MathUtils.cuh:92-95)."""
    return cos_theta * INV_PI






def ggx_sample_hemisphere(normal, view, roughness, u1, u2):
    """Sample a GGX half-vector and reflect the view (MathUtils.cuh:118-174).

    Returns ``(L, pdf)``; pdf is 0 for below-horizon / grazing samples.
    """
    u1 = _tail1(u1, normal)
    u2 = _tail1(u2, normal)
    r = _tail1(roughness, normal)
    alpha = r * r
    a2 = alpha * alpha

    phi = TWO_PI * u2
    # sqrt0: cos θ rounds to 1 for the smallest u1, and there a plain sqrt
    # made the roughness gradient NaN (the JAX package's jnp.sqrt does too)
    cos_theta = sqrt0(torch.clamp(
        (1.0 - u1) / torch.clamp_min(1.0 + (a2 - 1.0) * u1, 1e-12), 0.0, 1.0))
    cos_theta = torch.clamp(cos_theta, 0.0, 1.0)
    sin_theta = sqrt0(1.0 - cos_theta * cos_theta)

    h = to_world(normal, sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)
    l = reflect(-view, h)

    n_dot_l = dot3(normal, l)
    n_dot_h = dot3(normal, h)
    v_dot_h = dot3(view, h)

    denom = (n_dot_h * n_dot_h) * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp_min(PI * denom * denom, 1e-20)
    p_h = d * n_dot_h
    denom4 = 4.0 * v_dot_h
    valid = (n_dot_l > 0.0) & (denom4 > 1e-6) & (n_dot_h > 0.0)
    pdf = torch.where(valid, p_h / torch.where(valid, denom4, 1.0), 0.0)
    l = torch.where(valid, l, 0.0)
    return l, pdf[..., 0]


def ggx_hemisphere_pdf(normal, view, l, roughness):
    """pdf of ``l`` under GGX half-vector sampling (MathUtils.cuh:176-190)."""
    r = _tail1(roughness, normal)
    h = normalize(view + l)
    n_dot_h = torch.clamp_min(dot3(normal, h), 0.0)
    v_dot_h = torch.clamp_min(dot3(view, h), 0.0)
    alpha = r * r
    a2 = alpha * alpha
    denom = (n_dot_h * n_dot_h) * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp_min(PI * denom * denom, 1e-20)
    denom4 = 4.0 * v_dot_h
    valid = (n_dot_h > 0.0) & (denom4 > 1e-6)
    pdf = torch.where(valid, d * n_dot_h / torch.where(valid, denom4, 1.0), 0.0)
    return pdf[..., 0]


def fresnel_schlick(albedo, metallic, cos_term):
    """F0 = mix(0.04, albedo, metallic); Schlick (MathUtils.cuh:293-295)."""
    m = _tail1(metallic, albedo)
    f0 = 0.04 * (1.0 - m) + albedo * m
    return f0 + (1.0 - f0) * (1.0 - cos_term) ** 5.0


def specular_weight(normal, view, albedo, metallic):
    """Lobe-selection weight: mean Fresnel at N·V (MathUtils.cuh:201-218),
    summed ((r + g) + b) and scaled by 1/3 as ``csrc/shading.cuh::
    spec_weight`` does (a reduction's ``mean`` adds in its own order and
    parted from the kernels by an ulp where 0 < metallic < 1)."""
    m = _tail1(metallic, normal)
    n_dot_v = torch.clamp_min(dot3(normal, view), 0.0)
    f = fresnel_schlick(albedo, metallic, n_dot_v)
    w = ((f[..., 0:1] + f[..., 1:2]) + f[..., 2:3]) * (1.0 / 3.0)
    return torch.where(m >= 1.0, 1.0, torch.where(m <= 0.0, 0.0, w))


def brdf_sample_hemisphere(normal, view, albedo, metallic, roughness, u_sel, u1, u2):
    """Fresnel-weighted GGX/cosine mixture sample (MathUtils.cuh:192-244).

    ``u_sel`` picks the lobe (``u_sel <= wSpec`` → GGX), then ``(u1, u2)``
    feed that lobe.  Returns ``(L, mixture_pdf)``.
    """
    w_spec = specular_weight(normal, view, albedo, metallic)
    l_spec, pdf_spec_s = ggx_sample_hemisphere(normal, view, roughness, u1, u2)
    l_diff = cosine_sample_hemisphere(normal, u1, u2)

    take_spec = _tail1(u_sel, normal) <= w_spec
    l = torch.where(take_spec, l_spec, l_diff)

    cos_theta = torch.clamp_min(dot3(normal, l), 0.0)
    pdf_diff = cosine_hemisphere_pdf(cos_theta)[..., 0]
    pdf_spec = torch.where(take_spec[..., 0], pdf_spec_s,
                           ggx_hemisphere_pdf(normal, view, l, roughness))
    pdf = w_spec[..., 0] * pdf_spec + (1.0 - w_spec[..., 0]) * pdf_diff
    return l, pdf


def brdf_hemisphere_pdf(normal, view, l, albedo, metallic, roughness):
    """Mixture pdf of ``l`` (MathUtils.cuh:246-274)."""
    w_spec = specular_weight(normal, view, albedo, metallic)[..., 0]
    pdf_spec = ggx_hemisphere_pdf(normal, view, l, roughness)
    cos_theta = torch.clamp_min(dot3(normal, l), 0.0)[..., 0]
    return w_spec * pdf_spec + (1.0 - w_spec) * cosine_hemisphere_pdf(cos_theta)


def cook_torrance_brdf(normal, view, l, albedo, metallic, roughness):
    """Cook-Torrance: Lambert diffuse + GGX specular (MathUtils.cuh:276-317).

    Not premultiplied by cosθ; zero when N·L or N·V is non-positive.
    """
    m = _tail1(metallic, normal)
    r = _tail1(roughness, normal)
    a = r * r
    a2 = a * a

    h = normalize(view + l)
    n_dot_l = torch.clamp_min(dot3(normal, l), 0.0)
    n_dot_v = torch.clamp_min(dot3(normal, view), 0.0)
    n_dot_h = torch.clamp_min(dot3(normal, h), 0.0)
    v_dot_h = torch.clamp_min(dot3(view, h), 0.0)

    f0 = 0.04 * (1.0 - m) + albedo * m
    f = f0 + (1.0 - f0) * (1.0 - v_dot_h) ** 5.0

    k = r / 2.0
    g_v = n_dot_v / torch.clamp_min(n_dot_v * (1.0 - k) + k, 1e-12)
    g_l = n_dot_l / torch.clamp_min(n_dot_l * (1.0 - k) + k, 1e-12)
    g = g_v * g_l

    diffuse = (1.0 - f) * albedo * INV_PI

    denom = (n_dot_h * n_dot_h) * (a2 - 1.0) + 1.0
    d = a2 * INV_PI / torch.clamp_min(denom * denom, 1e-12)

    specular = (d * g * f) / torch.clamp_min(4.0 * n_dot_v * n_dot_l, 1e-12)
    return torch.where((n_dot_l > 0.0) & (n_dot_v > 0.0), diffuse + specular, 0.0)
