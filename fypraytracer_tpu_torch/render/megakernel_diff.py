"""Fused differentiable render step: the loss of one cosine-sampled frame
against a target and its gradient with respect to per-triangle albedo, in
one kernel launch.

The torch counterpart of ``fypraytracer_tpu/render/megakernel_diff.py``.
``diff_megakernel`` wraps the hand-written CUDA kernel
``csrc/megakernel_diff.cu`` (K8), which replaces the TPU kernel
``make_diff_megakernel`` → ``kernel`` (megakernel_diff.py:117, launched at
:241): one thread per pixel runs the cosine path of one frame and one
sample, its rays walked through the scene's 4-wide BVH (``Scene.wide``,
the stacks in shared memory), keeps each scatter level's throughput factor
g, its derivative dg/d(albedo) and triangle id in registers, forms the
squared error against the target, and scans the levels in reverse.  Radiance is
``r_c = Σ_l T_l,c · e_l,c`` with ``T_l = Π_{j≤l} g_j``, so
``dr_c/dg_j,c = suffix_j,c / g_j,c`` (suffix: the contributions of level j
and later); under cosine sampling the directions do not depend on albedo,
so this is exactly the autodiff gradient of the wavefront estimator.

``diff_plain`` is its plain PyTorch version (the tests and the CPU use it;
nothing on the card's main path does).  The wrapper takes it for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
``diff_megakernel.launches`` counts kernel launches.

``DiffLoss`` is the ``torch.autograd.Function`` around one launch: its
forward keeps d(loss)/d(material albedo), which its backward scales.
``DiffRenderer`` is the training entry point (``loss_and_grad``, ``step``),
driven as the JAX CLI's ``_train_fast`` drives the JAX class.  The triangles
keep the scene's own order, as in the JAX ``DiffRenderer``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from fypraytracer_tpu_torch.core import rng
from fypraytracer_tpu_torch.core.camera import Camera, generate_rays
from fypraytracer_tpu_torch.core.mathutils import INV_PI, cosine_sample_hemisphere, dot3
from fypraytracer_tpu_torch.ops import kernels
from fypraytracer_tpu_torch.ops.texture import scene_is_textured
from fypraytracer_tpu_torch.ops.traverse import OverflowWatch, trace_rays
from fypraytracer_tpu_torch.render.integrators import ORIGIN_EPS
from fypraytracer_tpu_torch.render.restir_common import (
    TILE_BLOCK,
    camera_matrices,
    hit_surface,
    tile_walk_records,
    wide_args,
)
from fypraytracer_tpu_torch.scene.types import Scene, with_materials

MAX_BOUNCES = 4   # the kernel keeps every level in registers (megakernel_diff.py:114)


def _norm3(v):
    """v · rsqrt(|v|² + 1e-20), as the JAX kernel's ``_norm3``."""
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    return v * torch.rsqrt(x * x + y * y + z * z + 1e-20)[:, None]


def f_and_dfdalb(n, view, l, alb, rough, metal):
    """The Cook–Torrance BRDF f (B, 3) and df_c/d(alb_c) (B, 3), term for term
    as the JAX kernel's ``_f_and_dfdalb`` (megakernel_diff.py:67-96): the
    c-th albedo channel changes only the c-th BRDF channel."""
    h = _norm3(view + l)
    ndl = torch.clamp_min(dot3(n, l, keepdims=False), 0.0)
    ndv = torch.clamp_min(dot3(n, view, keepdims=False), 0.0)
    ndh = torch.clamp_min(dot3(n, h, keepdims=False), 0.0)
    vdh = torch.clamp_min(dot3(view, h, keepdims=False), 0.0)
    a = rough * rough
    a2 = a * a
    k = rough * 0.5
    g = (ndv / torch.clamp_min(ndv * (1.0 - k) + k, 1e-12)) \
        * (ndl / torch.clamp_min(ndl * (1.0 - k) + k, 1e-12))
    den = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 * INV_PI / torch.clamp_min(den * den, 1e-12)
    spec_s = (d * g / torch.clamp_min(4.0 * ndv * ndl, 1e-12))[:, None]
    s5 = ((1.0 - vdh) ** 5.0)[:, None]
    live = ((ndl > 0.0) & (ndv > 0.0))[:, None]
    m = metal[:, None]
    f0 = 0.04 * (1.0 - m) + alb * m
    fr = f0 + (1.0 - f0) * s5
    dfr = m * (1.0 - s5)
    fc = (1.0 - fr) * alb * INV_PI + spec_s * fr
    dfc = (1.0 - fr) * INV_PI + dfr * (spec_s - alb * INV_PI)
    return torch.where(live, fc, 0.0), torch.where(live, dfc, 0.0)


def _check_bounces(bounces: int) -> None:
    if not 1 <= bounces <= MAX_BOUNCES:
        raise ValueError(f"the diff kernel unrolls 1-{MAX_BOUNCES} bounces, got {bounces}")


def diff_plain(scene: Scene, camera: Camera, albedo, target, frame: int, bounces: int, sky):
    """``(loss, d_tri)``: the squared-error loss of one cosine-sampled frame
    (1 spp) against ``target`` (H·W, 3), ``Σ (r - target)² / (3·H·W)``, and
    its gradient with respect to each triangle's albedo (T, 3), with the
    scene's albedo replaced by ``albedo`` (M, 3).  K8's function in PyTorch
    over all pixels at once, with the plain BVH walk; a level traces only
    the rays of live paths, as K8 does."""
    _check_bounces(bounces)
    geo = scene.geometry
    dev = geo.positions.device
    # the flat albedo of every material, as K8 reads it (the JAX kernel has
    # no textured path)
    mats = dataclasses.replace(scene.materials, albedo=albedo.detach().to(torch.float32),
                               albedo_map=torch.full_like(torch.as_tensor(scene.materials.albedo_map), -1))
    sc = with_materials(scene, mats)
    sky = torch.as_tensor(sky, dtype=torch.float32, device=dev)
    B = camera.width * camera.height
    tgt = target.detach().reshape(B, 3).to(torch.float32)
    o, d = generate_rays(camera.inv_projection, camera.inv_view, camera.width, camera.height, device=dev)

    def trace(ray_o, ray_d, live):
        """Triangle ids (B,) of the live rays' closest hits, -1 elsewhere."""
        idx = torch.nonzero(live).squeeze(1)
        tri = torch.full((B,), -1, dtype=torch.int32, device=dev)
        tri[idx] = trace_rays(scene.bvh, geo, ray_o[idx], ray_d[idx])["tri"]
        return tri

    tri0 = trace(o, d, torch.ones(B, dtype=torch.bool, device=dev))
    surf = hit_surface(sc, o, d, tri0)
    prim_emissive = surf["hit"] & (dot3(surf["em"], surf["em"], keepdims=False) > 0.0)
    em0 = surf["em"]
    active = surf["hit"] & ~prim_emissive

    key = rng.path_key(torch.arange(B, device=dev), frame, 0)
    thr = torch.ones((B, 3), dtype=torch.float32, device=dev)
    rad = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    view, lvl_tri, levels = -d, tri0, []
    for _ in range(bounces):
        key, (u1, u2) = rng.uniforms(key, 2)
        l = cosine_sample_hemisphere(surf["n"], u1, u2)
        cos_t = torch.clamp_min(dot3(l, surf["n"], keepdims=False), 0.0)
        pdf = cos_t * INV_PI
        ok = pdf > 0.0
        f, df = f_and_dfdalb(surf["n"], view, l, surf["alb"], surf["rough"], surf["metal"])
        scale = (cos_t / torch.where(ok, pdf, 1.0))[:, None]
        active = active & ok
        g = torch.where(active[:, None], f * scale, 0.0)
        dg = torch.where(active[:, None], df * scale, 0.0)
        tri = torch.where(active, lvl_tri, -1)
        thr = thr * g

        ray_o = surf["pos"] + surf["n"] * ORIGIN_EPS
        hit_tri = trace(ray_o, l, active)
        nxt = hit_surface(sc, ray_o, l, hit_tri)
        em_hit = nxt["hit"] & (dot3(nxt["em"], nxt["em"], keepdims=False) > 0.0)
        contrib = torch.where((active & ~nxt["hit"])[:, None], thr * sky, 0.0) \
            + torch.where((active & em_hit)[:, None], thr * nxt["em"], 0.0)
        rad = rad + contrib
        active = active & nxt["hit"] & ~em_hit
        levels.append((g, dg, tri, contrib))
        view, lvl_tri, surf = -l, hit_tri, nxt

    out = torch.where((tri0 >= 0)[:, None], rad, sky)
    out = torch.where(prim_emissive[:, None], em0, out)
    err = out - tgt
    loss = (err * err).sum() / float(3 * B)
    adj = 2.0 * err / float(3 * B)                          # d loss / d r

    d_tri = torch.zeros((geo.tri_v.shape[0], 3), dtype=torch.float32, device=dev)
    suffix = torch.zeros_like(rad)
    for g, dg, tri, contrib in reversed(levels):
        suffix = suffix + contrib
        gok = g > 0.0
        gsel = torch.where(gok, adj * suffix * dg / torch.where(gok, g, 1.0), 0.0)
        hit = tri >= 0
        d_tri.index_add_(0, tri[hit].long(), gsel[hit])
    return loss, d_tri


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int]
    + [ctypes.c_float] * 3                                   # sky
    + [ctypes.c_void_p] * 4 + [ctypes.c_int]                 # geometry, triangle count
    + [ctypes.c_void_p] * 4                                  # materials
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]                 # wide bvh
    + [ctypes.c_void_p] * 4)                                 # target, loss, d_tri, stream


def diff_megakernel(scene: Scene, camera: Camera, albedo, target, frame: int, bounces: int, sky,
                    cam=None):
    """``(loss (0-d), d_tri (T, 3))`` of ``diff_plain`` through the CUDA
    kernel ``csrc/megakernel_diff.cu`` (plain version for CPU tensors),
    which walks the scene's wide BVH in blocks of ``TILE_BLOCK`` threads: a
    scene without ``Scene.wide``, or whose tree needs more stack than such
    a block holds, is refused before anything launches.  ``cam``: the (2,
    4, 4) camera tensor on the card (``restir_common.camera_matrices``),
    made here when not given."""
    _check_bounces(bounces)
    dev = scene.geometry.positions.device
    if dev.type == "cpu":
        return diff_plain(scene, camera, albedo, target, frame, bounces, sky)
    B = camera.width * camera.height
    g, m = scene.geometry, scene.materials
    wide = tile_walk_records("diff_megakernel", scene, TILE_BLOCK)
    cam = camera_matrices(camera, dev) if cam is None else cam
    albedo = albedo.detach()
    target = target.detach().reshape(B, 3)
    emission = m.emission().contiguous()
    if albedo.shape != m.albedo.shape:
        raise ValueError(f"diff_megakernel: albedo must be {tuple(m.albedo.shape)}, got {tuple(albedo.shape)}")
    kernels.check_inputs(
        "diff_megakernel",
        floats=(cam, albedo, target, g.positions, g.normals, m.roughness, m.metallic, emission, wide.nodes,
                wide.tris),
        ints=(g.tri_v, g.tri_mat, wide.overflow))
    fn = kernels.load("megakernel_diff", "fyp_diff_megakernel", _ARGTYPES)
    loss = torch.empty(1, dtype=torch.float32, device=dev)
    d_tri = torch.empty((g.tri_v.shape[0], 3), dtype=torch.float32, device=dev)
    P = kernels.ptr
    rc = fn(P(cam), camera.width, camera.height, int(frame) & 0xFFFFFFFF, bounces,
            *(float(c) for c in sky),
            P(g.positions), P(g.normals), P(g.tri_v), P(g.tri_mat), g.tri_v.shape[0],
            P(albedo), P(m.roughness), P(m.metallic), P(emission),
            *wide_args(wide),
            P(target), P(loss), P(d_tri), kernels.stream_ptr(dev))
    diff_megakernel.launches += 1
    kernels.check(rc, "diff_megakernel")
    return loss[0], d_tri


diff_megakernel.launches = 0


class DiffLoss(torch.autograd.Function):
    """The loss of one frame as a differentiable function of the material
    albedo: ``DiffLoss.apply(albedo, target, frame, renderer)``.  The forward
    runs the fused kernel once and keeps d(loss)/d(albedo) (M, 3); the
    backward scales it by the incoming gradient.  ``target`` and ``frame``
    get no gradient.  The renderer is a fourth argument because a
    Function's forward is a static method."""

    @staticmethod
    def forward(ctx, albedo, target, frame, renderer):
        loss, d_mat = renderer.loss_and_grad(albedo, target, frame)
        ctx.save_for_backward(d_mat)
        return loss

    @staticmethod
    def backward(ctx, g):
        (d_mat,) = ctx.saved_tensors
        return g * d_mat, None, None, None


class DiffRenderer:
    """Fast inverse-rendering step: cosine-frame loss and albedo gradient.

    Usage::
        dr = DiffRenderer(scene, camera, bounces=2, device="cuda")
        albedo, loss = dr.step(albedo, target_hdr, frame, lr=0.2)
    """

    def __init__(self, scene: Scene, camera: Camera, bounces: int = 2,
                 sky_color=(0.05, 0.06, 0.08), device="cuda"):
        _check_bounces(bounces)
        self.device = torch.device(device)
        self.camera = camera
        self.bounces = bounces
        self.sky_color = tuple(float(c) for c in sky_color)
        self._cam = camera_matrices(camera, self.device) if self.device.type == "cuda" else None
        self.set_scene(scene)

    def set_scene(self, scene: Scene):
        """Train on ``scene`` from now on (``SceneManager.apply``): on the
        device, with its material ids, material count and overflow watch
        made anew.  A textured scene raises."""
        if scene_is_textured(scene):
            raise NotImplementedError(
                "DiffRenderer does not train textured scenes: its kernel differentiates the flat albedo, "
                "as the JAX kernel does (megakernel_diff.py has no textured path); make_train_step trains "
                "through the textured wavefront")
        self.scene = scene.to(self.device)
        self.tri_mat = self.scene.geometry.tri_mat.long()
        self.n_mats = self.scene.materials.albedo.shape[0]
        self.overflow = OverflowWatch(self.scene)

    def loss_and_grad(self, albedo, target_hdr, frame: int):
        """``(loss, dL/d albedo (M, 3))`` of one frame: one kernel launch and
        the segment sum of the per-triangle gradient to materials."""
        self.overflow.poll()
        albedo = torch.as_tensor(albedo, dtype=torch.float32, device=self.device)
        target = torch.as_tensor(target_hdr, dtype=torch.float32, device=self.device)
        loss, d_tri = diff_megakernel(self.scene, self.camera, albedo.contiguous(), target.contiguous(),
                                      frame, self.bounces, self.sky_color, cam=self._cam)
        d_mat = torch.zeros((self.n_mats, 3), dtype=torch.float32, device=self.device)
        d_mat.index_add_(0, self.tri_mat, d_tri)
        self.overflow.queue()
        return loss, d_mat

    def step(self, albedo, target_hdr, frame: int, lr: float = 0.2):
        """One SGD step: ``(albedo - lr · grad, loss)``."""
        albedo = torch.as_tensor(albedo, dtype=torch.float32, device=self.device)
        loss, grad = self.loss_and_grad(albedo, target_hdr, frame)
        return albedo - lr * grad, loss
