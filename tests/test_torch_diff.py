"""The fused differentiable step (K8's function) against the JAX kernel and
against torch autograd of the port's cosine wavefront.

``diff_plain`` is the plain PyTorch version of ``csrc/megakernel_diff.cu``;
the card tests hold the kernel against it (test_torch_cuda.py).  Here it is
held against the JAX ``DiffRenderer`` in Pallas interpret mode (the setup of
tests/test_diff_megakernel.py: Cornell 32² with coarse spheres, 2 bounces,
frame 3, target 0.1; also 1 and 4 bounces at 16²) and against autograd of
the port's ``radiance_hemisphere(..., "cosine")``.  Gates: the loss within
1e-4 relative, the gradient within 1e-3 of its largest entry.
"""

import dataclasses
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fypraytracer_tpu.scene.procedural as jproc
from fypraytracer_tpu.render.megakernel import _pick_ray_lanes
from fypraytracer_tpu.render.megakernel_diff import DiffRenderer as JDiffRenderer
from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.core.camera import generate_rays
from fypraytracer_tpu_torch.ops.traverse import pick_tracer
from fypraytracer_tpu_torch.render import megakernel_diff as md
from fypraytracer_tpu_torch.render.integrators import radiance_hemisphere
from fypraytracer_tpu_torch.scene.types import materials_from_arrays, scene_from_arrays, with_materials

SKY = (0.05, 0.06, 0.08)
CASES = [(32, 2), (16, 1), (16, 4)]      # (size, bounces)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _scenes(size):
    """The JAX scene, its arrays as the port's scene, and the camera."""
    builder, cam = jproc.cornell_box(width=size, height=size, sphere_res=(6, 10))
    jscene = builder.compile(native=False)
    return jscene, scene_from_arrays(jscene, "cpu"), cam


@functools.lru_cache(maxsize=None)
def _jax_renderer(size, bounces):
    """The JAX DiffRenderer in interpret mode: one compile a shape (~7 s)."""
    jscene, _, cam = _scenes(size)
    return JDiffRenderer(jscene, cam, bounces=bounces, sky_color=SKY, interpret=True)


def _target(size, value=0.1):
    return np.zeros((size * size, 3), np.float32) + value


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-9)


def _d_mat(scene, d_tri):
    return torch.zeros(scene.materials.albedo.shape).index_add_(0, scene.geometry.tri_mat.long(), d_tri)


@pytest.mark.parametrize("size, bounces", CASES)
def test_diff_plain_matches_jax_kernel(size, bounces):
    jscene, scene, cam = _scenes(size)
    jdr = _jax_renderer(size, bounces)
    tgt = _target(size)
    jalb = jnp.asarray(jscene.materials.albedo)
    j_loss, j_dmat = jdr.loss_and_grad(jalb, tgt, 3)
    # the JAX kernel's per-triangle gradient, before its segment sum
    P, AT = jdr._tables(jalb)
    C = _pick_ray_lanes(size * size)
    tb = jnp.asarray(tgt).reshape(-1, C, 3).transpose(0, 2, 1)
    tb = jnp.concatenate([tb, jnp.zeros((tb.shape[0], 5, C), jnp.float32)], axis=1).reshape(-1, C)
    cam_m = jnp.concatenate([jnp.asarray(cam.inv_projection), jnp.asarray(cam.inv_view)], axis=0)
    _, dA = jdr._fn(cam_m, P, AT, tb, jnp.asarray([[3]], jnp.int32))
    j_dtri = np.asarray(dA)[:jdr.n_tris, 0:3]

    loss, d_tri = md.diff_plain(scene, cam, scene.materials.albedo, torch.as_tensor(tgt), 3, bounces, SKY)
    assert abs(float(loss) - float(j_loss)) / float(j_loss) < 1e-4
    assert _rel(_d_mat(scene, d_tri), j_dmat) < 1e-3
    assert _rel(d_tri, j_dtri) < 1e-3


@pytest.mark.parametrize("size, bounces", CASES)
def test_diff_plain_matches_autograd_of_the_wavefront(size, bounces):
    """The analytic reverse scan is the autodiff gradient of the cosine
    wavefront: directions do not depend on albedo under cosine sampling."""
    _, scene, cam = _scenes(size)
    B = size * size
    tgt = torch.as_tensor(_target(size))
    settings = RenderSettings(technique=SamplingTechnique.COSINE, bounces=bounces, samples=1, sky_color=SKY)
    alb = scene.materials.albedo.clone().requires_grad_(True)
    sc = with_materials(scene, dataclasses.replace(scene.materials, albedo=alb))
    o, d = generate_rays(cam.inv_projection, cam.inv_view, size, size)
    hdr = radiance_hemisphere(sc, pick_tracer(sc), o, d, torch.arange(B), 3, settings, "cosine")
    ref = ((hdr - tgt) ** 2).sum() / (3 * B)
    ref.backward()

    loss, d_tri = md.diff_plain(scene, cam, scene.materials.albedo, tgt, 3, bounces, SKY)
    assert abs(float(loss) - ref.item()) / ref.item() < 1e-4
    assert _rel(_d_mat(scene, d_tri), alb.grad) < 1e-3


def test_diff_loss_backward_scales_the_kernel_gradient():
    """``DiffLoss``: the forward is one fused launch (the plain version on
    the CPU), the backward hands back incoming gradient x d_mat, and the
    target gets none."""
    _, scene, cam = _scenes(16)
    dr = md.DiffRenderer(scene, cam, bounces=2, sky_color=SKY, device="cpu")
    albedo = scene.materials.albedo.clone().requires_grad_(True)
    target = torch.as_tensor(_target(16)).requires_grad_(True)
    launches = md.diff_megakernel.launches
    loss = md.DiffLoss.apply(albedo, target, 3, dr) * 2.5
    loss.backward()
    ref_loss, d_mat = dr.loss_and_grad(scene.materials.albedo, _target(16), 3)
    assert md.diff_megakernel.launches == launches            # no kernel on the CPU
    assert float(loss) == pytest.approx(2.5 * float(ref_loss), rel=1e-6)
    torch.testing.assert_close(albedo.grad, 2.5 * d_mat)
    assert target.grad is None


def _perturbed(albedo, sigma, seed):
    rng = np.random.default_rng(seed)
    return np.clip(np.asarray(albedo) + sigma * rng.normal(size=np.shape(albedo)), 0.05, 0.95).astype(np.float32)


def test_diff_renderer_recovers_albedo():
    """tests/test_diff_megakernel.py:69-109 on the port: perturb the albedos,
    take 9 fused steps at lr 3.0 against the wavefront's frames 1-3."""
    _, scene, cam = _scenes(32)
    settings = RenderSettings(technique=SamplingTechnique.COSINE, bounces=2, samples=1, sky_color=SKY)
    o, d = generate_rays(cam.inv_projection, cam.inv_view, 32, 32)
    tgts = {f: radiance_hemisphere(scene, pick_tracer(scene), o, d, torch.arange(32 * 32), f, settings, "cosine")
            for f in (1, 2, 3)}
    dr = md.DiffRenderer(scene, cam, bounces=2, sky_color=SKY, device="cpu")
    true_alb = scene.materials.albedo
    alb = torch.as_tensor(_perturbed(true_alb, 0.2, 0))
    err0 = float((alb - true_alb).abs().mean())
    losses = []
    for i in range(9):
        f = 1 + i % 3
        alb, loss = dr.step(alb, tgts[f], f, lr=3.0)
        alb = torch.clamp(alb, 0.0, 1.0)
        losses.append(float(loss))
    err1 = float((alb - true_alb).abs().mean())
    assert err1 < 0.6 * err0, (err0, err1, losses)
    assert losses[-1] < losses[0]


def test_diff_renderer_steps_match_jax():
    """Three fused steps at lr 3.0 from one NumPy-perturbed albedo through the
    JAX ``DiffRenderer`` and the port's, the albedo handed across with
    ``materials_from_arrays``, against the constant target 0.1 of
    tests/test_diff_megakernel.py: the losses agree step by step within 1e-4
    (2-7e-5 on the CPU).  Against a target rendered from the true albedo the
    loss is 50x smaller and the few edge pixels where the two tracers part
    weigh 10-50x more."""
    jscene, scene, cam = _scenes(32)
    jdr = _jax_renderer(32, 2)
    dr = md.DiffRenderer(scene, cam, bounces=2, sky_color=SKY, device="cpu")
    mats = dataclasses.replace(jscene.materials, albedo=_perturbed(jscene.materials.albedo, 0.25, 1))
    j_alb = jnp.asarray(mats.albedo)
    t_alb = materials_from_arrays(mats, "cpu").albedo
    tgt = _target(32)
    for f in (1, 2, 3):
        j_alb, j_loss = jdr.step(j_alb, tgt, f, lr=3.0)
        t_alb, t_loss = dr.step(t_alb, torch.as_tensor(tgt), f, lr=3.0)
        j_alb, t_alb = jnp.clip(j_alb, 0.0, 1.0), torch.clamp(t_alb, 0.0, 1.0)
        assert abs(float(t_loss) - float(j_loss)) / float(j_loss) < 1e-4, (f, float(t_loss), float(j_loss))
    assert _rel(t_alb, j_alb) < 1e-3


def test_diff_renderer_refuses_what_it_cannot_do():
    """No fallback: more than 4 bounces and textured scenes raise; the
    default device is the card."""
    _, scene, cam = _scenes(16)
    with pytest.raises(ValueError, match="1-4 bounces"):
        md.DiffRenderer(scene, cam, bounces=5, device="cpu")
    with pytest.raises(ValueError, match="1-4 bounces"):
        md.diff_plain(scene, cam, scene.materials.albedo, torch.as_tensor(_target(16)), 1, 0, SKY)
    textured = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, albedo_map=torch.zeros_like(scene.materials.albedo_map)))
    with pytest.raises(NotImplementedError, match="textured"):
        md.DiffRenderer(textured, cam, device="cpu")
    assert inspect.signature(md.DiffRenderer).parameters["device"].default == "cuda"


def test_kernel_build_fault_raises(monkeypatch, tmp_path):
    """A kernel whose library cannot be built raises; nothing falls back."""
    from fypraytracer_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "find_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load("megakernel_diff", "fyp_diff_megakernel", md._ARGTYPES)
    assert "megakernel_diff" not in kernels._libs
