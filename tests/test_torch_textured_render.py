"""The port's textured megakernel plain versions and training step against
the JAX package, at matched seeds.

The textured Cornell box of tests/test_textured_megakernel.py:16-26 (a 64²
checker on a floor quad) with a seeded 512² noise texture on a quad before
the back wall, whose UVs wrap and go negative (``torch_textured_scene``).
The kernels' primary level box-filters that page to 256², as the JAX
megakernels' does (``prepare_texture_tables``), so the plain versions here
read the kernel's levels and are held against the JAX megakernels in Pallas
interpret mode, the triangles in Morton order on both sides:

  * K2's plain version (``MegakernelRenderer`` on the CPU) under NEE and
    cosine, 2 frames: the gates of tests/test_render_parity.py:111-114;
  * ReSTIR DI's and mono ReSTIR GI's, 2 frames, with the 3% pixel allowance
    of their untextured static-camera tests (ROADMAP queue 3);
  * the textured DI mean within 5% of light sampling's, and textured GI
    finite with a mean above 0.01 (tests/test_textured_megakernel.py:54-85);
  * one ``make_train_step`` step on the textured scene at 16² (NEE): loss
    and material gradients against the JAX step's, masked to the pixels
    whose forward values agree within 1e-4 (tests/test_torch_gradients.py).

The kernels' own checks against these plain versions are in
test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fypraytracer_tpu.config import RenderSettings as JSettings
from fypraytracer_tpu.config import SamplingTechnique as JTech
from fypraytracer_tpu.core.camera import Camera as JCamera
from fypraytracer_tpu.render.megakernel import MegakernelRenderer as JMegakernel
from fypraytracer_tpu.render.megakernel_restir import MegakernelReSTIRDI as JMegakernelDI
from fypraytracer_tpu.render.megakernel_restir_gi import MegakernelReSTIRGI as JMegakernelGI
from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.core.camera import Camera, generate_rays
from fypraytracer_tpu_torch.ops.traverse import pick_tracer
from fypraytracer_tpu_torch.parallel.shard import make_train_step
from fypraytracer_tpu_torch.render import integrators as tint
from fypraytracer_tpu_torch.render import megakernel as tmk
from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer, morton_permuted_scene
from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
from fypraytracer_tpu_torch.render.megakernel_restir_gi import MegakernelReSTIRGI
from fypraytracer_tpu_torch.render.renderer import Renderer
from fypraytracer_tpu_torch.scene.types import scene_from_arrays
from torch_textured_scene import jax_textured, port_textured

W = H = 32
FRAMES = 2
SKY = (0.05, 0.06, 0.08)
BIG = 512
POS = (0.013, 1.011, 2.6)      # just off the box's symmetry plane
STATIC_PX_SHARE = 0.03


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene in Morton order, JAX camera)."""
    js, jcam = jax_textured(W, H, BIG)
    return js, morton_permuted_scene(port_textured(W, H, BIG)[0])[0], jcam


def _gates(got, ref, px_share=0.01):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    assert bool(np.isfinite(got).all())
    assert float(np.median(diff)) < 1e-5
    share = (diff.reshape(-1, 3).max(axis=-1) > 1e-3).mean()
    assert share < px_share, share
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.01


def _cams(pos):
    return (JCamera(position=pos, forward=(0, 0, -1), width=W, height=H),
            Camera(position=pos, forward=(0, 0, -1), width=W, height=H))


@pytest.mark.parametrize("tech", [SamplingTechnique.NEE_MIS, SamplingTechnique.COSINE], ids=lambda t: t.name)
def test_textured_megakernel_plain_matches_jax(scenes, tech):
    js, ts, cam = scenes
    kw = dict(bounces=2, samples=1, sky_color=(0.1, 0.15, 0.2))
    jmk = JMegakernel(js, cam, JSettings(technique=JTech(int(tech)), **kw), interpret=True)
    assert jmk.tex_tables is not None, "the JAX megakernel's texture tables are not engaged"
    ref = np.asarray(jmk.render_many(FRAMES))
    launches = tmk.megakernel.launches
    got = MegakernelRenderer(ts, cam, RenderSettings(technique=tech, **kw), device="cpu").render_many(FRAMES)
    assert tmk.megakernel.launches == launches                  # CPU tensors: no kernel
    _gates(got.numpy(), ref)


def test_textured_megakernel_plain_reads_the_kernel_levels(scenes):
    """The 512² page is box-filtered for the kernels: their plain version
    differs from the wavefront there (the documented deviation), and
    equals the wavefront over ``with_kernel_atlas``."""
    from fypraytracer_tpu_torch.ops.texture import with_kernel_atlas
    from fypraytracer_tpu_torch.render.renderer import frame_hdr

    _, ts, cam = scenes
    ts = ts.to("cpu")
    st = RenderSettings(technique=SamplingTechnique.NEE_MIS, bounces=2, samples=1, sky_color=SKY)
    mk = tmk.megakernel_plain(ts, cam, 1, 1, st)
    assert torch.equal(mk, frame_hdr(with_kernel_atlas(ts), cam, 1, st).reshape(-1, 3))
    assert not torch.equal(mk, frame_hdr(ts, cam, 1, st).reshape(-1, 3))


def test_textured_restir_di_megakernel_plain_matches_jax(scenes):
    js, ts, _ = scenes
    jcam, tcam = _cams(POS)
    jd = JMegakernelDI(js, jcam, JSettings(technique=JTech.RESTIR_DI), interpret=True)
    td = MegakernelReSTIRDI(ts, tcam, RenderSettings(technique=SamplingTechnique.RESTIR_DI), device="cpu")
    ref, got = np.asarray(jd.render_many(FRAMES)), td.render_many(FRAMES)
    _gates(got.numpy(), ref, STATIC_PX_SHARE)


def test_textured_restir_gi_mono_plain_matches_jax(scenes):
    js, _, _ = scenes
    kw = dict(bounces=2, spatial_neighbors=3, spatial_radius=8, sky_color=SKY)
    jcam, tcam = _cams(POS)
    jg = JMegakernelGI(js, jcam, JSettings(technique=JTech.RESTIR_GI, **kw), interpret=True)
    # the class renumbers the triangles in Morton order itself
    tg = MegakernelReSTIRGI(port_textured(W, H, BIG)[0], tcam, RenderSettings(technique=SamplingTechnique.RESTIR_GI,
                                                                               **kw), device="cpu")
    ref, got = np.asarray(jg.render_many(FRAMES)), tg.render_many(FRAMES)
    _gates(got.numpy(), ref, STATIC_PX_SHARE)


def test_textured_restir_di_unbiased():
    """tests/test_textured_megakernel.py:54-72 on the port: the DI plain
    version's mean over 6 frames within 5% of light sampling's at 4 spp."""
    scene, cam = port_textured(W, H)
    sdi = RenderSettings(technique=SamplingTechnique.RESTIR_DI, light_candidates=4, spatial_neighbors=2,
                         spatial_radius=6)
    img = MegakernelReSTIRDI(scene, cam, sdi, device="cpu").render_many(6)
    r = Renderer(scene, cam, RenderSettings(technique=SamplingTechnique.LIGHT_SOURCE, samples=4), device="cpu")
    ref = r.render_many(6)
    assert bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - float(ref.mean())) / float(ref.mean()) < 0.05


def test_textured_restir_gi_runs():
    """tests/test_textured_megakernel.py:75-85 on the port."""
    scene, cam = port_textured(W, H)
    sgi = RenderSettings(technique=SamplingTechnique.RESTIR_GI, bounces=2, spatial_neighbors=2, spatial_radius=6)
    img = MegakernelReSTIRGI(scene, cam, sgi, device="cpu").render_many(4)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01


def test_textured_train_step_matches_jax():
    """One SGD step of ``make_train_step`` under NEE on the textured scene at
    16² (lr 1, so the step is the gradient) against ``jax.value_and_grad``
    of the JAX wavefront's loss, masked as tests/test_torch_gradients.py
    masks it: only the pixels whose forward values agree within 1e-4 count
    (a ray that grazes an edge takes another path under Möller–Trumbore
    than under Baldwin–Weber).  The port's step takes the mask through its
    target: the true-albedo frame on the mask, its own frame elsewhere, so
    that the pixels off the mask add nothing to its loss or gradient."""
    from fypraytracer_tpu.core.camera import generate_rays as jrays
    from fypraytracer_tpu.ops.dense import pick_tracer as jpick
    from fypraytracer_tpu.render.integrators import radiance_nee_mis as jnee

    w = h = 16
    n = w * h
    js, jcam = jax_textured(w, h, BIG)
    ts = scene_from_arrays(js, "cpu")
    kw = dict(bounces=2, samples=1, sky_color=SKY)
    st, jst = RenderSettings(technique=SamplingTechnique.NEE_MIS, **kw), JSettings(technique=JTech.NEE_MIS, **kw)
    alb = np.asarray(js.materials.albedo)
    start = np.clip(alb + np.random.default_rng(0).normal(0.0, 0.25, alb.shape), 0.05, 0.95).astype(np.float32)

    o, d = generate_rays(jcam.inv_projection, jcam.inv_view, w, h, device="cpu")
    pix = torch.arange(n)
    with torch.no_grad():
        target = tint.radiance_nee_mis(ts, pick_tracer(ts), o, d, pix, 1, st).numpy()
        t_img = tint.radiance_nee_mis(dataclasses.replace(ts, materials=dataclasses.replace(
            ts.materials, albedo=torch.as_tensor(start))), pick_tracer(ts), o, d, pix, 1, st).numpy()

    jmats = jax.tree_util.tree_map(jnp.asarray, js.materials)
    jo, jd = jrays(jcam.inv_projection, jcam.inv_view, w, h, xp=jnp)

    def jimg(albedo):
        sc = dataclasses.replace(js, materials=dataclasses.replace(jmats, albedo=albedo))
        return jnee(sc, jpick(sc, "dense"), jo, jd, jnp.arange(n, dtype=jnp.uint32), jnp.uint32(1), jst)

    mask = np.abs(t_img - np.asarray(jimg(jnp.asarray(start)))).max(-1) <= 1e-4
    assert mask.mean() > 0.9, int((~mask).sum())

    def jloss(albedo):
        err = (jimg(albedo) - jnp.asarray(target)) * jnp.asarray(mask, jnp.float32)[:, None]
        return jnp.sum(err * err) / (n * 3)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(start))
    step = make_train_step(ts, w, h, st, lr=1.0, technique="nee", device="cpu", fields=("albedo",))
    new, loss = step(dataclasses.replace(ts.materials, albedo=torch.as_tensor(start)), jcam.inv_projection,
                     jcam.inv_view, 1, torch.as_tensor(np.where(mask[:, None], target, t_img)))
    assert abs(float(loss) - float(jl)) <= 1e-4 * float(jl), (float(loss), float(jl))
    g, jg = start - new.albedo.numpy(), np.asarray(jg)
    assert np.abs(jg).max() > 0.0
    assert np.abs(g - jg).max() <= 1e-3 * np.abs(jg).max(), (np.abs(g - jg).max(), np.abs(jg).max())
