"""The port's texture fetch and textured wavefronts against the JAX package.

``ops/texture.py`` against ``fypraytracer_tpu/ops/texture.py`` on 4,096
UVs in [-2, 3] (negative and wrapped) over an atlas of three textures of
unequal native size (max |Δ| <= 1e-6), ``kernel_atlas`` against the JAX
``prepare_texture_tables`` (bit for bit, the 512² page box-filtered to
256²), the fetch's autograd against ``jax.grad`` (1e-6), and the textured
wavefronts (``Renderer`` under NEE, cosine, ReSTIR DI and ReSTIR GI) on the
textured Cornell box of tests/test_textured_megakernel.py with a seeded
512² texture besides its checker, against the JAX ``Renderer`` under the
gates of tests/test_render_parity.py:111-114 (ReSTIR with the 3% pixel
allowance of its static-camera tests, ROADMAP queue 3).  Also: the plain
walks never set the stack-overflow flag.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fypraytracer_tpu.config import RenderSettings as JSettings
from fypraytracer_tpu.config import SamplingTechnique as JTech
from fypraytracer_tpu.core.camera import Camera as JCamera
from fypraytracer_tpu.ops import texture as jtex
from fypraytracer_tpu.render.megakernel import prepare_texture_tables
from fypraytracer_tpu.render.renderer import Renderer as JRenderer
from fypraytracer_tpu.scene.build import pack_atlas as jpack_atlas
from fypraytracer_tpu.scene.types import TextureAtlas as JAtlas
from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.core.camera import Camera
from fypraytracer_tpu_torch.ops import texture as ttex
from fypraytracer_tpu_torch.render.renderer import Renderer
from fypraytracer_tpu_torch.scene.build import pack_atlas
from fypraytracer_tpu_torch.scene.types import TextureAtlas
from torch_skewed_bvh import skewed_scene
from torch_textured_scene import jax_textured, port_textured

W = H = 32
SKY = (0.05, 0.06, 0.08)
BIG = 512
# just off the box's symmetry plane, as the untextured ReSTIR tests
POS = (0.013, 1.011, 2.6)
STATIC_PX_SHARE = 0.03


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gates(got, ref, px_share=0.01):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    assert bool(np.isfinite(got).all())
    assert float(np.median(diff)) < 1e-5
    share = (diff.reshape(-1, 3).max(axis=-1) > 1e-3).mean()
    assert share < px_share, share
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.01


# ---- the fetch ----------------------------------------------------------------------

def _textures():
    """Three textures of unequal native size (the atlas resamples them to
    one page), seeded."""
    r = np.random.default_rng(7)
    return [r.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32) for h, w in ((48, 64), (16, 16), (64, 24))]


@pytest.fixture(scope="module")
def atlases():
    tex = _textures()
    return pack_atlas(tex, bounce_page=16), jpack_atlas(tex, bounce_page=16)


def _uvs(n=4096):
    r = np.random.default_rng(11)
    return (r.integers(-1, 4, n).astype(np.int32), r.uniform(-2.0, 3.0, n).astype(np.float32),
            r.uniform(-2.0, 3.0, n).astype(np.float32))


def test_pack_atlas_matches_jax(atlases):
    port, jx = atlases
    assert port.pages.shape == (3, 64, 64, 3) and port.bounce_pages.shape == (3, 16, 16, 3)
    for f in ("pages", "size", "bounce_pages"):
        np.testing.assert_array_equal(getattr(port, f), np.asarray(getattr(jx, f)))


@pytest.mark.parametrize("bounce", [False, True], ids=["mip0", "bounce"])
def test_sample_bilinear_matches_jax(atlases, bounce):
    port, jx = atlases
    tid, u, v = _uvs()
    atlas = TextureAtlas(**{k: torch.as_tensor(getattr(port, k)) for k in ("pages", "size", "bounce_pages")})
    got = ttex.sample_bilinear(atlas, torch.as_tensor(tid), torch.as_tensor(u), torch.as_tensor(v), bounce=bounce)
    ref = np.asarray(jtex.sample_bilinear(jx, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v), bounce=bounce))
    assert got.shape == (4096, 3) and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-6


def test_sample_nearest_matches_jax(atlases):
    port, jx = atlases
    tid, u, v = _uvs()
    atlas = TextureAtlas(pages=torch.as_tensor(port.pages), size=torch.as_tensor(port.size))
    got = ttex.sample_nearest(atlas, torch.as_tensor(tid), torch.as_tensor(u), torch.as_tensor(v))
    ref = np.asarray(jtex.sample_nearest(jx, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v)))
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-6


def _unpack(tx, dims):
    """JAX's fetch table TX[c·w + x, k·h + y] back to (K, h, w, 3) pages."""
    khp, h, w = dims
    tx = np.asarray(tx)[:3 * w]
    k = khp // h
    return tx.reshape(3, w, -1)[:, :, :k * h].reshape(3, w, k, h).transpose(2, 3, 1, 0)


@pytest.mark.parametrize("big", [0, BIG], ids=["native", "box_filtered"])
def test_kernel_atlas_matches_prepare_texture_tables(big):
    """The kernel's two levels, bit for bit: mip 0 box-filtered to at most
    256² (the 512² page) or kept (64²), and the bounce level."""
    scene, _ = port_textured(W, H, big)
    jscene, _ = jax_textured(W, H, big)
    ka = ttex.kernel_atlas(scene.textures)
    txp, txb, (dp, db) = prepare_texture_tables(jscene.textures)
    side = 256 if big else 64
    assert tuple(ka.pages.shape) == (2 if big else 1, side, side, 3)
    np.testing.assert_array_equal(ka.pages.numpy(), _unpack(txp, dp)[:ka.pages.shape[0]])
    np.testing.assert_array_equal(ka.bounce_pages.numpy(), _unpack(txb, db)[:ka.bounce_pages.shape[0]])
    if not big:
        assert ttex.kernel_atlas(ka).pages is ka.pages          # a level that fits is kept


def test_fetch_gradient_matches_jax():
    """Autograd of the bilinear fetch against ``jax.grad``, with respect to
    the texels (tests/test_gradients.py:407-425, on seeded pages) and to
    the UVs."""
    r = np.random.default_rng(5)
    pages = r.uniform(0.0, 1.0, (2, 8, 8, 3)).astype(np.float32)
    size = np.asarray([[8, 8], [8, 8]], np.int32)
    tid = np.asarray([0, 1, 1, 0, 1, 0], np.int32)
    u = np.asarray([0.1, 0.4, -0.6, 0.9, 1.7, -1.25], np.float32)
    v = np.asarray([0.2, 0.5, 0.7, -0.3, 2.05, 0.33], np.float32)
    w = r.normal(size=(6, 3)).astype(np.float32)

    def jf(p, uu, vv):
        return jnp.sum(jtex.sample_bilinear(JAtlas(pages=p, size=jnp.asarray(size)), jnp.asarray(tid), uu, vv)
                       * jnp.asarray(w))

    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(pages), jnp.asarray(u), jnp.asarray(v))
    tp, tu, tv = (torch.tensor(x, requires_grad=True) for x in (pages, u, v))
    out = ttex.sample_bilinear(TextureAtlas(pages=tp, size=torch.as_tensor(size)), torch.as_tensor(tid), tu, tv)
    (out * torch.as_tensor(w)).sum().backward()
    for got, ref in zip((tp.grad, tu.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    # the weights of a sample sum to one: the texel gradient's mass is sum(w)
    assert abs(float(tp.grad.sum()) - float(w.sum())) < 1e-5


def test_scene_is_textured():
    assert ttex.scene_is_textured(port_textured(W, H)[0])
    from fypraytracer_tpu_torch.scene import procedural as tproc
    assert not ttex.scene_is_textured(tproc.cornell_box(W, H)[0].compile())


def test_scene_tex_is_built_with_the_scene():
    """``Scene.tex`` holds the kernel's levels as float4 texels, built by
    ``SceneBuilder.compile`` and ``scene_from_arrays`` and moved by
    ``Scene.to``; an untextured scene has none."""
    from fypraytracer_tpu_torch.scene import procedural as tproc
    from fypraytracer_tpu_torch.scene.types import scene_from_arrays

    scene, _ = port_textured(W, H, BIG)
    ka = ttex.kernel_atlas(scene.textures)
    for sc in (scene, scene.to("cpu"), scene_from_arrays(jax_textured(W, H, BIG)[0])):
        assert sc.tex.prim.shape == (2, 256, 256, 4) and sc.tex.prim.is_contiguous()
        assert torch.equal(sc.tex.prim[..., :3], ka.pages) and torch.equal(sc.tex.bounce[..., :3], ka.bounce_pages)
        assert not sc.tex.prim[..., 3].any() and not sc.tex.bounce[..., 3].any()
    assert tproc.cornell_box(W, H)[0].compile().tex is None


def test_with_textures_builds_new_levels():
    """A scene whose atlas is replaced, sharing its material table, gets
    levels built from the new atlas, not the old ones."""
    scene = port_textured(W, H)[0].to("cpu")
    atlas = TextureAtlas(pages=scene.textures.pages * 0.5, size=scene.textures.size,
                         bounce_pages=scene.textures.bounce_pages * 0.25)
    other = ttex.with_textures(scene, atlas)
    assert other.materials is scene.materials
    assert torch.equal(other.tex.prim[..., :3], atlas.pages)
    assert torch.equal(other.tex.bounce[..., :3], atlas.bounce_pages)
    assert torch.equal(scene.tex.prim[..., :3], scene.textures.pages)
    assert torch.equal(ttex.with_kernel_atlas(other).textures.pages, atlas.pages)


def test_renderers_refuse_a_scene_whose_levels_disagree():
    """No quiet route to the flat albedo or the untextured kernels: a
    textured scene without ``Scene.tex``, or an untextured one with it, is
    refused by every entry point that renders textures."""
    import dataclasses

    from fypraytracer_tpu_torch.parallel.shard import make_train_step
    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer
    from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
    from fypraytracer_tpu_torch.render.megakernel_restir_gi import MegakernelReSTIRGI

    scene, cam = port_textured(16, 16)
    no_levels = dataclasses.replace(scene, tex=None)
    no_maps = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, albedo_map=np.full_like(scene.materials.albedo_map, -1)))
    st = RenderSettings(technique=SamplingTechnique.NEE_MIS, bounces=1, samples=1, sky_color=SKY)
    for bad in (no_levels, no_maps):
        for cls in (Renderer, MegakernelRenderer, MegakernelReSTIRDI, MegakernelReSTIRGI):
            with pytest.raises(ValueError, match="Scene.tex"):
                cls(bad, cam, st, device="cpu")
        with pytest.raises(ValueError, match="Scene.tex"):
            make_train_step(bad, 16, 16, st, device="cpu")


def test_untextured_fetch_reads_the_flat_albedo():
    """Without levels the fetch is the flat gather, bit for bit what the
    textured fetch selects for materials that map no albedo."""
    from fypraytracer_tpu_torch.render.integrators import fetch_albedo
    from fypraytracer_tpu_torch.scene import procedural as tproc

    scene = tproc.cornell_box(W, H)[0].compile().to("cpu")
    mats = torch.arange(-1, scene.materials.albedo.shape[0], dtype=torch.int32)
    uv = torch.as_tensor(np.random.default_rng(3).uniform(-2, 3, (mats.shape[0], 2)).astype(np.float32))
    flat = fetch_albedo(scene, mats, uv)
    assert torch.equal(flat, scene.materials.albedo[mats.clamp_min(0).long()])
    import dataclasses

    textured = port_textured(W, H)[0].to("cpu")
    with_levels = dataclasses.replace(scene, textures=textured.textures, tex=textured.tex)
    assert torch.equal(fetch_albedo(with_levels, mats, uv, bounce=True), flat)


# ---- the textured wavefronts --------------------------------------------------------

def _pair(tech, pos=None, **kw):
    kw = dict(dict(bounces=2, samples=1, sky_color=SKY), **kw)
    js, jcam = jax_textured(W, H, BIG)
    ts, tcam = port_textured(W, H, BIG)
    if pos is not None:
        jcam = JCamera(position=pos, forward=(0, 0, -1), width=W, height=H)
        tcam = Camera(position=pos, forward=(0, 0, -1), width=W, height=H)
    return (JRenderer(js, jcam, JSettings(technique=JTech(int(tech)), **kw)),
            Renderer(ts, tcam, RenderSettings(technique=tech, **kw), device="cpu"))


@pytest.mark.parametrize("tech", [SamplingTechnique.NEE_MIS, SamplingTechnique.COSINE], ids=lambda t: t.name)
def test_textured_wavefront_matches_jax(tech):
    jr, r = _pair(tech)
    for _ in range(2):
        ref = np.asarray(jr.render_hdr())
        got = r.render_hdr()
    _gates(got.numpy(), ref)


@pytest.mark.parametrize("tech, kw", [
    (SamplingTechnique.RESTIR_DI, dict(light_candidates=2, spatial_neighbors=2, spatial_radius=4)),
    (SamplingTechnique.RESTIR_GI, dict(spatial_neighbors=3, spatial_radius=8))], ids=["DI", "GI"])
def test_textured_restir_wavefront_matches_jax(tech, kw):
    jr, r = _pair(tech, POS, **kw)
    for _ in range(2):
        ref = np.asarray(jr.render_hdr())
        got = r.render_hdr()
    assert r.aux_state["reservoir"]["m"].max() > 0
    _gates(got.numpy(), ref, STATIC_PX_SHARE)


def test_textures_change_the_wavefront_image():
    """The textured quads show: against the same scene with every albedo
    map removed, the image differs on the quads' pixels."""
    import dataclasses

    scene, cam = port_textured(W, H, BIG)
    flat = dataclasses.replace(scene, tex=None, materials=dataclasses.replace(
        scene.materials, albedo_map=np.full_like(scene.materials.albedo_map, -1)))
    st = RenderSettings(technique=SamplingTechnique.NEE_MIS, bounces=2, samples=1, sky_color=SKY)
    a = Renderer(scene, cam, st, device="cpu").render_hdr()
    b = Renderer(flat, cam, st, device="cpu").render_hdr()
    assert 0.05 < float(((a - b).abs().amax(-1) > 1e-3).float().mean()) < 0.9


# ---- the overflow flag and the training entry points --------------------------------

def test_plain_walks_never_set_the_overflow_flag():
    """A wide BVH whose ``stack_need`` is below its tree's true need: the
    plain walks on the CPU never read it, so the flag stays clear and the
    entry points do not raise (the card witness is in test_torch_cuda.py)."""
    import dataclasses

    from fypraytracer_tpu_torch.scene import procedural as tproc

    builder, cam = tproc.cornell_box(16, 16, sphere_res=(6, 10))
    scene = skewed_scene(builder.compile(), 8)
    assert scene.wide.stack_need > 8
    scene = dataclasses.replace(scene, wide=dataclasses.replace(scene.wide, stack_need=4))
    st = RenderSettings(technique=SamplingTechnique.NEE_MIS, bounces=2, samples=1, sky_color=SKY)
    r = Renderer(scene, cam, st, device="cpu")
    r.render_many(1)
    r.render_frame()
    r.overflow.check()
    assert int(r.scene.wide.overflow[0]) == 0

