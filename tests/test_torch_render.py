"""The port's renderers against the JAX ones, at matched seeds.

Cornell box at 32²: the wavefront ``Renderer`` for techniques 0-7, the
megakernel's plain version for techniques 0-6 and the ReSTIR DI
megakernel's plain version, each against its JAX counterpart (the JAX
megakernels in Pallas interpret mode).  Gates are those of
tests/test_render_parity.py:111-114: median |Δ| < 1e-5, fewer than 1% of
pixels with |Δ| > 1e-3, image mean within 1%.  Isolated pixels may differ
where a ray grazes a shared triangle edge (the JAX wavefront on the CPU and
the JAX megakernel trace with the dense Baldwin–Weber test, the port walks
the BVH with Möller–Trumbore).  Exact ties go to the lowest triangle id in
all of them.  The kernels' own checks against their plain versions are in
test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import fypraytracer_tpu.scene.procedural as jproc
from fypraytracer_tpu.config import RenderSettings as JSettings
from fypraytracer_tpu.config import SamplingTechnique as JTech
from fypraytracer_tpu.core.camera import Camera as JCamera
from fypraytracer_tpu.render import integrators as jint
from fypraytracer_tpu.render.megakernel import MegakernelRenderer as JMegakernel
from fypraytracer_tpu.render.megakernel_restir import MegakernelReSTIRDI as JMegakernelDI
from fypraytracer_tpu.render.renderer import Renderer as JRenderer
from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.core.camera import Camera
from fypraytracer_tpu_torch.render import integrators as tint
from fypraytracer_tpu_torch.render import megakernel as tmk
from fypraytracer_tpu_torch.render import megakernel_restir as tmr
from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer, morton_permuted_scene
from fypraytracer_tpu_torch.render.megakernel_diff import DiffRenderer
from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
from fypraytracer_tpu_torch.render.megakernel_restir_gi import MegakernelReSTIRGI
from fypraytracer_tpu_torch.render.renderer import Renderer
from fypraytracer_tpu_torch.scene import procedural as tproc

W = H = 32
FRAMES = 3
SKY = (0.05, 0.06, 0.08)


def _gates(got, ref, px_share=0.01):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    assert float(np.median(diff)) < 1e-5
    assert (diff.max(axis=-1) > 1e-3).mean() < px_share, (diff.max(axis=-1) > 1e-3).mean()
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.01


def _settings(bounces=2):
    return RenderSettings(technique=SamplingTechnique.NEE_MIS, bounces=bounces, samples=1, sky_color=SKY)


def _jsettings(bounces=2):
    return JSettings(technique=JTech.NEE_MIS, bounces=bounces, samples=1, sky_color=SKY)


def _port_scene():
    builder, cam = tproc.cornell_box(W, H, sphere_res=(6, 10))
    return builder.compile(), cam


@pytest.fixture(scope="module")
def jax_scene():
    builder, cam = jproc.cornell_box(W, H, sphere_res=(6, 10))
    return builder.compile(native=False), cam


@pytest.fixture(scope="module")
def port_wavefront():
    scene, cam = _port_scene()
    r = Renderer(scene, cam, _settings(), device="cpu")
    for _ in range(FRAMES):
        avg = r.render_hdr()
    return avg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small batches of many tiny ops: threads only add sync overhead, and
    under several test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_renderer_matches_jax_renderer(jax_scene, port_wavefront):
    js, cam = jax_scene
    jr = JRenderer(js, cam, _jsettings())
    for _ in range(FRAMES):
        ref = np.asarray(jr.render_hdr())
    assert port_wavefront.shape == (H, W, 3) and port_wavefront.dtype == torch.float32
    _gates(port_wavefront.numpy(), ref)


def test_single_bounce_matches_jax_renderer(jax_scene):
    """bounces == 1: light sampling without the MIS weight."""
    js, cam = jax_scene
    ref = np.asarray(JRenderer(js, cam, _jsettings(bounces=1)).render_hdr())
    scene, tcam = _port_scene()
    got = Renderer(scene, tcam, _settings(bounces=1), device="cpu").render_hdr()
    _gates(got.numpy(), ref)


def test_megakernel_plain_matches_jax_megakernel(jax_scene):
    """The JAX megakernel renders its scene with the triangles in Morton
    order (megakernel.py:271-314), and exact ties (camera rays through the
    box's wall/ceiling edges) go to the lowest id in that order; the port
    is handed the same permuted arrays so both number triangles alike."""
    js, cam = jax_scene
    ref = np.asarray(JMegakernel(js, cam, _jsettings(), interpret=True).render_many(FRAMES))
    scene = morton_permuted_scene(_port_scene()[0])[0]
    mk = MegakernelRenderer(scene, cam, _settings(), device="cpu")
    got = mk.render_many(FRAMES)
    assert got.shape == (H, W, 3) and mk.frame_index == FRAMES + 1
    _gates(got.numpy(), ref)


def test_render_many_equals_frame_loop(port_wavefront):
    scene, cam = _port_scene()
    r = Renderer(scene, cam, _settings(), device="cpu")
    many = r.render_many(FRAMES)
    assert r.frame_index == FRAMES + 1
    assert torch.equal(many, port_wavefront)


def test_megakernel_plain_equals_wavefront(port_wavefront):
    """The megakernel's plain version is the wavefront frame summed."""
    scene, cam = _port_scene()
    launches = tmk.megakernel.launches
    got = MegakernelRenderer(scene, cam, _settings(), device="cpu").render_many(FRAMES)
    assert tmk.megakernel.launches == launches            # CPU tensors: no kernel
    assert torch.equal(got, port_wavefront)


def test_reset_resize_render_frame():
    scene, cam = _port_scene()
    r = Renderer(scene, cam, _settings(), device="cpu")
    first = r.render_frame()
    assert first.shape == (H, W) and first.dtype == np.uint32
    assert ((first >> 24) == 255).all() and (first & 0xFF).mean() > 3
    r.render_hdr()
    assert r.frame_index == 3
    r.reset()
    assert r.frame_index == 1 and float(r.accum.abs().sum()) == 0.0
    np.testing.assert_array_equal(r.render_frame(), first)
    r.resize(24, 16)
    assert r.frame_index == 1 and r.accum.shape == (16, 24, 3)
    assert r.render_hdr().shape == (16, 24, 3)


def _textured_box_scene():
    """Cornell without spheres and a box whose material has an albedo map."""
    builder, cam = tproc.cornell_box(W, H, with_spheres=False)
    tex = builder.add_texture(np.random.default_rng(3).uniform(0.2, 0.8, (4, 4, 3)).astype(np.float32))
    mat = builder.add_material(albedo_map=tex)
    builder.add_mesh(*tproc.box((0.3, 0.3, 0.3)), material=mat, position=(0.0, 0.2, 0.0))
    return builder.compile(), cam


@pytest.mark.parametrize("cls", [Renderer, MegakernelRenderer, MegakernelReSTIRDI, MegakernelReSTIRGI])
def test_textured_scene_renders(cls):
    """Every renderer class renders a textured scene on the CPU to a finite
    image of its size (their parity with JAX is in test_torch_texture.py and
    test_torch_textured_render.py)."""
    scene, cam = _textured_box_scene()
    tech = {MegakernelReSTIRDI: SamplingTechnique.RESTIR_DI, MegakernelReSTIRGI: SamplingTechnique.RESTIR_GI}
    settings = _settings().replace(technique=tech.get(cls, SamplingTechnique.NEE_MIS))
    img = cls(scene, cam, settings, device="cpu").render_many(1)
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0


def test_diff_renderer_refuses_textured_scene():
    """``DiffRenderer``'s kernel differentiates the flat albedo, as the JAX
    kernel does: it refuses a textured scene, and says why."""
    scene, cam = _textured_box_scene()
    with pytest.raises(NotImplementedError, match="textured"):
        DiffRenderer(scene, cam, device="cpu")



def test_megakernel_refuses_restir():
    scene, cam = _port_scene()
    with pytest.raises(NotImplementedError, match="MegakernelReSTIRDI"):
        MegakernelRenderer(scene, cam, RenderSettings(technique=SamplingTechnique.RESTIR_DI),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="MegakernelReSTIRGI"):
        MegakernelRenderer(scene, cam, RenderSettings(technique=SamplingTechnique.RESTIR_GI),
                           device="cpu")


# ---- techniques 0-5: the wavefront and the megakernel's plain version -------

HEMI_SKY = (0.1, 0.15, 0.2)      # tests/test_render_parity.py:31-32
TECHNIQUES = [SamplingTechnique.BRUTE_FORCE, SamplingTechnique.UNIFORM, SamplingTechnique.COSINE,
              SamplingTechnique.GGX, SamplingTechnique.BRDF, SamplingTechnique.LIGHT_SOURCE]


def _pair_settings(tech, **kw):
    kw = dict(dict(bounces=2, samples=2, sky_color=HEMI_SKY), **kw)
    return RenderSettings(technique=tech, **kw), JSettings(technique=JTech(int(tech)), **kw)


@pytest.mark.parametrize("tech", TECHNIQUES, ids=lambda t: t.name)
def test_wavefront_technique_matches_jax_renderer(jax_scene, tech):
    js, cam = jax_scene
    settings, jsettings = _pair_settings(tech)
    ref = np.asarray(JRenderer(js, cam, jsettings).render_hdr())
    scene, tcam = _port_scene()
    got = Renderer(scene, tcam, settings, device="cpu").render_hdr()
    assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all())
    _gates(got.numpy(), ref)


@pytest.mark.parametrize("tech", TECHNIQUES[1:], ids=lambda t: t.name)
def test_megakernel_plain_matches_jax_megakernel_sampler(jax_scene, tech):
    """Uniform, cosine, GGX, BRDF and light-source sampling through the
    megakernel's plain version against the JAX megakernel (interpret mode,
    as tests/test_render_parity.py:95-160 run it), Morton numbering."""
    js, cam = jax_scene
    settings, jsettings = _pair_settings(tech)
    ref = np.asarray(JMegakernel(js, cam, jsettings, interpret=True).render_many(FRAMES))
    scene = morton_permuted_scene(_port_scene()[0])[0]
    got = MegakernelRenderer(scene, cam, settings, device="cpu").render_many(FRAMES)
    _gates(got.numpy(), ref)


def test_brute_force_megakernel_is_uniform_at_one_sample():
    """Brute force traces one path a frame whatever ``samples`` says
    (megakernel.py:2603): it equals uniform sampling at samples = 1."""
    scene, cam = _port_scene()
    brute, _ = _pair_settings(SamplingTechnique.BRUTE_FORCE, samples=3)
    uniform, _ = _pair_settings(SamplingTechnique.UNIFORM, samples=1)
    got = tmk.megakernel_plain(scene.to("cpu"), cam, 1, 2, brute)
    assert torch.equal(got, tmk.megakernel_plain(scene.to("cpu"), cam, 1, 2, uniform))


@pytest.mark.parametrize("sampler", ["uniform", "cosine", "brdf"])
def test_sampler_pdf_matches_jax(jax_scene, sampler):
    """The scatter pdf of a direction, float64 on both sides so that the
    formula is pinned (the JAX module runs NumPy on NumPy arrays)."""
    js = jax_scene[0]
    scene = _port_scene()[0].to("cpu")
    r = np.random.default_rng(11)

    def unit(n):
        v = r.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    normal, view, l = unit(512), unit(512), unit(512)
    mat = r.integers(0, int(js.materials.roughness.shape[0]), 512).astype(np.int32)
    ref = jint.sampler_pdf(js, dict(normal=normal, mat=mat, uv=np.zeros((512, 2))), view, l, sampler)
    pay = dict(normal=torch.as_tensor(normal), mat=torch.as_tensor(mat), uv=torch.zeros((512, 2), dtype=torch.float64))
    got = tint.sampler_pdf(scene, pay, torch.as_tensor(view), torch.as_tensor(l), sampler)
    assert got.dtype == torch.float64 and got.shape == (512,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError):
        tint.sampler_pdf(scene, pay, torch.as_tensor(view), torch.as_tensor(l), "ggx")


# ---- ReSTIR DI ------------------------------------------------------------------

DI_KW = dict(light_candidates=2, spatial_neighbors=2, spatial_radius=4)   # test_render_parity.py:83-85

# The camera sits just off the box's symmetry plane: from (0, 1, 2.6) the
# diagonal camera rays pass exactly through the box's edges, where the
# JAX megakernel's dense trace reports a miss and the BVH walk a hit, and
# spatial reuse spreads each such pixel to its neighbours frame by frame.
DI_POS = (0.013, 1.011, 2.6)
# A static camera reprojects a pixel's hit point onto the pixel's own
# corner (rays leave through pixel corners), so whether it keeps its
# history is decided by truncating an integer-valued float: the last ulp
# of the hit position decides, in the wavefront and the megakernel alike.
# That ulp differs between the two sides: XLA turns the camera ray's
# x / sqrt(y) into x * rsqrt(y) (the JAX megakernel calls rsqrt itself),
# and the JAX renderers compute t with the Baldwin–Weber test, the port
# with Möller–Trumbore.  So the image differs by more than 1e-3 at 1.2-2.0%
# of pixels (32², from DI_POS).  The static-camera tests against JAX allow
# 3%, with the median and mean gates unchanged.  The witness is
# test_restir_di_matches_jax_off_pixel_corners: with temporal reuse off, or
# with a camera that moves every frame so that reprojection lands inside
# pixels, the same comparisons pass the 1% gate from the default pose.  On
# the card, the kernels and the plain version compute the hit point bit
# for bit alike, and chip_smoke.py and test_torch_cuda.py hold them to the
# 1% gate.
DI_PX_SHARE = 0.03


def test_restir_di_wavefront_matches_jax_renderer():
    jb, _ = jproc.cornell_box(W, H, sphere_res=(6, 10))
    jr = JRenderer(jb.compile(native=False), JCamera(position=DI_POS, forward=(0, 0, -1), width=W,
                                                     height=H),
                   JSettings(technique=JTech.RESTIR_DI, **DI_KW))
    r = Renderer(_port_scene()[0], Camera(position=DI_POS, forward=(0, 0, -1), width=W, height=H),
                 RenderSettings(technique=SamplingTechnique.RESTIR_DI, **DI_KW), device="cpu")
    for _ in range(FRAMES):
        ref = np.asarray(jr.render_hdr())
        got = r.render_hdr()
    assert r.aux_state["reservoir"]["m"].max() > 0
    _gates(got.numpy(), ref, DI_PX_SHARE)


def test_restir_di_render_many_equals_frame_loop():
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_DI, **DI_KW)
    scene, cam = _port_scene()
    r1 = Renderer(scene, cam, settings, device="cpu")
    for _ in range(FRAMES):
        loop = r1.render_hdr()
    scene, cam = _port_scene()
    r2 = Renderer(scene, cam, settings, device="cpu")
    many = r2.render_many(FRAMES)
    assert r2.frame_index == FRAMES + 1
    torch.testing.assert_close(many, loop, atol=1e-6, rtol=1e-6)


def _di_pair():
    jb, _ = jproc.cornell_box(W, H, sphere_res=(6, 10))
    js = jb.compile(native=False)
    jd = JMegakernelDI(js, JCamera(position=DI_POS, forward=(0, 0, -1), width=W, height=H),
                       JSettings(technique=JTech.RESTIR_DI), interpret=True)
    scene = morton_permuted_scene(_port_scene()[0])[0]
    td = MegakernelReSTIRDI(scene, Camera(position=DI_POS, forward=(0, 0, -1), width=W, height=H),
                            RenderSettings(technique=SamplingTechnique.RESTIR_DI), device="cpu")
    return jd, td


@pytest.mark.parametrize("case", ["static", "two_calls", "move"])
def test_restir_di_megakernel_plain_matches_jax(case):
    """Default DI settings (8 candidates, 5 neighbours, radius 30) at 32²:
    two tiles of 512 pixels.  ``two_calls`` carries the reservoirs across
    ``render_many`` calls (JAX tests/test_megakernel_restir.py:141-155);
    ``move`` moves the camera in between, so the next call's first frame
    reprojects through the old pose with the tile-mean offset (:112-139)."""
    jd, td = _di_pair()
    if case == "static":
        ref, got = np.asarray(jd.render_many(4)), td.render_many(4)
    else:
        _gates(td.render_many(2).numpy(), np.asarray(jd.render_many(2)), DI_PX_SHARE)
        n = 2
        if case == "move":
            jd.camera.move_to((0.15, 1.0, 2.6))
            td.camera.move_to((0.15, 1.0, 2.6))
            n = 1
        ref, got = np.asarray(jd.render_many(n)), td.render_many(n)
    assert td.frame_index == jd.frame_index
    assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all())
    assert float(td.state[4].max()) > 8.0          # reservoirs merged history
    _gates(got.numpy(), ref, DI_PX_SHARE)


def _creep(i):
    """The camera's position at frame ``i`` of the moving-camera runs: a
    small step a frame, so each frame reprojects through a new pose."""
    return (0.0037 * i, 1.0 - 0.0021 * i, 2.6)


@pytest.mark.parametrize("mode", ["no_temporal", "moving_camera"])
@pytest.mark.parametrize("entry", ["wavefront", "megakernel"])
def test_restir_di_matches_jax_off_pixel_corners(entry, mode):
    """Why the static-camera DI tests allow DI_PX_SHARE: take away only the
    pixel-corner reprojection, and the port meets the 1% gate against JAX
    from the default pose.  ``no_temporal`` turns temporal reuse off;
    ``moving_camera`` keeps it on and moves the camera a little before every
    frame, so hit points reproject inside pixels and most pixels still keep
    history (checked on the port's K3 stage)."""
    temporal = mode == "moving_camera"
    jb, _ = jproc.cornell_box(W, H, sphere_res=(6, 10))
    jcam = JCamera(position=_creep(0), forward=(0, 0, -1), width=W, height=H)
    cam = Camera(position=_creep(0), forward=(0, 0, -1), width=W, height=H)
    if entry == "wavefront":
        kw = dict(DI_KW, temporal_reuse=temporal)
        jr = JRenderer(jb.compile(native=False), jcam, JSettings(technique=JTech.RESTIR_DI, **kw))
        r = Renderer(_port_scene()[0], cam, RenderSettings(technique=SamplingTechnique.RESTIR_DI, **kw),
                     device="cpu")
        step_j, step_t = jr.render_hdr, r.render_hdr
    else:
        settings = RenderSettings(technique=SamplingTechnique.RESTIR_DI, temporal_reuse=temporal)
        jd = JMegakernelDI(jb.compile(native=False), jcam,
                           JSettings(technique=JTech.RESTIR_DI, temporal_reuse=temporal), interpret=True)
        r = MegakernelReSTIRDI(morton_permuted_scene(_port_scene()[0])[0], cam, settings, device="cpu")
        step_j, step_t = (lambda: jd.render_many(1)), (lambda: r.render_many(1))
    for i in range(FRAMES + (entry == "megakernel")):
        if temporal and i:
            (jr if entry == "wavefront" else jd).camera.move_to(_creep(i))
            r.camera.move_to(_creep(i))
        if entry == "megakernel" and i == FRAMES:
            # the last frame's stage: M above the candidate count is history kept
            stage = tmr.restir_di_k3_plain(r.scene, r.emitters, r.camera, r.frame_index, settings,
                                           r.state.clone(), r.camera.prev_proj_view)
            kept = float((stage[tmr.S_RM][stage[tmr.S_SHADE] > 0.5] > settings.light_candidates).float().mean())
            assert kept > 0.9 if temporal else kept == 0.0
        ref, got = np.asarray(step_j()), step_t()
    _gates(got.numpy(), ref)
