"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and nvcc; each carries the
``requires_cuda`` marker and skips where torch sees no card.  The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Gates: K1 ids equal on >= 99.99% of rays and |Δt| <= 1e-5 where both hit,
and its walks of the wide BVH equal to the plain walk of the threaded BVH
(``trace_rays``) bit for bit; K2 NEE with one and four threads a pixel
under the parity gates below and within 1e-6 relative of each other; the
wide segment test (``trace_segments``) equal to its plain twin bit for bit; K5
(a tile a cluster of blocks, the walks through the wide BVH) equal to its
plain version bit for bit, and its stage equal to K6's bit for bit, at
tiles of 512, 256 and 128 pixels, on square and other frames and on the
stress scene; K3, K5 and K6 the same bits with their tiles split and one
block each; every kernel library's camera rays (``camera_ray``) equal to
``generate_rays`` bit for bit; K2's pixel slabs joined equal to its
one-launch image bit for bit;
K2, K3+K4, K5-K7 (ReSTIR GI) and the renderers under
tests/test_render_parity.py:111-114
(median |Δ| < 1e-5, fewer than 1% of pixels off by more than 1e-3, mean
within 1%); K8 (the fused loss and albedo gradient): the loss within 1e-5
relative, the gradients within 1e-4 of their largest entry.  Isolated pixels may differ by FMA contraction in the kernels'
shading code, which can flip a RIS or lobe decision.
"""

import copy
import ctypes
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.core.camera import generate_rays
from fypraytracer_tpu_torch.ops import kernels
from fypraytracer_tpu_torch.ops import traverse as ttrav
from fypraytracer_tpu_torch.core.camera import Camera
from fypraytracer_tpu_torch.render import megakernel as tmk
from fypraytracer_tpu_torch.render import megakernel_diff as tmd
from fypraytracer_tpu_torch.render import megakernel_restir as tmr
from fypraytracer_tpu_torch.render import megakernel_restir_gi as tmg
from fypraytracer_tpu_torch.render import restir_common as trc
from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer
from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
from fypraytracer_tpu_torch.render.megakernel_restir_gi import MegakernelReSTIRGI
from fypraytracer_tpu_torch.render.renderer import Renderer
from fypraytracer_tpu_torch.scene import procedural as tproc
from torch_skewed_bvh import skewed_scene

W = H = 32
FRAMES = 3
SETTINGS = RenderSettings(technique=SamplingTechnique.NEE_MIS, bounces=2, samples=1,
                          sky_color=(0.05, 0.06, 0.08))

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _gates(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    assert float(np.median(diff)) < 1e-5
    assert (diff.max(axis=-1) > 1e-3).mean() < 0.01
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.01


def _launched(fn, clustered):
    """The wrapper ``fn`` of K3, K5 or K6 with each tile split over a
    cluster (``clustered``) or one block, whichever
    ``restir_common.tile_clustered`` would pick."""
    @functools.wraps(fn)
    def run(*args, **kw):
        with mock.patch.object(trc, "tile_clustered", lambda *_: clustered):
            return fn(*args, **kw)
    return run


def _scene():
    builder, cam = tproc.cornell_box(W, H, sphere_res=(6, 10))
    return builder.compile(), cam


def _k1_rays(cuda, cam, n_random):
    """The camera's rays and ``n_random`` random rays in the box."""
    r = np.random.default_rng(2026)
    o_rnd = r.uniform([-0.99, 0.01, -0.99], [0.99, 1.99, 0.99], (n_random, 3)).astype(np.float32)
    d_rnd = r.normal(size=(n_random, 3)).astype(np.float32)
    o_cam, d_cam = generate_rays(cam.inv_projection, cam.inv_view, cam.width, cam.height, device=cuda)
    o = torch.cat([o_cam, torch.as_tensor(o_rnd, device=cuda)]).contiguous()
    d = torch.cat([d_cam, torch.as_tensor(d_rnd, device=cuda)]).contiguous()
    return o, d


# 4096 + 4096 rays fill 256 blocks of 32 quads; 4096 + 1001 leave a ragged block
@pytest.mark.parametrize("n_random, with_t_max", [(4096, False), (1001, False), (1001, True)],
                         ids=["whole blocks", "ragged", "ragged t_max"])
def test_trace_closest_kernel_matches_plain_walk(cuda, n_random, with_t_max):
    builder, cam = tproc.cornell_box(64, 64)
    scene = builder.compile().to(cuda)
    o, d = _k1_rays(cuda, cam, n_random)
    tm = (torch.as_tensor(np.random.default_rng(4).uniform(0.05, 2.0, o.shape[0]).astype(np.float32), device=cuda)
          if with_t_max else None)
    before = ttrav.trace_closest.launches
    k = ttrav.trace_closest(scene, o, d, tm)
    p = ttrav.trace_rays(scene.bvh, scene.geometry, o, d, tm)
    torch.cuda.synchronize()
    assert ttrav.trace_closest.launches == before + 1
    assert (k["tri"] == p["tri"]).float().mean().item() >= 0.9999
    both = (k["tri"] >= 0) & (p["tri"] >= 0)
    assert (k["t"][both] - p["t"][both]).abs().max().item() <= 1e-5
    if with_t_max:
        assert (k["t"][k["tri"] >= 0] < tm[k["tri"] >= 0]).all()
    ttrav.check_overflow(scene)


@pytest.mark.parametrize("lanes", [4, 1], ids=["quad", "one thread"])
def test_trace_closest_wide_equals_threaded(cuda, lanes):
    """The walks of the wide BVH (a quad a ray, one thread a ray) and the
    plain walk of the threaded BVH (``trace_rays``) give the same hits, bit
    for bit (all rank exact ties to the lowest id)."""
    builder, cam = tproc.cornell_box(64, 64)
    scene = builder.compile().to(cuda)
    o, d = _k1_rays(cuda, cam, 4096)
    before = ttrav.trace_closest.launches
    wide = ttrav.trace_closest(scene, o, d, lanes=lanes)
    threaded = ttrav.trace_rays(scene.bvh, scene.geometry, o, d)
    torch.cuda.synchronize()
    assert ttrav.trace_closest.launches == before + 1
    for k in ("tri", "t", "u", "v"):
        off = (wide[k].view(torch.int32) != threaded[k].view(torch.int32)).nonzero().flatten()
        assert off.numel() == 0, f"{k} differs at rays {off[:16].tolist()}"
    ttrav.check_overflow(scene)


def test_wide_walk_on_the_stress_scene(cuda):
    """The 200,712-triangle stress scene, whose wide BVH is the deepest the
    repository builds: K1 against the plain walk on its camera rays, K2 NEE
    against its plain version, and the stack-overflow flag stays clear."""
    builder, cam = tproc.stress(64, 64)
    scene = tmk.morton_permuted_scene(builder.compile())[0].to(cuda)
    assert ttrav.wide_records(scene) is scene.wide
    o, d = generate_rays(cam.inv_projection, cam.inv_view, 64, 64, device=cuda)
    k = ttrav.trace_closest(scene, o, d)
    p = ttrav.trace_rays(scene.bvh, scene.geometry, o, d)
    assert (k["tri"] == p["tri"]).float().mean().item() >= 0.9999
    got = tmk.megakernel(scene, cam, 1, 2, SETTINGS)
    ref = tmk.megakernel_plain(scene, cam, 1, 2, SETTINGS)
    torch.cuda.synchronize()
    _gates(got.cpu().numpy(), ref.cpu().numpy())
    ttrav.check_overflow(scene)


def test_wide_walk_on_a_skewed_tree(cuda):
    """A chain BVH over the Cornell box (tests/torch_skewed_bvh.py) whose
    walk needs a stack of 149 entries: K1 (both lane counts) and K2 give
    the plain versions' hits and image with every stack in shared memory
    (152 KB a block for one thread a ray, past the default 48 KB), and the
    overflow flag stays clear."""
    builder, cam = tproc.cornell_box(W, H)
    scene = skewed_scene(builder.compile(), 8).to(cuda)
    assert scene.wide.stack_need == 149
    o, d = _k1_rays(cuda, cam, 4096)
    p = ttrav.trace_rays(scene.bvh, scene.geometry, o, d)
    for lanes in (4, 1):
        k = ttrav.trace_closest(scene, o, d, lanes=lanes)
        for f in ("tri", "t", "u", "v"):
            assert torch.equal(k[f].view(torch.int32), p[f].view(torch.int32)), (lanes, f)
    got = tmk.megakernel(scene, cam, 1, 2, SETTINGS, lanes=2)
    ref = tmk.megakernel_plain(scene, cam, 1, 2, SETTINGS)
    torch.cuda.synchronize()
    _gates(got.cpu().numpy(), ref.cpu().numpy())
    ttrav.check_overflow(scene)


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("tech", [SamplingTechnique.NEE_MIS, SamplingTechnique.BRDF, SamplingTechnique.LIGHT_SOURCE],
                         ids=lambda t: t.name)
def test_megakernel_walks_match_the_plain_version(cuda, lanes, tech):
    """K2 with each count of threads a pixel against ``megakernel_plain``."""
    scene, cam = _scene()
    scene = scene.to(cuda)
    settings = SETTINGS.replace(technique=tech)
    got = tmk.megakernel(scene, cam, 1, 4, settings, lanes=lanes)
    ref = tmk.megakernel_plain(scene, cam, 1, 4, settings)
    torch.cuda.synchronize()
    _gates(got.cpu().numpy(), ref.cpu().numpy())
    ttrav.check_overflow(scene)


def test_megakernel_nee_wide_equals_threaded(cuda):
    """K2 under NEE through the wide BVH against its plain version, whose
    walk is the threaded BVH's (``megakernel_plain``): the same paths, so
    the same image under the parity gates, with four threads a pixel and
    with one; the four add a pixel's frames in another order than the one
    does, within 1e-6 relative."""
    scene, cam = _scene()
    scene = scene.to(cuda)
    assert tmk.k2_lanes(4) == 4
    before = tmk.megakernel.launches
    wide = tmk.megakernel(scene, cam, 1, 4, SETTINGS)
    one = tmk.megakernel(scene, cam, 1, 4, SETTINGS, lanes=1)
    ref = tmk.megakernel_plain(scene, cam, 1, 4, SETTINGS)
    torch.cuda.synchronize()
    assert tmk.megakernel.launches == before + 2
    _gates(wide.cpu().numpy(), ref.cpu().numpy())
    _gates(one.cpu().numpy(), ref.cpu().numpy())
    assert ((wide - one).abs() <= 1e-6 * one.abs().clamp_min(1e-3)).all()
    with pytest.raises(ValueError, match="lanes"):
        tmk.megakernel(scene, cam, 1, 1, SETTINGS, lanes=3)


def test_megakernel_nee_four_lanes_at_1080p(cuda):
    """K2 NEE with four threads a pixel at Cornell 1920x1088, 4 frames: the
    launch that faulted with an illegal address when the kernel, its NEE
    walk then a ``__noinline__`` call, was built with
    ``__launch_bounds__(128, 7)`` or ``(128, 6)`` (ROADMAP queue 3); the
    kernel now has one inlined walk site under such a bound.  It runs
    clean, adds the frames as one thread a pixel does (to float rounding),
    and leaves the overflow flag clear."""
    builder, cam = tproc.cornell_box(1920, 1088)
    scene = builder.compile().to(cuda)
    four = tmk.megakernel(scene, cam, 1, 4, SETTINGS, lanes=4)
    one = tmk.megakernel(scene, cam, 1, 4, SETTINGS, lanes=1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(four).all())
    assert (four - one).abs().max().item() <= 1e-5 * max(one.abs().max().item(), 1.0)
    ttrav.check_overflow(scene)


@pytest.mark.parametrize("bounces, samples", [(2, 1), (1, 1), (2, 2)])
def test_megakernel_matches_its_plain_version(cuda, bounces, samples):
    # bounces=1 is light sampling without MIS; samples=2 takes the kernel's
    # per-pixel sample loop and its division by the sample count
    scene, cam = _scene()
    scene = scene.to(cuda)
    settings = SETTINGS.replace(bounces=bounces, samples=samples)
    before = tmk.megakernel.launches
    got = tmk.megakernel(scene, cam, 1, 4, settings)
    ref = tmk.megakernel_plain(scene, cam, 1, 4, settings)
    torch.cuda.synchronize()
    assert tmk.megakernel.launches == before + 1
    _gates(got.cpu().numpy().reshape(H, W, 3), ref.cpu().numpy().reshape(H, W, 3))


@pytest.mark.parametrize("cls", [Renderer, MegakernelRenderer])
def test_cuda_renderer_matches_cpu_renderer(cuda, cls):
    scene, cam = _scene()
    ref = cls(scene, cam, SETTINGS, device="cpu").render_many(FRAMES)
    got = cls(scene, cam, SETTINGS, device=cuda).render_many(FRAMES)
    assert got.device.type == "cuda" and got.shape == (H, W, 3)
    _gates(got.cpu().numpy(), ref.numpy())


@pytest.mark.parametrize("tech", [SamplingTechnique.BRUTE_FORCE, SamplingTechnique.UNIFORM,
                                  SamplingTechnique.COSINE, SamplingTechnique.GGX,
                                  SamplingTechnique.BRDF, SamplingTechnique.LIGHT_SOURCE],
                         ids=lambda t: t.name)
def test_megakernel_sampler_matches_its_plain_version(cuda, tech):
    scene, cam = _scene()
    scene = scene.to(cuda)
    settings = RenderSettings(technique=tech, bounces=2, samples=2, sky_color=(0.1, 0.15, 0.2))
    before = tmk.megakernel.launches
    got = tmk.megakernel(scene, cam, 1, 4, settings)
    ref = tmk.megakernel_plain(scene, cam, 1, 4, settings)
    torch.cuda.synchronize()
    assert tmk.megakernel.launches == before + 1
    _gates(got.cpu().numpy().reshape(H, W, 3), ref.cpu().numpy().reshape(H, W, 3))


DI = RenderSettings(technique=SamplingTechnique.RESTIR_DI, sky_color=(0.05, 0.06, 0.08))


@functools.lru_cache(maxsize=None)
def _stress_host():
    """The 200,712-triangle stress scene in Morton order on the host (its
    NumPy build takes seconds: made once), and its camera at W x H."""
    builder, cam = tproc.stress(W, H)
    return tmk.morton_permuted_scene(builder.compile())[0], cam


def _di_setup(cuda, w=W, h=H, scene_name="cornell"):
    """A scene in Morton order on the card, its emissive table and the ReSTIR
    camera at ``w`` x ``h``: tiles of 512 pixels at 32², 256 at 16², 128 at
    40x16 (``restir_common.pick_ray_lanes``)."""
    if scene_name == "stress":
        host, cam = _stress_host()
        cam = copy.deepcopy(cam)                  # the tests move it
        assert (cam.width, cam.height) == (w, h)
    else:
        builder, _ = tproc.cornell_box(w, h, sphere_res=(6, 10))
        host = tmk.morton_permuted_scene(builder.compile())[0]
        cam = Camera(position=(0.0, 1.0, 2.6), forward=(0, 0, -1), width=w, height=h)
    scene = host.to(cuda)
    return scene, tmr.prepare_emissive_table(scene), cam


# (scene, width, height): tiles of 512, 256 and 128 pixels, a frame that is
# no power-of-two square (tiles of 256), and the stress scene's deep tree
TILES = [("cornell", 32, 32), ("cornell", 16, 16), ("cornell", 40, 16), ("cornell", 80, 48), ("stress", 32, 32)]
TILE_IDS = ["C512", "C256", "C128", "C256-80x48", "stress C512"]


def _k5_matches(got, ref, k6_stage):
    """K5's (image, state, stage) against its plain version's, bit for bit,
    and K5's stage bit for bit K6's on the same inputs (the same first half
    of a frame, walked through the wide BVH, against the threaded walk).
    Until the plain versions' camera rays and specular weight were made to
    round as the kernels' (ROADMAP queue 3) this held only on the Cornell
    box at power-of-two squares."""
    for got_t, ref_t, name in zip(got, ref, ("image", "state", "stage")):
        off = (got_t != ref_t).any(-1 if name == "image" else 0).nonzero().flatten()
        assert off.numel() == 0, f"{name} differs at {off.numel()} pixels, first {off[:16].tolist()}"
    assert torch.equal(got[2], k6_stage)


def _moved(cam, move=True):
    """The camera moved 0.05 to the side where ``move``; returns the proj @
    view it left: the frame after a move reprojects each tile at an offset
    of its own."""
    ppv = cam.proj_view
    if move:
        cam.move_to(cam.position + np.float32([0.05, 0.0, 0.0]))
    return ppv


MOVES = pytest.mark.parametrize("move", [False, True], ids=["static", "move"])


@MOVES
@pytest.mark.parametrize("scene_name, w, h", TILES, ids=TILE_IDS)
def test_restir_di_kernels_match_plain_on_same_inputs(cuda, scene_name, w, h, move):
    """K3 and K4 each against its plain version, fed the same state and stage
    after two frames of history, the camera static or moved before the
    third; K3 with its tiles split over clusters and one block each, the
    same bits; K4 in its blocks of 128."""
    scene, em, cam = _di_setup(cuda, w, h, scene_name)
    state = torch.zeros((tmr.ST_ROWS, w * h), device=cuda)
    tmr.restir_di_megakernel_plain(scene, em, cam, state, 1, 2, DI, cam.proj_view, cam.proj_view)
    ppv = _moved(cam, move)
    k3, k4 = tmr.restir_di_k3.launches, tmr.restir_di_k4.launches
    stage = _launched(tmr.restir_di_k3, True)(scene, em, cam, 3, DI, state, ppv)
    assert torch.equal(stage, _launched(tmr.restir_di_k3, False)(scene, em, cam, 3, DI, state, ppv))
    ref_stage = tmr.restir_di_k3_plain(scene, em, cam, 3, DI, state, ppv)
    out, ref_out = (torch.zeros((w * h, 3), device=cuda) for _ in range(2))
    st_k, st_p = state.clone(), state.clone()
    tmr.restir_di_k4(scene, em, cam, 3, DI, ref_stage, st_k, out)
    tmr.restir_di_k4_plain(scene, em, cam, 3, DI, ref_stage, st_p, ref_out)
    torch.cuda.synchronize()
    assert (tmr.restir_di_k3.launches, tmr.restir_di_k4.launches) == (k3 + 2, k4 + 1)
    off = (stage - ref_stage).abs() > 1e-3 * torch.clamp_min(ref_stage.abs(), 1.0)
    assert off.any(0).float().mean().item() < 0.01
    _gates(out.cpu().numpy(), ref_out.cpu().numpy())
    ttrav.check_overflow(scene)


@pytest.mark.parametrize("size", [(32, 32), (16, 16), (40, 16)], ids=["C512", "C256", "C128"])
@pytest.mark.parametrize("move", [False, True], ids=["static", "move"])
def test_restir_di_kernels_match_plain_over_frames(cuda, move, size):
    w, h = size
    scene, em, cam = _di_setup(cuda, w, h)
    states = [torch.zeros((tmr.ST_ROWS, w * h), device=cuda) for _ in range(2)]
    outs = []
    for fn, state in zip((tmr.restir_di_megakernel, tmr.restir_di_megakernel_plain), states):
        c = Camera(position=(0.0, 1.0, 2.6), forward=(0, 0, -1), width=w, height=h)
        out = fn(scene, em, c, state, 1, 3, DI, c.proj_view, c.proj_view)
        if move:
            ppv = c.proj_view
            c.move_to((0.15, 1.0, 2.6))
            out = out + fn(scene, em, c, state, 4, 3, DI, ppv, c.proj_view)
        outs.append(out.cpu().numpy())
    _gates(outs[0], outs[1])


def test_restir_di_state_carries_across_calls(cuda):
    """Two ``render_many(2)`` calls of the renderer against four plain frames
    that carry one state, both on the card (the CPU's float32 sqrt rounds
    differently, which moves ReSTIR's history decisions)."""
    scene, em, cam = _di_setup(cuda)
    mk = MegakernelReSTIRDI(scene, cam, DI, device=cuda)
    mk.render_many(2)
    got = mk.render_many(2)
    state = torch.zeros((tmr.ST_ROWS, W * H), device=cuda)
    ref = sum(tmr.restir_di_megakernel_plain(scene, em, cam, state, f0, 2, DI, cam.proj_view,
                                             cam.proj_view) for f0 in (1, 3)) / 4.0
    assert mk.frame_index == 5 and float(mk.state[tmr.ST_RM].max()) > 16.0
    _gates(got.cpu().numpy(), ref.reshape(H, W, 3).cpu().numpy())


GI = RenderSettings(technique=SamplingTechnique.RESTIR_GI, spatial_neighbors=3, spatial_radius=8,
                    sky_color=(0.05, 0.06, 0.08))


def _elements_off(got, ref):
    """Share of pixels with any row off by more than 1e-3 relative."""
    return ((got - ref).abs() > 1e-3 * torch.clamp_min(ref.abs(), 1.0)).any(0).float().mean().item()


@MOVES
@pytest.mark.parametrize("scene_name, w, h", TILES, ids=TILE_IDS)
def test_restir_gi_kernels_match_plain_on_same_inputs(cuda, scene_name, w, h, move):
    """K5 (both visibility modes), K6 and K7 each against its plain version,
    fed the same state and stage after two frames of history, the camera
    static or moved before the third; K5 and K6 with their tiles split over
    clusters and one block each, the same bits, held as ``_k5_matches``
    holds it."""
    scene, _, cam = _di_setup(cuda, w, h, scene_name)
    B = w * h
    z = (torch.zeros((tmg.GT_ROWS, B), device=cuda), torch.zeros((tmg.GS_ROWS, B), device=cuda))
    _, state, stage = tmg.restir_gi_megakernel_plain(scene, cam, *z, 1, 2, GI, cam.proj_view, cam.proj_view)
    ppv = _moved(cam, move)
    counts = (tmg.restir_gi_mono.launches, tmg.restir_gi_k1.launches, tmg.restir_gi_k2.launches)

    k6 = _launched(tmg.restir_gi_k1, True)(scene, cam, 3, GI, state, ppv)
    assert torch.equal(k6, _launched(tmg.restir_gi_k1, False)(scene, cam, 3, GI, state, ppv))
    ref = tmg.restir_gi_k1_plain(scene, cam, 3, GI, state, ppv)
    assert _elements_off(k6, ref) < 0.01

    outs = []
    for fn in (tmg.restir_gi_k2, tmg.restir_gi_k2_plain):
        acc, st = torch.zeros((B, 3), device=cuda), state.clone()
        fn(scene, cam, 3, GI, ref, st, acc)
        outs.append((acc, st))
    _gates(outs[0][0].cpu().numpy(), outs[1][0].cpu().numpy())
    assert _elements_off(outs[0][1], outs[1][1]) < 0.01

    for final_vis in (False, True):
        outs = []
        for fn in (_launched(tmg.restir_gi_mono, True),
                   _launched(tmg.restir_gi_mono, False), tmg.restir_gi_mono_plain):
            acc, st, sg = torch.zeros((B, 3), device=cuda), torch.empty_like(state), torch.empty_like(stage)
            fn(scene, cam, 3, GI, state, stage, ppv, acc, st, sg, final_vis=final_vis)
            outs.append((acc, st, sg))
        torch.cuda.synchronize()
        # a tile split over a cluster and a tile one block: the same bits
        assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
        outs = outs[1:]
        _k5_matches(outs[0], outs[1], k6)
    assert (tmg.restir_gi_mono.launches, tmg.restir_gi_k1.launches, tmg.restir_gi_k2.launches) == \
        (counts[0] + 4, counts[1] + 2, counts[2] + 1)
    ttrav.check_overflow(scene)
    with pytest.raises(ValueError, match="buffers of their own"):
        tmg.restir_gi_mono(scene, cam, 3, GI, state, stage, ppv, acc, state, stage)


@pytest.mark.parametrize("mode, size", [(dict(mono=True), (32, 32)), (dict(mono=True, final_vis=True), (32, 32)),
                                        (dict(mono=False), (32, 32)),
                                        (dict(mono=True), (16, 16)), (dict(mono=True, final_vis=True), (16, 16)),
                                        (dict(mono=True), (40, 16)), (dict(mono=True, final_vis=True), (40, 16)),
                                        (dict(mono=False), (80, 48))],
                         ids=["mono", "final_vis", "split", "mono-C256", "final_vis-C256", "mono-C128",
                              "final_vis-C128", "split-80x48"])
def test_restir_gi_kernels_match_plain_over_frames(cuda, mode, size):
    """The ping-pong frame loop against ``restir_gi_megakernel_plain``, 3 + 3
    frames with a camera move in between; launches: K5 once a frame, or K6
    and K7 once each.  K5 also at tiles of 256 and 128 pixels (K6 and K7
    run a tile as one block, as before); K6 and K7 also at 80x48, which
    ended past the 1% gate before the camera rays' repair (ROADMAP queue
    3)."""
    w, h = size
    scene, _, _ = _di_setup(cuda, w, h)
    B = w * h
    outs = []
    for fn in (tmg.restir_gi_megakernel, tmg.restir_gi_megakernel_plain):
        c = Camera(position=(0.0, 1.0, 2.6), forward=(0, 0, -1), width=w, height=h)
        z = (torch.zeros((tmg.GT_ROWS, B), device=cuda), torch.zeros((tmg.GS_ROWS, B), device=cuda))
        before = (tmg.restir_gi_mono.launches, tmg.restir_gi_k1.launches, tmg.restir_gi_k2.launches)
        out, st, sg = fn(scene, c, *z, 1, 3, GI, c.proj_view, c.proj_view, **mode)
        ppv = c.proj_view
        c.move_to((0.15, 1.0, 2.6))
        out2, st, sg = fn(scene, c, st, sg, 4, 3, GI, ppv, c.proj_view, **mode)
        after = (tmg.restir_gi_mono.launches, tmg.restir_gi_k1.launches, tmg.restir_gi_k2.launches)
        outs.append((out + out2).cpu().numpy())
    want = (6, 0, 0) if mode["mono"] else (0, 6, 6)
    assert tuple(a - b for a, b in zip(after, before)) == (0, 0, 0)       # the plain loop launches nothing
    _gates(outs[0], outs[1])
    assert float(st[tmg.GT_M].max()) > 2.0
    c = Camera(position=(0.0, 1.0, 2.6), forward=(0, 0, -1), width=w, height=h)
    mk = MegakernelReSTIRGI(scene, c, GI, device=cuda, **mode)
    before = (tmg.restir_gi_mono.launches, tmg.restir_gi_k1.launches, tmg.restir_gi_k2.launches)
    img = mk.render_many(6)
    torch.cuda.synchronize()
    after = (tmg.restir_gi_mono.launches, tmg.restir_gi_k1.launches, tmg.restir_gi_k2.launches)
    assert tuple(a - b for a, b in zip(after, before)) == want
    assert img.shape == (h, w, 3) and bool(torch.isfinite(img).all())
    mk.overflow.check()


# frames of 32, 50, 72, 98 and 128 tiles of 512 pixels: between them
# restir_common.tile_clustered switches K5's and K6's launch on both scenes
SWITCH = [(128, 128), (160, 160), (192, 192), (224, 224), (256, 256)]


@pytest.mark.parametrize("scene_name", ["cornell", "stress"])
@pytest.mark.parametrize("w, h", SWITCH, ids=[f"{w * h // 512}-tiles" for w, h in SWITCH])
def test_gi_kernels_match_plain_where_the_tile_launch_switches(cuda, scene_name, w, h):
    """K5 (both visibility modes) and K6 at those frames, one frame after
    two of history with the camera moved before it: each tile split over a
    cluster and one block give the same bits, K5's stage is K6's bit for
    bit, and both hold to their plain versions on the same inputs under
    chip_smoke.py's gate (fewer than 1% of pixels with an element off by
    1e-3 relative)."""
    if scene_name == "stress":
        host, _ = _stress_host()
        cam = tproc.stress(w, h)[1]
        scene = host.to(cuda)
    else:
        scene, _, cam = _di_setup(cuda, w, h)
    B = w * h
    z = (torch.zeros((tmg.GT_ROWS, B), device=cuda), torch.zeros((tmg.GS_ROWS, B), device=cuda))
    _, state, stage = tmg.restir_gi_megakernel(scene, cam, *z, 1, 2, GI, cam.proj_view, cam.proj_view)
    ppv = _moved(cam)
    k6 = _launched(tmg.restir_gi_k1, True)(scene, cam, 3, GI, state, ppv)
    assert torch.equal(k6, _launched(tmg.restir_gi_k1, False)(scene, cam, 3, GI, state, ppv))
    assert _elements_off(k6, tmg.restir_gi_k1_plain(scene, cam, 3, GI, state, ppv)) < 0.01
    for final_vis in (False, True):
        outs = []
        for fn in (_launched(tmg.restir_gi_mono, True), _launched(tmg.restir_gi_mono, False),
                   tmg.restir_gi_mono_plain):
            acc, st, sg = torch.zeros((B, 3), device=cuda), torch.empty_like(state), torch.empty_like(stage)
            fn(scene, cam, 3, GI, state, stage, ppv, acc, st, sg, final_vis=final_vis)
            outs.append((acc.T, st, sg))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
        assert torch.equal(outs[0][2], k6)
        assert max(_elements_off(a, b) for a, b in zip(outs[0], outs[2])) < 0.01
    ttrav.check_overflow(scene)


# the technique each entry point of the long-run tests renders
_TECHNIQUE_OF = {MegakernelReSTIRGI: SamplingTechnique.RESTIR_GI, MegakernelReSTIRDI: SamplingTechnique.RESTIR_DI,
                 MegakernelRenderer: SamplingTechnique.NEE_MIS}


@pytest.mark.parametrize("cls, mode, w, h, frames", [
    (MegakernelReSTIRGI, {}, 256, 256, 448), (MegakernelReSTIRGI, {}, 512, 512, 136),
    (MegakernelReSTIRGI, {}, 1920, 1088, 16),
    (MegakernelReSTIRGI, dict(mono=False), 256, 256, 448), (MegakernelReSTIRGI, dict(mono=False), 512, 512, 136),
    (MegakernelReSTIRGI, dict(mono=False), 1920, 1088, 16),
    (MegakernelReSTIRDI, {}, 1920, 1088, 320),
    (MegakernelRenderer, {}, 256, 256, 448), (MegakernelRenderer, {}, 512, 512, 136),
    (MegakernelRenderer, {}, 1920, 1088, 16),
], ids=["256", "512", "1080p", "two-kernels-256", "two-kernels-512", "two-kernels-1080p", "di-1080p",
        "k2-nee-256", "k2-nee-512", "k2-nee-1080p"])
def test_restir_gi_runs_clean_over_many_frames(cuda, cls, mode, w, h, frames):
    """``MegakernelReSTIRGI`` (K5, per-neighbour visibility; K6+K7 with
    ``mono=False``) over many frames, eight a call: K5 with its walks as
    ``__noinline__`` calls faulted with an illegal address within these
    frames (at frame 441, 129 and 9), and the kept kernels, whose walks are
    inlined, must run them clean, finite and without a stack overflow
    (ROADMAP queue 3); ``MegakernelReSTIRDI`` (K3+K4) too, over 320 frames
    at 1920x1088; and ``MegakernelRenderer`` NEE (K2, four lanes a pixel
    at eight frames a call, one inlined walk site under a capped launch
    bound), over the frames and shapes at which K5's calls faulted."""
    builder, cam = tproc.cornell_box(w, h)
    technique = _TECHNIQUE_OF[cls]
    settings = RenderSettings(technique=technique, bounces=2, samples=1,
                              sky_color=(0.05, 0.06, 0.08))     # the defaults: 5 neighbours, radius 30
    r = cls(builder.compile(), cam, settings, device=cuda, **mode)
    for _ in range(frames // 8):
        img = r.render_many(8)
    torch.cuda.synchronize()
    assert r.frame_index == 1 + frames and bool(torch.isfinite(img).all())
    r.overflow.check()


@pytest.mark.parametrize("cls, mode, scene_name, w, h, frames", [
    (MegakernelReSTIRGI, {}, "cornell", 256, 256, 448),
    (MegakernelReSTIRGI, {}, "cornell", 512, 512, 136),
    (MegakernelReSTIRGI, {}, "cornell", 1920, 1088, 16),
    (MegakernelReSTIRGI, dict(final_vis=True), "cornell", 1920, 1088, 16),
    (MegakernelReSTIRGI, {}, "stress", 128, 128, 16),
    (MegakernelReSTIRGI, dict(mono=False), "cornell", 256, 256, 448),
    (MegakernelReSTIRGI, dict(mono=False), "cornell", 1920, 1088, 16),
    (MegakernelReSTIRGI, dict(mono=False), "stress", 128, 128, 16),
    (MegakernelReSTIRDI, {}, "cornell", 1920, 1088, 16),
    (MegakernelReSTIRDI, {}, "stress", 128, 128, 16),
    (tmd.DiffRenderer, dict(bounces=4), "cornell", 256, 256, 16),
    (tmd.DiffRenderer, dict(bounces=2), "stress", 128, 128, 16),
    (MegakernelRenderer, {}, "cornell", 256, 256, 448),
    (MegakernelRenderer, {}, "cornell", 512, 512, 136),
    (MegakernelRenderer, {}, "cornell", 1920, 1088, 16),
], ids=["gi-256", "gi-512", "gi-1080p", "gi-final_vis-1080p", "gi-stress", "gi-two-kernels-256",
        "gi-two-kernels-1080p", "gi-two-kernels-stress", "di-1080p", "di-stress", "diff-256", "diff-stress",
        "k2-nee-256", "k2-nee-512", "k2-nee-1080p"])
def test_wide_walks_stay_in_range(cuda, monkeypatch, cls, mode, scene_name, w, h, frames):
    """K5 (both visibility modes), K6 and K7 (``mono=False``), K3, K4, K8
    (``DiffRenderer``, one launch a step) and K2 NEE (``MegakernelRenderer``,
    four lanes a pixel at eight frames a call) built with the walks' range
    checks (``csrc/wide.cuh``,
    ``FYP_WALK_CHECKS``), over the frames at which K5 with ``__noinline__``
    walk calls faulted (ROADMAP queue 3) and on the stress scene, whose 32
    tiles are split: every node index, child ref, leaf slot, triangle id
    and stack pointer lies in the tree, every ray and segment length is
    finite, and no walk runs away.  First a control: limits of one node,
    which the root's children break, must be counted."""
    lib = {MegakernelReSTIRGI: "restir_gi", MegakernelReSTIRDI: "restir_di",
           MegakernelRenderer: "megakernel"}.get(cls, "megakernel_diff")
    monkeypatch.setitem(kernels.EXTRA_FLAGS, lib, [*kernels.EXTRA_FLAGS.get(lib, ()), "-DFYP_WALK_CHECKS"])
    builder, cam = (tproc.stress if scene_name == "stress" else tproc.cornell_box)(w, h)
    if cls is tmd.DiffRenderer:
        r = cls(builder.compile(), cam, device=cuda, **mode)
        alb = r.scene.materials.albedo
        tgt = torch.full((w * h, 3), 0.25, device=cuda)

        def run(n):
            for f in range(n):
                _, loss = r.step(alb, tgt, 1 + f)
            return loss.reshape(1, 1)
    else:
        settings = RenderSettings(technique=_TECHNIQUE_OF[cls], bounces=2, samples=1, sky_color=(0.05, 0.06, 0.08))
        r = cls(builder.compile(), cam, settings, device=cuda, **mode)
        run = r.render_many
    nodes, slots, tris = r.scene.wide.nodes.shape[0], r.scene.wide.tris.shape[0], r.scene.geometry.tri_v.shape[0]
    rec = torch.zeros(16, dtype=torch.int32, device=cuda)
    limits = kernels.load(lib, "fyp_walk_checks", [ctypes.c_int] * 3 + [ctypes.c_void_p])
    kernels.check(limits(1, slots, tris, kernels.ptr(rec)), "fyp_walk_checks")
    run(1)
    torch.cuda.synchronize()
    assert rec[0].item() == 1 and rec[1].item() == 3 and rec[8 + 3].item() > 0
    rec.zero_()
    if hasattr(r, "reset"):
        r.reset()
    kernels.check(limits(nodes, slots, tris, kernels.ptr(rec)), "fyp_walk_checks")
    for _ in range(frames // 8):
        img = run(8)
    torch.cuda.synchronize()
    assert rec.tolist() == [0] * 16
    assert bool(torch.isfinite(img).all())
    r.overflow.check()


def _diff_inputs(cuda, size):
    """Cornell at ``size``², the default scene's albedo perturbed and a
    target, both made from a seed with NumPy."""
    builder, cam = tproc.cornell_box(size, size)
    scene = builder.compile().to(cuda)
    rng = np.random.default_rng(size)
    alb = np.clip(scene.materials.albedo.cpu().numpy() + rng.normal(0.0, 0.1, scene.materials.albedo.shape),
                  0.05, 0.95).astype(np.float32)
    tgt = rng.uniform(0.0, 0.5, (size * size, 3)).astype(np.float32)
    return scene, cam, torch.as_tensor(alb, device=cuda), torch.as_tensor(tgt, device=cuda)


@pytest.mark.parametrize("size", [64, 256])
def test_diff_megakernel_matches_its_plain_version(cuda, size):
    """K8 against ``diff_plain`` on the same inputs, 2 bounces, frame 3: the
    loss within 1e-5 relative, d_tri and d_mat within 1e-4 of their largest
    entry (float atomics sum in another order than ``index_add_``)."""
    scene, cam, alb, tgt = _diff_inputs(cuda, size)
    before = tmd.diff_megakernel.launches
    loss, d_tri = tmd.diff_megakernel(scene, cam, alb, tgt, 3, 2, (0.05, 0.06, 0.08))
    ref_loss, ref_tri = tmd.diff_plain(scene, cam, alb, tgt, 3, 2, (0.05, 0.06, 0.08))
    torch.cuda.synchronize()
    assert tmd.diff_megakernel.launches == before + 1
    assert abs(loss.item() - ref_loss.item()) / ref_loss.item() <= 1e-5
    tm = scene.geometry.tri_mat.long()
    for got, ref in ((d_tri, ref_tri), (torch.zeros_like(alb).index_add_(0, tm, d_tri),
                                        torch.zeros_like(alb).index_add_(0, tm, ref_tri))):
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    # a second launch into fresh buffers gives the same sums, not twice them
    loss2, d_tri2 = tmd.diff_megakernel(scene, cam, alb, tgt, 3, 2, (0.05, 0.06, 0.08))
    assert abs(loss2.item() - loss.item()) <= 1e-6 * loss.item()
    assert (d_tri2 - d_tri).abs().max().item() <= 1e-5 * d_tri.abs().max().item()


@pytest.mark.parametrize("bounces, size", [(1, 64), (2, 64), (3, 64), (4, 64), (2, (37, 23))],
                         ids=["1-64", "2-64", "3-64", "4-64", "2-37x23"])
def test_diff_megakernel_matches_its_plain_version_at_every_bounce_count(cuda, bounces, size):
    """K8's four instantiations against ``diff_plain`` at 64², frame 3, and
    at 37x23, whose warps' 8 x 4 tiles overhang the image: the loss within
    1e-5 relative, d_tri within 1e-4 of its largest entry."""
    if isinstance(size, tuple):
        builder, cam = tproc.cornell_box(*size)
        scene = builder.compile().to(cuda)
        rng = np.random.default_rng(7)
        alb = scene.materials.albedo
        tgt = torch.as_tensor(rng.uniform(0.0, 0.5, (size[0] * size[1], 3)).astype(np.float32), device=cuda)
    else:
        scene, cam, alb, tgt = _diff_inputs(cuda, size)
    loss, d_tri = tmd.diff_megakernel(scene, cam, alb, tgt, 3, bounces, (0.05, 0.06, 0.08))
    ref_loss, ref_tri = tmd.diff_plain(scene, cam, alb, tgt, 3, bounces, (0.05, 0.06, 0.08))
    assert abs(loss.item() - ref_loss.item()) / ref_loss.item() <= 1e-5
    assert (d_tri - ref_tri).abs().max().item() <= 1e-4 * ref_tri.abs().max().item()
    ttrav.check_overflow(scene)


def _k4_over_frames(cuda, frames=8):
    """K4 at stress 128² over ``frames`` frames of the plain DI loop, each
    frame fed the stage and state its plain version is fed: [(K4's state,
    K4's HDR, the plain state, the plain HDR)] a frame."""
    builder, cam = tproc.stress(128, 128)
    scene = tmk.morton_permuted_scene(builder.compile(native=True))[0].to(cuda)
    em = tmr.prepare_emissive_table(scene)
    state = torch.zeros((tmr.ST_ROWS, 128 * 128), device=cuda)
    out = []
    for frame in range(1, frames + 1):
        stage = tmr.restir_di_k3_plain(scene, em, cam, frame, DI, state, cam.proj_view)
        got_state, got = state.clone(), torch.zeros((128 * 128, 3), device=cuda)
        tmr.restir_di_k4(scene, em, cam, frame, DI, stage, got_state, got)
        ref = torch.zeros_like(got)
        tmr.restir_di_k4_plain(scene, em, cam, frame, DI, stage, state, ref)
        out.append((got_state, got, state.clone(), ref))
    ttrav.check_overflow(scene)
    return out


def test_k4_matches_its_plain_version_over_frames_on_the_stress_scene(cuda):
    """K4 against ``restir_di_k4_plain`` at stress 128² over 8 frames, fed
    the same stage and state each frame: the frame's HDR under the parity
    gates and fewer than 1% of pixels with a state row off by 1e-3
    relative (the kernel's shading contracts products into sums, its
    plain version does not), and one launch a frame."""
    before = tmr.restir_di_k4.launches
    for got_state, got, state, ref in _k4_over_frames(cuda):
        _gates(got.cpu().numpy(), ref.cpu().numpy())
        assert _elements_off(got_state, state) < 0.01
    assert tmr.restir_di_k4.launches == before + 8


def test_k4_bounded_shadow_walk_equals_the_unbounded_walk(cuda, monkeypatch):
    """K4's shadow walk, bounded by its emitter and walked again unbounded
    where it finds no hit, against the same kernel with the one unbounded
    walk it replaced (``kernel_variants.py di unbounded``) at stress 128²
    over 8 frames: the state and the HDR bit for bit."""
    import kernel_variants

    kept = _k4_over_frames(cuda)
    monkeypatch.setattr(kernels, "CSRC", kernels.CSRC)      # restored after the test
    monkeypatch.setattr(kernels, "_libs", {})
    kernel_variants.use_variant("di", "unbounded")
    for frame, ((state, hdr, _, _), (u_state, u_hdr, _, _)) in enumerate(zip(kept, _k4_over_frames(cuda)), 1):
        assert torch.equal(state, u_state) and torch.equal(hdr, u_hdr), f"frame {frame}"


def _many_emitters(builder):
    """The rough sphere's material made emissive: 578 emitters on the
    Cornell box at ``sphere_res=(12, 24)``, 122 at (6, 10), far more than
    K3's 9 p-hat evaluations a pixel."""
    from fypraytracer_tpu_torch.scene.manager import SceneManager

    SceneManager(builder).set_material(4, emission_color=(1.0, 0.8, 0.6), emission_power=3.0)
    return builder


@pytest.mark.parametrize("textured", [False, True], ids=["untextured", "textured"])
def test_k3_matches_plain_with_many_emitters(cuda, textured):
    """K3 with an emissive list longer than its p-hat table (a p-hat a
    candidate) against ``restir_di_k3_plain``, after two frames of history:
    the stage within 1e-3 relative on 99% of pixels; split and one block a
    tile, the same bits; untextured and textured."""
    if textured:
        from torch_textured_scene import SEED, SPHERES

        builder, _ = tproc.textured_cornell_box(W, H, big=512, seed=SEED, sphere_res=SPHERES)
    else:
        builder, _ = tproc.cornell_box(W, H)
    scene = tmk.morton_permuted_scene(_many_emitters(builder).compile())[0].to(cuda)
    cam = Camera(position=(0.0, 1.0, 2.6), forward=(0, 0, -1), width=W, height=H)
    em = tmr.prepare_emissive_table(scene)
    assert em.n > 4 * (DI.light_candidates + 1) and (scene.tex is not None) == textured
    state = torch.zeros((tmr.ST_ROWS, W * H), device=cuda)
    tmr.restir_di_megakernel_plain(scene, em, cam, state, 1, 2, DI, cam.proj_view, cam.proj_view)
    stage = _launched(tmr.restir_di_k3, True)(scene, em, cam, 3, DI, state, cam.proj_view)
    assert torch.equal(stage, _launched(tmr.restir_di_k3, False)(scene, em, cam, 3, DI, state, cam.proj_view))
    ref = tmr.restir_di_k3_plain(scene, em, cam, 3, DI, state, cam.proj_view)
    assert float((ref[tmr.S_SHADE] > 0.5).float().mean()) > 0.25
    assert _elements_off(stage, ref) < 0.01


# the shapes at which chip_smoke.py times K3-K7
K7_SHAPES = [("cornell", 256, 256), ("stress", 128, 128), ("cornell", 1920, 1088)]


@pytest.mark.parametrize("scene_name, w, h", K7_SHAPES, ids=[f"{n} {w}x{h}" for n, w, h in K7_SHAPES])
def test_k7_equals_its_plain_version_bit_for_bit(cuda, scene_name, w, h):
    """K7 against ``restir_gi_k2_plain`` on the same stage (frame 3 of
    K6, after two frames of the ``mono=False`` loop) at the default five
    neighbours of radius 30: the state and the accum bit for bit, as K5's
    second half equals its plain version's."""
    import chip_smoke

    if scene_name == "stress":
        builder, cam = tproc.stress(w, h)
        scene = tmk.morton_permuted_scene(builder.compile(native=True))[0].to(cuda)
    else:
        builder, cam = tproc.cornell_box(w, h)
        scene = tmk.morton_permuted_scene(builder.compile())[0].to(cuda)
    gi = chip_smoke.settings_for("RESTIR_GI")
    B = w * h
    z = (torch.zeros((tmg.GT_ROWS, B), device=cuda), torch.zeros((tmg.GS_ROWS, B), device=cuda))
    _, state, _ = tmg.restir_gi_megakernel(scene, cam, *z, 1, 2, gi, cam.proj_view, cam.proj_view, mono=False)
    stage = tmg.restir_gi_k1(scene, cam, 3, gi, state, cam.proj_view)
    outs = []
    for fn in (tmg.restir_gi_k2, tmg.restir_gi_k2_plain):
        acc, st = torch.zeros((B, 3), device=cuda), state.clone()
        fn(scene, cam, 3, gi, stage, st, acc)
        outs.append((acc, st))
    torch.cuda.synchronize()
    for got, ref, name in zip(outs[0], outs[1], ("accum", "state")):
        off = (got != ref).any(-1 if name == "accum" else 0).nonzero().flatten()
        assert off.numel() == 0, f"{name} differs at {off.numel()} pixels, first {off[:16].tolist()}"
    ttrav.check_overflow(scene)


def _k3_k7_outputs(cuda):
    """K3's stage and K7's state and accum at frame 3, after two frames of
    their own loops, on the Cornell box at 64² and the stress scene at 32²,
    the camera static and moved."""
    out = []
    for scene_name, w, h in (("cornell", 64, 64), ("stress", W, H)):
        for move in (False, True):
            scene, em, cam = _di_setup(cuda, w, h, scene_name)
            B = w * h
            state = torch.zeros((tmr.ST_ROWS, B), device=cuda)
            tmr.restir_di_megakernel(scene, em, cam, state, 1, 2, DI, cam.proj_view, cam.proj_view)
            gi = RenderSettings(technique=SamplingTechnique.RESTIR_GI, sky_color=(0.05, 0.06, 0.08))
            z = (torch.zeros((tmg.GT_ROWS, B), device=cuda), torch.zeros((tmg.GS_ROWS, B), device=cuda))
            _, gstate, _ = tmg.restir_gi_megakernel(scene, cam, *z, 1, 2, gi, cam.proj_view, cam.proj_view,
                                                    mono=False)
            ppv = _moved(cam, move)
            out.append(tmr.restir_di_k3(scene, em, cam, 3, DI, state, ppv))
            stage = tmg.restir_gi_k1(scene, cam, 3, gi, gstate, ppv)
            acc, st = torch.zeros((B, 3), device=cuda), gstate.clone()
            tmg.restir_gi_k2(scene, cam, 3, gi, stage, st, acc)
            out += [st, acc]
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("family, variant", [("di", "loop"), ("di", "phat"), ("gi", "vislist"), ("gi", "chained")])
def test_k3_and_k7_designs_give_the_same_bits(cuda, monkeypatch, family, variant):
    """K3 with a p-hat a candidate (``kernel_variants.py di loop``, the
    design before the committed table) and with ``p_prev`` read from the
    table too (``di phat``), K7 walking each thread's own list of segments
    (``gi vislist``) and reading its neighbours' rows test by test, as
    before its eager reads (``gi chained``), against the committed
    kernels: K3's stage and K7's state and accum bit for bit."""
    import kernel_variants

    kept = _k3_k7_outputs(cuda)
    monkeypatch.setattr(kernels, "CSRC", kernels.CSRC)      # restored after the test
    monkeypatch.setattr(kernels, "_libs", {})
    kernel_variants.use_variant(family, variant)
    for i, (a, b) in enumerate(zip(kept, _k3_k7_outputs(cuda))):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("lib, kernel", [("restir_di", "k4_shade"), ("megakernel_diff", "diff_kernel")])
def test_k4_and_k8_spill_nothing(cuda, lib, kernel):
    """ptxas's report of every instantiation of K4 and K8 (each bounce
    count): registers used, and no byte spilled."""
    import chip_smoke

    kernels.build(lib)
    rows = {k: v for k, v in chip_smoke.ptxas_report(kernels.build_info[lib]["log"]).items() if k.startswith(kernel)}
    assert len(rows) == (4 if kernel == "diff_kernel" else 1), rows
    assert all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in rows.values()), rows


def test_diff_loss_backward_on_the_card(cuda):
    scene, cam, alb, tgt = _diff_inputs(cuda, 64)
    dr = tmd.DiffRenderer(scene, cam, bounces=2, device=cuda)
    albedo = alb.clone().requires_grad_(True)
    before = tmd.diff_megakernel.launches
    loss = tmd.DiffLoss.apply(albedo, tgt, 3, dr) * 2.5
    loss.backward()
    assert tmd.diff_megakernel.launches == before + 1
    ref_loss, d_mat = dr.loss_and_grad(alb, tgt, 3)
    assert abs(loss.item() - 2.5 * ref_loss.item()) <= 1e-5 * loss.item()
    assert (albedo.grad - 2.5 * d_mat).abs().max().item() <= 1e-4 * d_mat.abs().max().item() * 2.5
    new, step_loss = dr.step(alb, tgt, 3, lr=0.5)
    assert new.device.type == "cuda" and new.shape == alb.shape and bool(torch.isfinite(new).all())


@pytest.mark.parametrize("fault", ["missing nvcc", "failed build"])
def test_diff_megakernel_build_fault_raises(cuda, fault, monkeypatch, tmp_path):
    """No fallback: without a library the wrapper raises, launches nothing
    and never takes the plain version."""
    from fypraytracer_tpu_torch.ops import kernels

    scene, cam, alb, tgt = _diff_inputs(cuda, 64)
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    if fault == "missing nvcc":
        def no_nvcc():
            raise RuntimeError("nvcc not found")
        monkeypatch.setattr(kernels, "find_nvcc", no_nvcc)
    else:
        monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ["--no-such-flag"])
    monkeypatch.setattr(tmd, "diff_plain", lambda *a, **k: pytest.fail("fell back to the plain version"))
    before = tmd.diff_megakernel.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tmd.diff_megakernel(scene, cam, alb, tgt, 3, 2, (0.05, 0.06, 0.08))
    assert tmd.diff_megakernel.launches == before


# ---- textures ---------------------------------------------------------------------

def _textured(cuda, w=W, h=H):
    """The textured Cornell box (the 64² checker and a seeded 512² page, which
    the kernels' primary level box-filters to 256²), Morton order, on the
    card, with the DI camera."""
    from torch_textured_scene import port_textured

    scene = tmk.morton_permuted_scene(port_textured(w, h, 512)[0])[0].to(cuda)
    return scene, Camera(position=(0.0, 1.0, 2.6), forward=(0, 0, -1), width=w, height=h)


TEX_SIZES = [(32, 32), (16, 16), (40, 16)]
TEX_IDS = ["C512", "C256", "C128"]


@pytest.mark.parametrize("tech", ["NEE_MIS", "COSINE", "LIGHT_SOURCE"])
def test_textured_megakernel_matches_its_plain_version(cuda, tech):
    """K2's textured instantiation against ``megakernel_plain`` (the kernel's
    levels): one launch, 4 frames."""
    scene, cam = _textured(cuda)
    assert scene.tex is not None and scene.tex.prim.device.type == "cuda"
    settings = RenderSettings(technique=SamplingTechnique[tech], bounces=2, samples=1, sky_color=(0.1, 0.15, 0.2))
    before = tmk.megakernel.launches
    got = tmk.megakernel(scene, cam, 1, 4, settings)
    ref = tmk.megakernel_plain(scene, cam, 1, 4, settings)
    torch.cuda.synchronize()
    assert tmk.megakernel.launches == before + 1
    _gates(got.cpu().numpy().reshape(H, W, 3), ref.cpu().numpy().reshape(H, W, 3))


@MOVES
@pytest.mark.parametrize("size", TEX_SIZES, ids=TEX_IDS)
def test_textured_k3_matches_its_plain_version(cuda, size, move):
    """K3's textured instantiation launched alone, after two frames of
    history, the camera static or moved, against ``restir_di_k3_plain``:
    the stage; its albedo rows exactly (before the camera rays' repair a
    primary hit could differ in its last bits from the plain version's away
    from power-of-two squares, and its texel with it: ROADMAP queue 3);
    split and one block a tile, the same bits."""
    scene, cam = _textured(cuda, *size)
    em = tmr.prepare_emissive_table(scene)
    state = torch.zeros((tmr.ST_ROWS, size[0] * size[1]), device=cuda)
    tmr.restir_di_megakernel_plain(scene, em, cam, state, 1, 2, DI, cam.proj_view, cam.proj_view)
    ppv = _moved(cam, move)
    before = tmr.restir_di_k3.launches
    stage = _launched(tmr.restir_di_k3, True)(scene, em, cam, 3, DI, state, ppv)
    assert torch.equal(stage, _launched(tmr.restir_di_k3, False)(scene, em, cam, 3, DI, state, ppv))
    ref = tmr.restir_di_k3_plain(scene, em, cam, 3, DI, state, ppv)
    torch.cuda.synchronize()
    assert tmr.restir_di_k3.launches == before + 2
    assert _elements_off(stage, ref) < 0.01
    alb = slice(tmr.S_ALB, tmr.S_ALB + 3)
    assert _elements_off(stage[alb], ref[alb]) == 0.0


@MOVES
@pytest.mark.parametrize("size", TEX_SIZES, ids=TEX_IDS)
def test_textured_gi_kernels_match_plain(cuda, size, move):
    """K6 and K5 (both visibility modes), textured, each against its plain
    version on the same inputs after two frames of history, the camera
    static or moved; K5 and K6 split and one block a tile, the same bits,
    held as ``_k5_matches`` holds it."""
    scene, cam = _textured(cuda, *size)
    B = size[0] * size[1]
    z = (torch.zeros((tmg.GT_ROWS, B), device=cuda), torch.zeros((tmg.GS_ROWS, B), device=cuda))
    _, state, stage = tmg.restir_gi_megakernel_plain(scene, cam, *z, 1, 2, GI, cam.proj_view, cam.proj_view)
    ppv = _moved(cam, move)
    counts = (tmg.restir_gi_mono.launches, tmg.restir_gi_k1.launches)
    k6 = _launched(tmg.restir_gi_k1, True)(scene, cam, 3, GI, state, ppv)
    assert torch.equal(k6, _launched(tmg.restir_gi_k1, False)(scene, cam, 3, GI, state, ppv))
    ref = tmg.restir_gi_k1_plain(scene, cam, 3, GI, state, ppv)
    assert _elements_off(k6, ref) < 0.01
    for final_vis in (False, True):
        outs = []
        for fn in (_launched(tmg.restir_gi_mono, True),
                   _launched(tmg.restir_gi_mono, False), tmg.restir_gi_mono_plain):
            acc, st, sg = torch.zeros((B, 3), device=cuda), torch.empty_like(state), torch.empty_like(stage)
            fn(scene, cam, 3, GI, state, stage, ppv, acc, st, sg, final_vis=final_vis)
            outs.append((acc, st, sg))
        torch.cuda.synchronize()
        # a tile split over a cluster and a tile one block: the same bits
        assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
        outs = outs[1:]
        _k5_matches(outs[0], outs[1], k6)
    assert (tmg.restir_gi_mono.launches, tmg.restir_gi_k1.launches) == (counts[0] + 4, counts[1] + 2)


# ---- the stack-overflow flag ----------------------------------------------------------

@pytest.mark.parametrize("cls, mode", [(Renderer, {}), (MegakernelRenderer, {}), (MegakernelReSTIRDI, {}),
                                       (MegakernelReSTIRGI, {}), (MegakernelReSTIRGI, dict(mono=False)),
                                       (tmd.DiffRenderer, {})],
                         ids=["Renderer", "MegakernelRenderer", "MegakernelReSTIRDI", "MegakernelReSTIRGI",
                              "MegakernelReSTIRGI-two-kernels", "DiffRenderer"])
def test_entry_points_raise_on_stack_overflow(cuda, cls, mode):
    """A wide BVH handed a ``stack_need`` below its tree's true need: the
    walks drop entries and set the flag, and the entry point's next call
    raises (it reads the flag without waiting; ``overflow.check()`` waits).
    ReSTIR DI's walks that set it are K3's and K4's, ReSTIR GI's K5's (K6's
    and K7's with ``mono=False``), ``DiffRenderer``'s K8's.  With
    ``mono=False`` K7 alone is also run on a short stack after a clean
    K6, and sets the flag itself."""
    import dataclasses

    builder, cam = tproc.cornell_box(W, H)
    scene = skewed_scene(builder.compile(), 8)
    assert scene.wide.stack_need == 149
    if cls is tmd.DiffRenderer:
        r = cls(scene, cam, device=cuda)
        tgt = torch.full((W * H, 3), 0.25, device=cuda)

        def run():
            r.step(r.scene.materials.albedo, tgt, 1)
    else:
        settings = {MegakernelReSTIRDI: DI, MegakernelReSTIRGI: GI}.get(cls, SETTINGS)
        r = cls(scene, cam, settings, device=cuda, **mode)

        def run():
            r.render_many(1)
    # MegakernelReSTIRGI renumbers the triangles and rebuilds the records, so
    # the short stack goes in after construction; the watch reads the same flag
    full = r.scene
    r.scene = dataclasses.replace(r.scene, wide=dataclasses.replace(r.scene.wide, stack_need=4))
    run()
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="overflow"):
        run()
    with pytest.raises(RuntimeError, match="overflow"):
        r.overflow.check()
    if mode.get("mono") is False:
        B = W * H
        full.wide.overflow.zero_()
        state = torch.zeros((tmg.GT_ROWS, B), device=cuda)
        stage = tmg.restir_gi_k1(full, cam, 1, GI, state, cam.proj_view)
        torch.cuda.synchronize()
        ttrav.check_overflow(full)                       # K6 on the full stack: clean
        tmg.restir_gi_k2(r.scene, cam, 1, GI, stage, state, torch.zeros((B, 3), device=cuda))
        torch.cuda.synchronize()
        with pytest.raises(RuntimeError, match="overflow"):
            ttrav.check_overflow(full)


# ---- the wide segment test, and K3's and K5's stack limit ----------------------------

@pytest.mark.parametrize("name", ["cornell", "stress", "skewed"])
def test_segment_kernel_matches_plain_twin(cuda, name):
    """``trace_segments`` (``csrc/trace.cu::fyp_segment_visible``, the segment
    test K5 walks) against ``segment_visible_wide`` and ``segment_visible``,
    bit for bit, on segments ending at, before and past each ray's closest
    hit; on the skewed tree its stacks take 149 entries."""
    if name == "stress":
        scene = _stress_host()[0]
    else:
        builder, _ = tproc.cornell_box(W, H)
        scene = builder.compile()
        if name == "skewed":
            scene = skewed_scene(scene, 8)
    scene = scene.to(cuda)
    r = np.random.default_rng(5)
    o = torch.as_tensor(r.uniform([-0.99, 0.01, -0.99], [0.99, 1.99, 0.99], (8192, 3)).astype(np.float32), device=cuda)
    d = torch.nn.functional.normalize(torch.as_tensor(r.normal(size=(8192, 3)).astype(np.float32), device=cuda), dim=1)
    t = ttrav.trace_rays(scene.bvh, scene.geometry, o, d)["t"]
    scale = torch.as_tensor(r.choice([1.0, 1.0005, 0.9995, 1.002, 0.998, 0.5], 8192).astype(np.float32), device=cuda)
    dist = (torch.where(t > 0, t, 1.0) * scale).contiguous()
    before = ttrav.trace_segments.launches
    got = ttrav.trace_segments(scene, o, d, dist)
    torch.cuda.synchronize()
    assert ttrav.trace_segments.launches == before + 1
    assert torch.equal(got, ttrav.segment_visible_wide(scene.wide, o, d, dist))
    assert torch.equal(got, ttrav.segment_visible(scene.bvh, scene.geometry, o, d, dist))
    assert 0.1 < got.float().mean().item() < 0.9
    ttrav.check_overflow(scene)


def test_k3_and_k5_refuse_an_oversize_stack(cuda):
    """A chain BVH whose walk needs 290 stack entries: K3-K8 hold 226 a
    thread in a block of 128, and their wrappers refuse it with the reason,
    launching nothing; K7 and K8 refuse a scene without the wide BVH too."""
    import dataclasses

    builder, cam = tproc.cornell_box(W, H)
    scene = skewed_scene(builder.compile(), 4).to(cuda)
    em = tmr.prepare_emissive_table(scene)
    B = W * H
    state = torch.zeros((tmr.ST_ROWS, B), device=cuda)
    wrappers = (tmr.restir_di_k3, tmr.restir_di_k4, tmg.restir_gi_mono, tmg.restir_gi_k1, tmg.restir_gi_k2,
                tmd.diff_megakernel)
    before = [w.launches for w in wrappers]
    with pytest.raises(ValueError, match="restir_di_k3: the wide BVH needs a stack of 290 entries"):
        tmr.restir_di_k3(scene, em, cam, 1, DI, state, cam.proj_view)
    stage = torch.zeros((tmr.S_ROWS, B), device=cuda)
    with pytest.raises(ValueError, match="restir_di_k4: the wide BVH needs a stack of 290 entries"):
        tmr.restir_di_k4(scene, em, cam, 1, DI, stage, state, torch.zeros((B, 3), device=cuda))
    gi = [torch.zeros((rows, B), device=cuda) for rows in (tmg.GT_ROWS, tmg.GS_ROWS, tmg.GT_ROWS, tmg.GS_ROWS)]
    with pytest.raises(ValueError, match="restir_gi_mono: the wide BVH needs a stack of 290 entries"):
        tmg.restir_gi_mono(scene, cam, 1, GI, gi[0], gi[1], cam.proj_view, torch.zeros((B, 3), device=cuda),
                           gi[2], gi[3])
    with pytest.raises(ValueError, match="restir_gi_k1: the wide BVH needs a stack of 290 entries"):
        tmg.restir_gi_k1(scene, cam, 1, GI, gi[0], cam.proj_view, gi[1])
    with pytest.raises(ValueError, match="restir_gi_k2: the wide BVH needs a stack of 290 entries"):
        tmg.restir_gi_k2(scene, cam, 1, GI, gi[1], gi[0], torch.zeros((B, 3), device=cuda))
    with pytest.raises(ValueError, match="diff_megakernel: the wide BVH needs a stack of 290 entries"):
        tmd.diff_megakernel(scene, cam, scene.materials.albedo, torch.zeros((B, 3), device=cuda), 1, 2,
                            (0.05, 0.06, 0.08))
    # and a scene without the wide BVH
    flat = dataclasses.replace(scene, wide=None)
    with pytest.raises(ValueError, match="no wide BVH"):
        tmg.restir_gi_k2(flat, cam, 1, GI, gi[1], gi[0], torch.zeros((B, 3), device=cuda))
    with pytest.raises(ValueError, match="no wide BVH"):
        tmd.diff_megakernel(flat, cam, scene.materials.albedo, torch.zeros((B, 3), device=cuda), 1, 2,
                            (0.05, 0.06, 0.08))
    assert [w.launches for w in wrappers] == before


# ---- camera rays and K2's pixel slabs ---------------------------------------------------

RAY_SIZES = [(40, 16), (80, 48), (256, 256)]


@pytest.mark.parametrize("lib", kernels.CAMERA_LIBS)
@pytest.mark.parametrize("w, h", RAY_SIZES, ids=[f"{w}x{h}" for w, h in RAY_SIZES])
@pytest.mark.parametrize("scene_name", ["cornell", "stress"])
def test_kernel_camera_rays_equal_generate_rays(cuda, lib, w, h, scene_name):
    """``shading.cuh::camera_ray`` as each kernel library is built (its own
    flags: restir_gi and megakernel_diff with -fmad=false, the others
    without) against ``generate_rays`` on the card, bit for bit, over the
    whole grid and a slab at an odd offset (ROADMAP queue 3: before the
    repair the plain rays divided by W and H as a product with the
    reciprocal, which parted wherever W or H is no power of two)."""
    if scene_name == "cornell":
        _, cam = tproc.cornell_box(w, h)
    else:       # scene/procedural.py::stress's camera
        cam = Camera(position=(0.0, 2.0, 4.5), forward=(0.0, -0.1, -1.0), vfov_deg=50.0, width=w, height=h)
    cam_t = trc.camera_matrices(cam, cuda)
    o, d = generate_rays(cam.inv_projection, cam.inv_view, w, h, device=cuda)
    ko, kd = kernels.camera_rays(lib, cam_t, w, h)
    torch.cuda.synchronize()
    off = (kd != d).any(-1).nonzero().flatten()
    assert off.numel() == 0, f"{off.numel()} of {w * h} rays differ, first {off[:8].tolist()}"
    assert torch.equal(ko, o)
    pix0 = w * h // 3 + 1
    _, kd = kernels.camera_rays(lib, cam_t, w, h, pix0, w * h // 2)
    assert torch.equal(kd, d[pix0:pix0 + w * h // 2])


def _slab_starts(n_pix, n_slabs):
    """Boundaries of ``n_slabs`` slabs of ceil(n_pix / n_slabs) pixels, the
    last one ragged."""
    per = -(-n_pix // n_slabs)
    return list(range(0, n_pix, per)) + [n_pix]


def _slabs_equal_whole(scene, cam, frames, settings, lanes, counts=(2, 3, 7)):
    whole = tmk.megakernel(scene, cam, 1, frames, settings, lanes=lanes)
    n = cam.width * cam.height
    for k in counts:
        starts = _slab_starts(n, k)
        before = tmk.megakernel.launches
        parts = [tmk.megakernel(scene, cam, 1, frames, settings, lanes=lanes, pix0=a, n_pix=b - a)
                 for a, b in zip(starts, starts[1:])]
        joined = torch.cat(parts)
        torch.cuda.synchronize()
        assert tmk.megakernel.launches == before + len(parts)
        off = (joined != whole).any(-1).nonzero().flatten()
        assert off.numel() == 0, f"{k} slabs: {off.numel()} pixels differ, first {off[:8].tolist()}"
    ttrav.check_overflow(scene)
    return whole


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("tech", list(tmk.SAMPLER_OF), ids=lambda t: t.name)
def test_megakernel_slabs_join_into_the_one_launch_image(cuda, tech, lanes):
    """K2's pixel-slab entry, every sampler and lane count: 2, 3 and 7 slabs
    of Cornell 72x40 (2,880 pixels; slabs of 1,440, 960 and 412 pixels, the
    last 408, off any multiple of a block of 128 threads) joined equal the
    one-launch image bit for bit, and the slabs launch once each."""
    builder, cam = tproc.cornell_box(72, 40, sphere_res=(6, 10))
    scene = builder.compile().to(cuda)
    whole = _slabs_equal_whole(scene, cam, 4, SETTINGS.replace(technique=tech), lanes)
    assert float(whole.mean()) > 0.0


def test_megakernel_nee_four_lane_slabs_at_1080p(cuda):
    """The four-lane NEE launch of ``test_megakernel_nee_four_lanes_at_1080p``
    (ROADMAP queue 3) cut into 2, 3 and 7 slabs, 8 frames: bit for bit the
    one launch."""
    builder, cam = tproc.cornell_box(1920, 1088)
    scene = builder.compile().to(cuda)
    whole = _slabs_equal_whole(scene, cam, 8, SETTINGS, 4)
    assert bool(torch.isfinite(whole).all())


@pytest.mark.parametrize("tech", ["NEE_MIS", "COSINE", "LIGHT_SOURCE"])
def test_textured_megakernel_slabs_join(cuda, tech):
    scene, cam = _textured(cuda, 48, 40)
    settings = RenderSettings(technique=SamplingTechnique[tech], bounces=2, samples=1, sky_color=(0.1, 0.15, 0.2))
    _slabs_equal_whole(scene, cam, 4, settings, None)


def test_sharded_paths_on_one_process(cuda):
    """The sharded entry points on a mesh of one process (no collectives):
    ``sharded_megakernel_render`` is ``megakernel``'s one launch and
    ``sharded_render`` the cosine wavefront frame, bit for bit."""
    from fypraytracer_tpu_torch.parallel import shard
    from fypraytracer_tpu_torch.render.renderer import frame_hdr

    builder, cam = tproc.cornell_box(64, 48)
    host = builder.compile()
    mesh = shard.make_pixel_mesh(device=cuda)
    scene = shard.replicate_scene(host, mesh)
    before = tmk.megakernel.launches
    got = shard.sharded_megakernel_render(scene, mesh, 64, 48, SETTINGS, 4)(cam, 1)
    assert tmk.megakernel.launches == before + 1
    assert torch.equal(got, tmk.megakernel(scene, cam, 1, 4, SETTINGS))
    cos = SETTINGS.replace(technique=SamplingTechnique.COSINE)
    got = shard.sharded_render(scene, mesh, 64, 48, cos)(cam.inv_projection, cam.inv_view, 1)
    assert torch.equal(got, frame_hdr(scene, cam, 1, cos).reshape(-1, 3))


# ---- K2's prepared launch (render/megakernel.py: PreparedK2, K2Launcher) --------------

def _unchanged(r, manager, cam):
    pass


def _camera_moved(r, manager, cam):
    cam.move_to(np.float32([0.1, 1.0, 3.2]), forward=np.float32([0.05, -0.1, -1.0]))
    r.reset()


def _material_edited(r, manager, cam):
    manager.set_material(0, emission_power=2.5, albedo=(0.9, 0.2, 0.1))
    manager.apply(r)


def _bounces_changed(r, manager, cam):
    r.settings = r.settings.replace(bounces=3)
    r.reset()


# (change, builds and camera uploads after it)
K2_CHANGES = [(_unchanged, 1, 1), (_camera_moved, 1, 2), (_material_edited, 2, 1), (_bounces_changed, 2, 1)]


@pytest.mark.parametrize("change, builds, uploads", K2_CHANGES, ids=[c[0].__name__[1:] for c in K2_CHANGES])
def test_render_many_keeps_its_prepared_launch_bit_for_bit(cuda, change, builds, uploads):
    """``render_many`` through its kept launch, three calls after each
    change (the unchanged renderer keeps accumulating, the others restart),
    gives the accumulator and the average of a renderer made afresh on the
    changed scene, camera and settings, bit for bit, and prepares or
    uploads only what the change needs."""
    import copy

    from fypraytracer_tpu_torch.scene.manager import SceneManager

    builder, cam = tproc.cornell_box(W, H, sphere_res=(6, 10))
    manager = SceneManager(builder, native=False)
    r = MegakernelRenderer(manager.scene, cam, SETTINGS, device=cuda)
    for _ in range(3):
        r.render_many(4)
    change(r, manager, cam)
    for _ in range(3):
        got = r.render_many(4)
    fresh = MegakernelRenderer(manager.scene, copy.deepcopy(cam), r.settings, device=cuda)
    for _ in range((r.frame_index - 1) // 4):          # every call since the renderer's last restart
        want = fresh.render_many(4)
    torch.cuda.synchronize()
    assert torch.equal(r.accum, fresh.accum) and torch.equal(got, want)
    assert (r.prepared_builds, r.camera_uploads) == (builds, uploads)
    assert (fresh.prepared_builds, fresh.camera_uploads) == (1, 1)
    r.overflow.check()


def test_render_many_equals_one_shot_launches_bit_for_bit(cuda):
    """Five calls of ``render_many(8)`` through the kept launch sum to the
    one-shot ``megakernel`` launches of the same frames, added in the
    same order, bit for bit (the same kernel and arguments)."""
    scene, cam = _scene()
    r = MegakernelRenderer(scene, cam, SETTINGS, device=cuda)
    want = torch.zeros_like(r.accum)
    for i in range(5):
        r.render_many(8)
        want += tmk.megakernel(r.scene, cam, 1 + 8 * i, 8, SETTINGS)
    torch.cuda.synchronize()
    assert torch.equal(r.accum, want)
    assert (r.prepared_builds, r.camera_uploads) == (1, 1)


def test_sharded_megakernel_slabs_join_through_kept_launches(cuda):
    """``sharded_megakernel_render`` on each of 3 shards of one process (a
    mesh of 3 seen from each index, no collectives): each slab's launch is
    kept across calls, and the slabs join into the one-launch image bit
    for bit, before and after a camera move."""
    from fypraytracer_tpu_torch.parallel import shard
    from fypraytracer_tpu_torch.parallel.distributed import PixelMesh

    builder, cam = tproc.cornell_box(72, 40, sphere_res=(6, 10))
    scene = builder.compile().to(cuda)
    renders = [shard.sharded_megakernel_render(scene, PixelMesh(None, i, 3, cuda, (0, 1, 2)), 72, 40, SETTINGS, 4)
               for i in range(3)]
    for frame0 in (1, 5):
        joined = torch.cat([render(cam, frame0) for render in renders])
        assert torch.equal(joined, tmk.megakernel(scene, cam, frame0, 4, SETTINGS))
    cam.move_to(np.float32([0.2, 1.1, 3.0]))
    joined = torch.cat([render(cam, 9) for render in renders])
    assert torch.equal(joined, tmk.megakernel(scene, cam, 9, 4, SETTINGS))
    ttrav.check_overflow(scene)
