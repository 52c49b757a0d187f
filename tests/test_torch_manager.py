"""The port's SceneManager (incremental scene edits) and profiling utilities.

The cases of tests/test_manager.py on the port, then: the same sequence of
edits through the JAX manager and the port's gives equal scenes; every
entry point handed an edited scene through ``apply(renderer)`` renders as
a renderer made anew on it would (its derived state rebuilt: the emissive
table, the Morton-permuted scene, the material ids, the overflow watch);
an ``albedo_map`` edit alone rebuilds the kernels' texture levels.
"""

import os

import numpy as np
import pytest
import torch

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.scene.manager import SceneManager
from fypraytracer_tpu_torch.scene.procedural import cornell_box


def _cosine():
    return RenderSettings(technique=SamplingTechnique.COSINE, bounces=1)


# -- the cases of tests/test_manager.py ---------------------------------------


def test_transform_edit_moves_geometry():
    builder, cam = cornell_box(width=16, height=16, with_spheres=True, sphere_res=(4, 6))
    mgr = SceneManager(builder)
    s0 = mgr.scene
    sphere_mesh = 6  # first sphere (after 5 walls + light)
    start = builder.meshes[sphere_mesh].vertex_start
    count = len(builder.meshes[sphere_mesh].positions)
    pos0 = np.asarray(s0.geometry.positions[start:start + count]).mean(0)

    mgr.set_mesh_transform(sphere_mesh, position=(0.2, 0.9, 0.0))
    assert mgr.dirty
    s1 = mgr.apply()
    assert not mgr.dirty
    pos1 = np.asarray(s1.geometry.positions[start:start + count]).mean(0)
    assert np.linalg.norm(pos1 - pos0) > 0.3
    np.testing.assert_allclose(np.asarray(s0.geometry.positions[:4]), np.asarray(s1.geometry.positions[:4]))
    assert mgr.version == 1
    assert s1.wide is not s0.wide                     # the kernels' BVH follows the geometry


def test_material_edit_rebuilds_emissives_and_resets_renderer():
    from fypraytracer_tpu_torch.render.renderer import Renderer

    builder, cam = cornell_box(width=16, height=16, with_spheres=False)
    mgr = SceneManager(builder)
    r = Renderer(mgr.scene, cam, _cosine(), device="cpu")
    r.render_hdr()
    assert r.frame_index == 2

    n_emissive0 = mgr.scene.num_emissive
    mgr.set_material(1, emission_color=(1.0, 0.2, 0.2), emission_power=2.0)
    s1 = mgr.apply(renderer=r)
    assert s1.num_emissive == n_emissive0 + 2
    assert r.frame_index == 1  # accumulation reset (WalnutApp.cpp:638-643)
    assert float(r.accum.max()) == 0.0
    assert torch.equal(r.scene.emissive_tris, torch.as_tensor(s1.emissive_tris))


def test_add_mesh_mid_session_renders(tmp_path):
    from fypraytracer_tpu_torch.render.renderer import Renderer
    from fypraytracer_tpu_torch.scene.procedural import uv_sphere

    builder, cam = cornell_box(width=16, height=16, with_spheres=False)
    mgr = SceneManager(builder)
    r = Renderer(mgr.scene, cam, _cosine(), device="cpu")
    hdr0 = r.render_hdr().clone()
    t0 = mgr.scene.num_triangles

    p, t, n, u = uv_sphere(0.6, 6, 8)
    mid = mgr.add_mesh(p, t, normals=n, uvs=u, material=0, position=(0.0, 0.0, 0.0))
    assert mgr.dirty and mid == len(builder.meshes) - 1
    s1 = mgr.apply(renderer=r)
    assert s1.num_triangles == t0 + len(t)
    assert r.frame_index == 1
    hdr1 = r.render_hdr()
    assert bool(torch.isfinite(hdr1).all())
    assert (hdr1 - hdr0).abs().max().item() > 1e-3   # the sphere occludes the back wall

    obj = tmp_path / "tri.obj"
    obj.write_text("v -1 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    mid2 = mgr.load_mesh(str(obj), material=0, position=(0, 0, 0.5))
    s2 = mgr.apply()
    assert s2.num_triangles == s1.num_triangles + 1
    assert mgr.version == 2 and mid2 == mid + 1


def test_frame_timer_and_rays_counter():
    import time

    from fypraytracer_tpu_torch.utils.profiling import FrameTimer

    t = FrameTimer(device="cpu")
    with t.frame():
        time.sleep(0.01)
    with t.frame():
        time.sleep(0.03)
    assert t.frames == 2
    assert 5 < t.avg_ms < 100


def test_add_texture_mid_session_repacks_atlas():
    from fypraytracer_tpu_torch.render.renderer import Renderer

    builder, cam = cornell_box(width=16, height=16, with_spheres=False)
    mgr = SceneManager(builder)
    r = Renderer(mgr.scene, cam, _cosine(), device="cpu")
    base = r.render_hdr().clone()
    n_pages0 = mgr.scene.textures.pages.shape[0]

    tex = np.zeros((8, 8, 3), np.float32)
    tex[..., 1] = 1.0
    tid = mgr.add_texture(tex)
    assert mgr.dirty
    mgr.set_material(0, albedo_map=tid)
    s1 = mgr.apply(renderer=r)
    assert s1.textures.pages.shape[0] == n_pages0 + 1 or n_pages0 == 1
    assert int(np.asarray(s1.materials.albedo_map)[0]) == tid
    assert s1.tex is not None                         # the kernels' levels follow the new map

    edited = r.render_hdr()
    g_ratio0 = base[..., 1].mean().item() / max(base[..., 0].mean().item(), 1e-9)
    g_ratio1 = edited[..., 1].mean().item() / max(edited[..., 0].mean().item(), 1e-9)
    assert g_ratio1 > 1.25 * g_ratio0, (g_ratio0, g_ratio1)


def test_add_texture_from_file(tmp_path):
    from fypraytracer_tpu_torch.utils.image import save_png

    builder, cam = cornell_box(width=16, height=16, with_spheres=False)
    mgr = SceneManager(builder)
    png = tmp_path / "t.png"
    save_png(str(png), np.full((8, 8, 3), 200, np.uint8))
    tid = mgr.add_texture(str(png))
    mgr.set_material(0, albedo_map=tid)
    s = mgr.apply()
    np.testing.assert_allclose(np.asarray(s.textures.pages[tid]), 200.0 / 255.0, atol=1e-3)


def test_stale_albedo_map_errors_loudly():
    builder, cam = cornell_box(width=16, height=16, with_spheres=False)
    mgr = SceneManager(builder)
    with pytest.raises(ValueError, match="albedo_map"):
        mgr.set_material(0, albedo_map=0)   # no textures registered
    mgr.builder._mat["albedo_map"][1] = 5
    mgr._materials_dirty.add(1)
    with pytest.raises(ValueError, match="albedo_map"):
        mgr.apply()


# -- the port against the JAX manager, and the port's renderers ---------------


def _edits(mgr, procedural, tmp_path):
    """One sequence of edits, as the same calls on either manager; yields
    after each ``apply``."""
    mgr.set_material(0, albedo=(0.9, 0.1, 0.1), roughness=0.5)
    yield mgr.apply()
    mgr.set_material(1, emission_color=(1.0, 0.2, 0.2), emission_power=2.0)
    yield mgr.apply()
    tex = np.linspace(0, 1, 6 * 10 * 3, dtype=np.float32).reshape(6, 10, 3)
    mgr.set_material(2, albedo_map=mgr.add_texture(tex))
    yield mgr.apply()
    mgr.set_mesh_transform(6, position=(0.2, 0.9, 0.0), rotation=(10, 20, 30), scale=(1.0, 0.5, 1.5))
    yield mgr.apply()
    p, t, n, u = procedural.uv_sphere(0.3, 4, 6)
    mgr.add_mesh(p, t, normals=n, uvs=u, material=2, position=(0.0, 0.5, 0.0))
    obj = tmp_path / "tri.obj"
    obj.write_text("v -1 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\nf 1/1 2/2 3/3\n")
    mgr.load_mesh(str(obj), material=1, position=(0, 0, 0.5))
    yield mgr.apply()


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_manager_edits_equal_jax_manager(tmp_path, native):
    """The same edits through the JAX ``SceneManager`` and the port's:
    after each apply the scenes are equal field by field (the light tree to
    1e-6 with the NumPy builder, bit for bit with the native one, the same
    C++ source), and the port's ``Scene.wide`` and ``Scene.tex`` are those
    its builders make of the new scene."""
    import fypraytracer_tpu.scene.procedural as jproc
    from fypraytracer_tpu.scene.manager import SceneManager as JManager
    from fypraytracer_tpu_torch.accel.wide import build_wide
    from fypraytracer_tpu_torch.ops.texture import make_kernel_tex
    from fypraytracer_tpu_torch.scene import procedural as tproc
    from test_torch_scene import _assert_scenes_equal

    if native:
        from fypraytracer_tpu.accel import native as jnative
        from fypraytracer_tpu_torch.accel import native as tnative

        if not (jnative.available() and tnative.available()):
            pytest.skip("no native builders here")
    jm = JManager(jproc.cornell_box(16, 16, sphere_res=(4, 6))[0], native=native)
    tm = SceneManager(tproc.cornell_box(16, 16, sphere_res=(4, 6))[0], native=native)
    steps = 0
    for js, ts in zip(_edits(jm, jproc, tmp_path), _edits(tm, tproc, tmp_path)):
        _assert_scenes_equal(ts, js, light_atol=0.0 if native else 1e-6)
        fresh = build_wide(ts.bvh, ts.geometry)
        np.testing.assert_array_equal(ts.wide.nodes, fresh.nodes)
        np.testing.assert_array_equal(ts.wide.tris, fresh.tris)
        want = make_kernel_tex(ts.materials, ts.textures)
        assert (ts.tex is None) == (want is None)
        if want is not None:
            assert torch.equal(torch.as_tensor(ts.tex.prim), want.prim)
            assert torch.equal(torch.as_tensor(ts.tex.bounce), want.bounce)
        steps += 1
    assert steps == 5 and tm.version == jm.version == 5


def _renderer_cases():
    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer
    from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
    from fypraytracer_tpu_torch.render.megakernel_restir_gi import MegakernelReSTIRGI
    from fypraytracer_tpu_torch.render.renderer import Renderer

    di = RenderSettings(technique=SamplingTechnique.RESTIR_DI, light_candidates=2, spatial_neighbors=2,
                        spatial_radius=4)
    gi = RenderSettings(technique=SamplingTechnique.RESTIR_GI, spatial_neighbors=2, spatial_radius=4)
    nee = RenderSettings(technique=SamplingTechnique.NEE_MIS)
    return [(Renderer, nee, {}), (Renderer, di, {}), (MegakernelRenderer, nee, {}), (MegakernelReSTIRDI, di, {}),
            (MegakernelReSTIRGI, gi, {}), (MegakernelReSTIRGI, gi, dict(mono=False))]


@pytest.mark.parametrize("case", range(6), ids=["Renderer-nee", "Renderer-di", "MegakernelRenderer",
                                                 "MegakernelReSTIRDI", "MegakernelReSTIRGI",
                                                 "MegakernelReSTIRGI-two-kernels"])
@pytest.mark.parametrize("edit", ["material", "geometry"])
def test_apply_rebuilds_the_renderers_state(case, edit):
    """``apply(renderer)`` after an emission edit (the emissive table and
    light tree change) or a mesh move: the renderer, which had rendered
    two frames of the old scene, renders the next two as one made anew on
    the edited scene does, bit for bit."""
    cls, settings, mode = _renderer_cases()[case]
    builder, cam = cornell_box(16, 16, sphere_res=(4, 6))
    mgr = SceneManager(builder, native=False)
    r = cls(mgr.scene, cam, settings, device="cpu", **mode)
    r.render_many(2)
    if edit == "material":
        mgr.set_material(1, emission_color=(1.0, 0.2, 0.2), emission_power=2.0)
    else:
        mgr.set_mesh_transform(6, position=(0.1, 0.5, 0.2))
    mgr.apply(renderer=r)
    assert r.frame_index == 1
    fresh = cls(mgr.scene, cam, settings, device="cpu", **mode)
    assert torch.equal(r.render_many(2), fresh.render_many(2))
    if hasattr(fresh, "emitters"):                   # ReSTIR DI's emissive table
        for f in ("p0", "emission", "tri"):
            assert torch.equal(getattr(r.emitters, f), getattr(fresh.emitters, f))


def test_apply_rebuilds_the_diff_renderers_state():
    """``DiffRenderer`` takes the edited scene's material ids and count: a
    mesh moved to another material and a material added change both."""
    from fypraytracer_tpu_torch.render.megakernel_diff import DiffRenderer

    builder, cam = cornell_box(16, 16, sphere_res=(4, 6))
    mgr = SceneManager(builder, native=False)
    dr = DiffRenderer(mgr.scene, cam, bounces=1, device="cpu")
    extra = builder.add_material(albedo=(0.2, 0.7, 0.3))
    builder.meshes[6].material = extra
    mgr.set_mesh_transform(6, position=(0.1, 0.5, 0.2))
    mgr.apply(renderer=dr)
    fresh = DiffRenderer(mgr.scene, cam, bounces=1, device="cpu")
    assert dr.n_mats == fresh.n_mats == extra + 1
    assert torch.equal(dr.tri_mat, fresh.tri_mat)
    alb = fresh.scene.materials.albedo
    target = torch.full((256, 3), 0.2)
    for a, b in zip(dr.loss_and_grad(alb, target, 1), fresh.loss_and_grad(alb, target, 1)):
        assert torch.equal(a, b)


def test_albedo_map_edit_alone_rebuilds_the_kernel_levels():
    """A texture registered with the scene but mapped by no material: the
    scene has no kernel levels (``Scene.tex`` None).  Mapping it, with no
    texture added, rebuilds them (the renderers would refuse the scene
    otherwise); unmapping it drops them again."""
    from fypraytracer_tpu_torch.ops.texture import check_scene_tex
    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer

    builder, cam = cornell_box(16, 16, with_spheres=False)
    tid = builder.add_texture(np.full((4, 4, 3), 0.5, np.float32))
    mgr = SceneManager(builder, native=False)
    assert mgr.scene.tex is None
    mk = MegakernelRenderer(mgr.scene, cam, RenderSettings(technique=SamplingTechnique.NEE_MIS), device="cpu")
    mgr.set_material(0, albedo_map=tid)
    s1 = mgr.apply(renderer=mk)
    assert s1.tex is not None and mk.scene.tex is not None
    check_scene_tex(s1)
    assert bool(torch.isfinite(mk.render_many(1)).all())
    mgr.set_material(0, albedo_map=-1)
    assert mgr.apply(renderer=mk).tex is None
    check_scene_tex(mk.scene)


def test_device_trace_and_log_event(tmp_path):
    """``device_trace`` writes a torch.profiler trace of the block (CPU
    activity only here)."""
    from fypraytracer_tpu_torch.utils.profiling import device_trace

    with device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())
