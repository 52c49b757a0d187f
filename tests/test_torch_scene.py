"""Scene building in the port against the JAX package's NumPy builders.

The port's ``SceneBuilder.compile`` must give the arrays of the JAX
package's ``compile(native=False)``: geometry, materials and BVH exactly,
the light tree to 1e-6 (its cone angles go through arccos/cos).  Also: the
port imports and renders with JAX and the JAX package blocked.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import fypraytracer_tpu.scene.procedural as jproc
from fypraytracer_tpu_torch.scene import procedural as tproc
from fypraytracer_tpu_torch.scene.types import Scene, scene_from_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CORNELLS = [dict(), dict(with_spheres=False), dict(sphere_res=(6, 10), light_power=9.0)]


def _pair(kw):
    jb, jcam = jproc.cornell_box(32, 32, **kw)
    tb, tcam = tproc.cornell_box(32, 32, **kw)
    return jb.compile(native=False), tb.compile(), jcam, tcam


def _fields(obj):
    import dataclasses
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("kw", CORNELLS)
@pytest.mark.parametrize("part", ["geometry", "materials", "bvh", "textures"])
def test_cornell_arrays_exact(kw, part):
    js, ts, _, _ = _pair(kw)
    jf, tf = _fields(getattr(js, part)), _fields(getattr(ts, part))
    assert jf.keys() == tf.keys()
    for name in jf:
        j, t = jf[name], tf[name]
        if isinstance(j, int):
            assert j == t, name
        else:
            assert np.asarray(j).dtype == np.asarray(t).dtype, name
            np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=name)
    np.testing.assert_array_equal(ts.emissive_tris, js.emissive_tris)


@pytest.mark.parametrize("kw", CORNELLS)
def test_cornell_light_tree(kw):
    js, ts, _, _ = _pair(kw)
    jl, tl = _fields(js.light_tree), _fields(ts.light_tree)
    assert jl.keys() == tl.keys()
    for name in jl:
        j, t = np.asarray(jl[name]), np.asarray(tl[name])
        if j.dtype.kind == "f":
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name)


def test_camera_matches():
    _, _, jcam, tcam = _pair({})
    for name in ("projection", "view", "inv_projection", "inv_view"):
        np.testing.assert_array_equal(getattr(tcam, name), getattr(jcam, name))


def test_scene_from_arrays_and_to():
    js, ts, _, _ = _pair({})
    s = scene_from_arrays(js, "cpu")
    assert isinstance(s, Scene)
    assert s.bvh.leaf_size == js.bvh.leaf_size and s.light_tree.max_depth == js.light_tree.max_depth
    assert s.geometry.tri_v.dtype == torch.int32 and s.geometry.positions.dtype == torch.float32
    assert s.bvh.prim_idx.dtype == torch.int32 and s.light_tree.parent.dtype == torch.int32
    np.testing.assert_array_equal(s.bvh.prim_idx.numpy(), ts.bvh.prim_idx)
    np.testing.assert_array_equal(s.geometry.positions.numpy(), ts.geometry.positions)
    moved = ts.to("cpu")
    assert isinstance(moved.geometry.positions, torch.Tensor)
    np.testing.assert_array_equal(moved.light_tree.leaf_of_tri.numpy(), ts.light_tree.leaf_of_tri)
    assert s.num_triangles == ts.num_triangles and s.num_emissive == ts.num_emissive == 2


def test_cone_trig_is_host_float32():
    _, ts, _, _ = _pair({})
    lt = ts.to("cpu").light_tree
    cos_o, sin_o, cos_e, sin_e = lt.cone_trig
    to = ts.light_tree.theta_o.astype(np.float32)
    te = ts.light_tree.theta_e.astype(np.float32)
    for got, want in ((cos_o, np.cos(to)), (sin_o, np.sin(to)), (cos_e, np.cos(te)), (sin_e, np.sin(te))):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert lt.cone_trig is lt.cone_trig      # computed once


def test_golden_png_decodes_like_jax_package():
    from fypraytracer_tpu.utils.image import load_png as jload
    from fypraytracer_tpu_torch.utils import metrics
    from fypraytracer_tpu_torch.utils.image import load_png, save_png

    path = os.path.join(REPO, "benchmarks", "goldens", "cornell_nee.png")
    img = load_png(path)
    np.testing.assert_array_equal(img, jload(path))
    assert img.shape == (256, 256, 3) and img.dtype == np.uint8
    assert metrics.psnr(metrics.mse_8bit(img, img)) == float("inf")
    assert metrics.rays_per_frame(256, 256, 1, 2, shadow_rays_per_bounce=1) == 256 * 256 * 5   # bench.py:142


def test_port_runs_without_jax(tmp_path):
    """Import the port and render a 16² Cornell frame on the CPU with jax
    and fypraytracer_tpu blocked on sys.meta_path."""
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "fypraytracer_tpu"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        import fypraytracer_tpu_torch
        from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
        from fypraytracer_tpu_torch.render.renderer import Renderer
        from fypraytracer_tpu_torch.scene.procedural import cornell_box

        builder, cam = cornell_box(16, 16, sphere_res=(6, 10))
        r = Renderer(builder.compile(), cam, RenderSettings(
            technique=SamplingTechnique.NEE_MIS, sky_color=(0.05, 0.06, 0.08)), device="cpu")
        img = r.render_frame()
        assert img.shape == (16, 16) and img.dtype == np.uint32
        assert not any(m.split(".")[0] in ("jax", "fypraytracer_tpu") for m in sys.modules)
        print("OK", int((img & 0xFF).mean()))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def _assert_scenes_equal(ts, js, light_atol=1e-6):
    for part in ("geometry", "materials", "bvh", "textures"):
        jf, tf = _fields(getattr(js, part)), _fields(getattr(ts, part))
        assert jf.keys() == tf.keys()
        for name in jf:
            j, t = jf[name], tf[name]
            if isinstance(j, int):
                assert j == t, name
            else:
                np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=f"{part}.{name}")
    for name, j in _fields(js.light_tree).items():
        j, t = np.asarray(j), np.asarray(getattr(ts.light_tree, name))
        if j.dtype.kind == "f":
            np.testing.assert_allclose(t, j, rtol=0, atol=light_atol, err_msg=name)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name)
    np.testing.assert_array_equal(np.asarray(ts.emissive_tris), np.asarray(js.emissive_tris))


@pytest.mark.parametrize("kw", [dict(grid=1, sphere_res=(4, 6)), dict(grid=2, sphere_res=(6, 8))])
def test_stress_scene_matches_jax_builder(kw):
    """The stress scene (procedural.py:221-258) at a reduced lattice; the
    card builds the full 200,712-triangle scene with the same code."""
    jb, jcam = jproc.stress(32, 32, **kw)
    tb, tcam = tproc.stress(32, 32, **kw)
    js, ts = jb.compile(native=False), tb.compile()
    n = kw["grid"]
    assert ts.geometry.tri_v.shape[0] == 6 + 2 + 2 * n * n * 2 * kw["sphere_res"][0] * kw["sphere_res"][1]
    _assert_scenes_equal(ts, js)
    np.testing.assert_array_equal(tcam.inv_view, jcam.inv_view)
    np.testing.assert_array_equal(tcam.inv_projection, jcam.inv_projection)


def test_single_triangle_matches_jax_builder():
    jb, jcam = jproc.single_triangle()
    tb, tcam = tproc.single_triangle()
    _assert_scenes_equal(tb.compile(), jb.compile(native=False))
    assert (tcam.width, tcam.height) == (jcam.width, jcam.height) == (64, 64)


@pytest.mark.parametrize("scene", ["cornell", "stress"])
def test_morton_permuted_scene_matches_jax(scene):
    """The port's Morton order numbers triangles as the JAX megakernels do
    (megakernel.py:271-314): every id-valued field remapped alike."""
    from fypraytracer_tpu.render.megakernel import morton_permuted_scene as jmorton
    from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene

    if scene == "cornell":
        jb, _ = jproc.cornell_box(32, 32, sphere_res=(6, 10))
        tb, _ = tproc.cornell_box(32, 32, sphere_res=(6, 10))
    else:
        jb, _ = jproc.stress(32, 32, grid=2, sphere_res=(6, 8))
        tb, _ = tproc.stress(32, 32, grid=2, sphere_res=(6, 8))
    js, jperm = jmorton(jb.compile(native=False))
    ts, tperm = morton_permuted_scene(tb.compile())
    np.testing.assert_array_equal(tperm, jperm)
    assert not np.array_equal(tperm, np.arange(tperm.shape[0]))
    _assert_scenes_equal(ts, js)
