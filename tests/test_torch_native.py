"""The port's binding of the C++ structure builders (``accel/native.py``).

The cases of tests/test_native.py on the port: the native BVH's invariants,
its closest hits against the NumPy BVH's (>= 99%: the topology differs by
design, tests/test_native.py:1-3), the native light tree's pick
distribution against the NumPy tree's (within 0.02) and the NEE image.
Then the port's structures against the JAX package's binding of the same
library, bit for bit; the PNG unfilter against NumPy's and PIL; the build
writing under ``fypraytracer_tpu_torch/_build/`` and never under
``native/``; and the fall back to NumPy where g++ is missing.
"""

import hashlib
import os
import subprocess

import numpy as np
import pytest
import torch

from fypraytracer_tpu_torch.accel import native
from fypraytracer_tpu_torch.scene import procedural as tproc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not native.available(), reason="g++ unavailable: no native builders to test")


def _cornell(native_build: bool):
    builder, cam = tproc.cornell_box(width=24, height=24)
    scene = builder.compile(native=native_build)
    assert builder.last_builders == dict(bvh="native" if native_build else "numpy",
                                         light_tree="native" if native_build else "numpy")
    return scene, cam


def test_native_bvh_invariants():
    scene, _ = _cornell(True)
    flat = scene.bvh
    n = flat.lo.shape[0]
    prims = flat.prim_idx[flat.prim_idx >= 0]
    assert sorted(prims.tolist()) == list(range(scene.num_triangles))
    assert np.all(flat.miss > np.arange(n))
    assert np.all(flat.miss <= n)
    leaves = flat.first >= 0
    assert np.all(flat.first[leaves] % flat.leaf_size == 0)
    assert scene.wide is not None and scene.wide.nodes.shape[0] > 0


def test_native_bvh_same_hits_as_numpy():
    from fypraytracer_tpu_torch.core.camera import generate_rays
    from fypraytracer_tpu_torch.ops.traverse import trace_rays, trace_rays_wide

    scene_n, cam = _cornell(True)
    scene_p, _ = _cornell(False)
    o, d = generate_rays(cam.inv_projection, cam.inv_view, 24, 24, device="cpu")
    sn, sp = scene_n.to("cpu"), scene_p.to("cpu")
    a = trace_rays(sn.bvh, sn.geometry, o, d)["tri"]
    b = trace_rays(sp.bvh, sp.geometry, o, d)["tri"]
    assert (a == b).float().mean().item() >= 0.99  # ties on shared quad edges only
    # the kernels' wide BVH built from the native tree walks to its hits
    assert torch.equal(trace_rays_wide(sn.wide, o, d)["tri"], a)


def test_native_light_tree_equivalent_distribution():
    from fypraytracer_tpu_torch.core import rng
    from fypraytracer_tpu_torch.ops.lighttree import emitter_pmf, pick_light

    scene_n, _ = _cornell(True)
    scene_p, _ = _cornell(False)
    assert scene_n.light_tree.energy.shape[0] == scene_p.light_tree.energy.shape[0]
    lt_n, lt_p = scene_n.to("cpu").light_tree, scene_p.to("cpu").light_tree

    B = 50_000
    point = torch.tensor([0.1, 0.6, 0.2]).repeat(B, 1)
    _, u = rng.next_uniform(rng.path_key(torch.arange(B), 5, 0))
    tri_n, pmf_n = pick_light(lt_n, point, u)
    tri_p, _ = pick_light(lt_p, point, u)
    assert bool((tri_n >= 0).all())
    # pmf replay consistency on the native tree
    torch.testing.assert_close(pmf_n, emitter_pmf(lt_n, tri_n, point), rtol=1e-4, atol=1e-7)
    # same emitters, near-identical marginal distribution
    for e in scene_n.emissive_tris.tolist():
        fn = (tri_n == e).float().mean().item()
        fp = (tri_p == e).float().mean().item()
        assert abs(fn - fp) < 0.02, (e, fn, fp)
    one = point[:1]
    total = sum(float(emitter_pmf(lt_n, torch.tensor([e], dtype=torch.int32), one)[0])
                for e in scene_n.emissive_tris.tolist())
    assert abs(total - 1.0) < 1e-4


def test_native_render_parity_with_numpy_build():
    """The NEE frame on native-built structures against NumPy-built ones:
    same emitters, so the images agree in expectation."""
    from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu_torch.render.renderer import Renderer

    scene_n, cam = _cornell(True)
    scene_p, _ = _cornell(False)
    settings = RenderSettings(technique=SamplingTechnique.NEE_MIS, bounces=2, samples=1)
    a = Renderer(scene_n, cam, settings, device="cpu").render_hdr()
    b = Renderer(scene_p, cam, settings, device="cpu").render_hdr()
    assert abs(a.mean() - b.mean()).item() / max(b.mean().item(), 1e-9) < 0.05


def _png_raw(tmp_path, img):
    """The inflated IDAT stream of ``img`` saved by PIL (which picks every
    filter type on a noisy image)."""
    import struct
    import zlib

    PIL = pytest.importorskip("PIL.Image")
    p = tmp_path / "f.png"
    PIL.fromarray(img, mode="RGB").save(str(p), format="PNG")
    data, pos, idat = p.read_bytes(), 8, bytearray()
    while pos + 8 <= len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
    return np.frombuffer(zlib.decompress(bytes(idat)), np.uint8), np.asarray(PIL.open(str(p)))


def test_numpy_unfilter_matches_native(tmp_path):
    """tests/test_png.py's case on the port: the NumPy fallback through every
    filter type equals PIL's decode; here also the native unfilter, and both
    on a stream with each of the five filter types forced per row."""
    from fypraytracer_tpu_torch.utils.image import _png_unfilter_numpy, load_png

    img = np.random.default_rng(2).integers(0, 256, (24, 24, 3), dtype=np.uint8)
    raw, ref = _png_raw(tmp_path, img)
    assert np.array_equal(_png_unfilter_numpy(raw, 24, 24 * 3, 3).reshape(24, 24, 3), ref)
    assert np.array_equal(native.png_unfilter_native(raw, 24, 24 * 3, 3).reshape(24, 24, 3), ref)
    assert np.array_equal(load_png(str(tmp_path / "f.png")), ref)

    forced = np.random.default_rng(3).integers(0, 256, (10, 1 + 7 * 4), dtype=np.uint8)
    forced[:, 0] = np.arange(10) % 5
    forced = forced.reshape(-1)
    np.testing.assert_array_equal(native.png_unfilter_native(forced, 10, 28, 4),
                                  _png_unfilter_numpy(forced, 10, 28, 4))


@pytest.mark.parametrize("scene", ["cornell", "stress"])
def test_native_structures_equal_jax_binding(scene):
    """The port's native BVH and light tree equal the JAX package's
    ``build_scene_bvh_native`` / ``build_light_tree_native`` bit for bit
    (the same C++ source), and the compiled scenes agree field by field."""
    import fypraytracer_tpu.scene.procedural as jproc
    from fypraytracer_tpu.accel import native as jnative
    from test_torch_scene import _assert_scenes_equal

    if not jnative.available():
        pytest.skip("the JAX package's native library does not load")
    kw = dict(grid=2, sphere_res=(6, 8)) if scene == "stress" else {}
    jb, _ = getattr(jproc, "stress" if scene == "stress" else "cornell_box")(32, 32, **kw)
    tb, _ = getattr(tproc, "stress" if scene == "stress" else "cornell_box")(32, 32, **kw)
    js, ts = jb.compile(native=True), tb.compile(native=True)
    assert tb.last_builders == dict(bvh="native", light_tree="native")
    _assert_scenes_equal(ts, js, light_atol=0.0)

    g = ts.geometry
    p0, p1, p2 = (g.positions[g.tri_v[:, k]] for k in range(3))
    lo, hi = np.minimum(np.minimum(p0, p1), p2), np.maximum(np.maximum(p0, p1), p2)
    ranges = [(m.tri_start, m.tri_start + len(m.tri_v)) for m in tb.meshes]
    got, want = native.build_scene_bvh_native(lo, hi, ranges), jnative.build_scene_bvh_native(lo, hi, ranges)
    emission = ts.materials.emission_color * ts.materials.emission_power[:, None]
    lt_got = native.build_light_tree_native(g.positions, g.tri_v, g.tri_mat, emission, ranges)
    lt_want = jnative.build_light_tree_native(g.positions, g.tri_v, g.tri_mat, emission, ranges)
    for a, b in ((got, want), (lt_got, lt_want)):
        for f in a.__dataclass_fields__:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f)


def _tree_digest(path):
    return {n: hashlib.sha256(open(os.path.join(path, n), "rb").read()).hexdigest() for n in sorted(os.listdir(path))}


def test_native_build_writes_only_under_build_dir(tmp_path, monkeypatch):
    """A fresh build of the library (into a temporary build directory)
    compiles ``native/builders.cpp`` into a file named by the hash of source
    and flags, and leaves ``native/`` as it was: its files' bytes, and
    ``git status --porcelain native/`` empty."""
    native_dir = os.path.join(REPO, "native")
    before = _tree_digest(native_dir)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    path = native.build()
    assert os.path.dirname(path) == str(tmp_path / "_build") and os.path.basename(path).startswith("libbuilders_")
    assert os.listdir(tmp_path / "_build") == [os.path.basename(path)]
    assert native.build() == path                     # cached: no second compile
    assert _tree_digest(native_dir) == before
    if os.path.isdir(os.path.join(REPO, ".git")):
        status = subprocess.run(["git", "status", "--porcelain", "native/"], cwd=REPO, capture_output=True,
                                text=True, timeout=60)
        assert status.returncode == 0 and status.stdout == ""
    assert native.SRC == os.path.join(native_dir, "builders.cpp")


def test_compile_falls_back_to_numpy_without_gxx(monkeypatch):
    """Where the library cannot be built, ``compile(native=True)`` builds
    with NumPy, as the JAX package does, says so in ``last_builders``, and
    its scene equals ``compile(native=False)``'s."""
    from test_torch_scene import _assert_scenes_equal

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_FAILED", True)
    builder, _ = tproc.cornell_box(16, 16)
    scene = builder.compile(native=True)
    assert builder.last_builders == dict(bvh="numpy", light_tree="numpy")
    ref = tproc.cornell_box(16, 16)[0].compile()
    _assert_scenes_equal(scene, ref, light_atol=0.0)
