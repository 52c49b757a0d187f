"""Tracing and light-tree ops of the port against the JAX package.

The plain BVH walk is held against JAX's ``trace_rays`` and against the TPU
kernel itself, ``trace_rays_pallas`` in interpret mode (as
tests/test_bvh.py:149-173 runs it): triangle ids equal on >= 99.9% of 4,096
random rays, |Δt| <= 1e-4 where both hit.  Ids may differ only on exact
ties and edge grazes.  ``hit_payload`` agrees to rtol 1e-5; the light-tree
descent is checked on a scene of 20 emissive triangles (descent depth >= 4):
ids equal on >= 99.9%, pmf to rtol 1e-5.  A pmf is a product of ~5 clamped
ratios of importances whose sin terms (sqrt(1 - cos²)) are ill-conditioned
near cos = 1; where float32 cannot hold 1e-5 the port must instead be about
as close to the float64 evaluation of the JAX code as JAX's float32 result
is (within a factor 4), for at most 0.5% of the elements.  The CUDA
kernel's own check against the plain walk is in test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fypraytracer_tpu.scene.procedural as jproc
from fypraytracer_tpu.ops import hit as jhit
from fypraytracer_tpu.ops import lighttree as jlt
from fypraytracer_tpu.ops import traverse as jtrav
from fypraytracer_tpu.ops.pallas_dense import trace_rays_pallas
from fypraytracer_tpu_torch.core.camera import generate_rays
from fypraytracer_tpu_torch.ops import hit as thit
from fypraytracer_tpu_torch.ops import kernels
from fypraytracer_tpu_torch.ops import lighttree as tlt
from fypraytracer_tpu_torch.ops import traverse as ttrav
from fypraytracer_tpu_torch.scene import procedural as tproc
from fypraytracer_tpu_torch.scene.types import scene_from_arrays

N_RAYS = 4096


@pytest.fixture(scope="module")
def cornell():
    jb, cam = jproc.cornell_box(32, 32)
    js = jb.compile(native=False)
    return js, scene_from_arrays(js, "cpu"), cam


@pytest.fixture(scope="module")
def rays():
    r = np.random.default_rng(2026)
    o = r.uniform([-0.99, 0.01, -0.99], [0.99, 1.99, 0.99], (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    return o, d


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small batches of many tiny ops: threads only add sync overhead, and
    under several test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_geo(js):
    return jax.tree_util.tree_map(jnp.asarray, js.geometry)


def _check_trace(got, want_tri, want_t):
    tri, t = got["tri"].numpy(), got["t"].numpy()
    want_tri, want_t = np.asarray(want_tri), np.asarray(want_t)
    assert (tri == want_tri).mean() >= 0.999
    both = (tri >= 0) & (want_tri >= 0)
    assert both.mean() > 0.5      # the box is open at the front: rays escape
    assert np.abs(t[both] - want_t[both]).max() <= 1e-4
    assert ((t < 0) == (tri < 0)).all()


def test_plain_walk_matches_jax_walk(cornell, rays):
    js, ts, _ = cornell
    o, d = rays
    want = jtrav.trace_rays(js.bvh, js.geometry, jnp.asarray(o), jnp.asarray(d))
    got = ttrav.trace_rays(ts.bvh, ts.geometry, torch.as_tensor(o), torch.as_tensor(d))
    _check_trace(got, want["tri"], want["t"])
    same = got["tri"].numpy() == np.asarray(want["tri"])
    hit = same & (got["tri"].numpy() >= 0)
    np.testing.assert_allclose(got["u"].numpy()[hit], np.asarray(want["u"])[hit], atol=1e-5)
    np.testing.assert_allclose(got["v"].numpy()[hit], np.asarray(want["v"])[hit], atol=1e-5)


def test_plain_walk_matches_tpu_kernel(cornell, rays):
    js, ts, _ = cornell
    o, d = rays
    want = trace_rays_pallas(_jax_geo(js), jnp.asarray(o), jnp.asarray(d), interpret=True)
    got = ttrav.trace_rays(ts.bvh, ts.geometry, torch.as_tensor(o), torch.as_tensor(d))
    _check_trace(got, want["tri"], want["t"])


def test_plain_walk_t_max_matches_jax(cornell, rays):
    js, ts, _ = cornell
    o, d = rays
    tmax = np.random.default_rng(4).uniform(0.05, 2.0, N_RAYS).astype(np.float32)
    want = jtrav.trace_rays(js.bvh, js.geometry, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    got = ttrav.trace_rays(ts.bvh, ts.geometry, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax))
    _check_trace(got, want["tri"], want["t"])
    hit = got["tri"].numpy() >= 0
    assert (got["t"].numpy()[hit] < tmax[hit]).all()


def test_ties_go_to_the_lowest_id(cornell):
    """Camera rays along the image diagonals pass exactly through the box's
    wall/ceiling edges: the port keeps the lowest id of the tied triangles
    (the TPU kernel's rule), the JAX walk the first in walk order."""
    js, ts, cam = cornell
    o, d = generate_rays(cam.inv_projection, cam.inv_view, 32, 32)
    got = ttrav.trace_rays(ts.bvh, ts.geometry, o, d)
    want = jtrav.trace_rays(js.bvh, js.geometry, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    differ = got["tri"].numpy() != np.asarray(want["tri"])
    assert 0 < differ.sum() <= 32
    np.testing.assert_array_equal(got["t"].numpy()[differ], np.asarray(want["t"])[differ])
    assert (got["tri"].numpy()[differ] < np.asarray(want["tri"])[differ]).all()


def test_trace_closest_on_cpu_is_the_plain_walk(cornell, rays):
    _, ts, _ = cornell
    o, d = (torch.as_tensor(x) for x in rays)
    before = ttrav.trace_closest.launches
    a = ttrav.trace_closest(ts, o, d)
    b = ttrav.trace_rays(ts.bvh, ts.geometry, o, d)
    assert ttrav.trace_closest.launches == before
    for k in ("tri", "t", "u", "v"):
        assert torch.equal(a[k], b[k])
    tri = ttrav.pick_tracer(ts)(o, d)
    assert torch.equal(tri, b["tri"])


def test_walk_counts_leave_the_result_alone(cornell, rays):
    """``counts`` adds the walk's box and triangle tests and changes nothing
    else; the counts of a batch are those of its halves added."""
    _, ts, _ = cornell
    o, d = (torch.as_tensor(x) for x in rays)
    counts = {"nodes": 0, "tris": 0}
    got = ttrav.trace_rays(ts.bvh, ts.geometry, o, d, counts=counts)
    want = ttrav.trace_rays(ts.bvh, ts.geometry, o, d)
    for k in ("tri", "t", "u", "v"):
        assert torch.equal(got[k], want[k])
    halves = {"nodes": 0, "tris": 0}
    for sl in (slice(0, N_RAYS // 2), slice(N_RAYS // 2, N_RAYS)):
        ttrav.trace_rays(ts.bvh, ts.geometry, o[sl], d[sl], counts=halves)
    assert counts["nodes"] == halves["nodes"] >= N_RAYS
    assert 0 < int(counts["tris"]) == int(halves["tris"]) <= counts["nodes"] * ts.bvh.leaf_size


def test_hit_payload_matches_jax(cornell, rays):
    js, ts, _ = cornell
    o, d = rays
    tri = ttrav.trace_rays(ts.bvh, ts.geometry, torch.as_tensor(o), torch.as_tensor(d))["tri"]
    got = thit.hit_payload(ts.geometry, torch.as_tensor(o), torch.as_tensor(d), tri)
    want = jhit.hit_payload(_jax_geo(js), jnp.asarray(o), jnp.asarray(d), jnp.asarray(tri.numpy()))
    for k in ("t", "position", "normal", "uv"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("tri", "mat"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_kernel_inputs_are_checked():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        kernels.check_inputs("trace_closest", floats=(x,))


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "find_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build("trace")
    assert not list(tmp_path.glob("*.so"))


# ---- light tree ---------------------------------------------------------------


def _many_lights(proc):
    """A floor under 10 emissive quads of random pose and power (20 emitters)."""
    b = proc.SceneBuilder()
    white = b.add_material(albedo=(0.7, 0.7, 0.7))
    b.add_mesh(*proc.quad(4.0, 4.0), material=white)
    r = np.random.default_rng(5)
    for _ in range(10):
        m = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=tuple(r.uniform(0.3, 1.0, 3)),
                           emission_power=float(r.uniform(1.0, 8.0)))
        b.add_mesh(*proc.quad(0.3, 0.3), material=m,
                   position=tuple(r.uniform([-1.5, 1.0, -1.5], [1.5, 2.5, 1.5])),
                   rotation=tuple(r.uniform(-180.0, 180.0, 3)))
    return b


@pytest.fixture(scope="module")
def lights():
    js = _many_lights(jproc).compile(native=False)
    ts = _many_lights(tproc).compile()
    r = np.random.default_rng(9)
    point = r.uniform([-2.0, 0.0, -2.0], [2.0, 3.0, 2.0], (N_RAYS, 3)).astype(np.float32)
    rand = r.uniform(size=N_RAYS).astype(np.float32)
    jtree = jax.tree_util.tree_map(jnp.asarray, js.light_tree)
    return js, ts, jtree, scene_from_arrays(js, "cpu").light_tree, point, rand


def _tree64(lt):
    """The JAX tree with float64 leaves: the JAX ops run on it in NumPy."""
    return dataclasses.replace(lt, **{f: np.asarray(getattr(lt, f), np.float64) for f in (
        "energy", "axis", "theta_o", "theta_e", "box_lo", "box_hi")})


def _check_close(got, want, ref64):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    close = np.abs(g - w) <= 1e-6 + 1e-5 * np.abs(w)
    as_accurate = np.abs(g - ref64) <= 4.0 * np.abs(w - ref64) + 1e-6
    assert (close | as_accurate).all(), np.abs(g - w).max()
    assert close.mean() >= 0.995


def test_many_light_tree_builder_matches(lights):
    js, ts, _, _, _, _ = lights
    assert len(ts.emissive_tris) == 20
    assert ts.light_tree.max_depth == js.light_tree.max_depth >= 5   # descent depth >= 4
    for name in ("energy", "axis", "theta_o", "theta_e", "box_lo", "box_hi"):
        np.testing.assert_allclose(getattr(ts.light_tree, name), np.asarray(getattr(js.light_tree, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    for name in ("left", "right", "tri", "parent", "leaf_of_tri"):
        np.testing.assert_array_equal(getattr(ts.light_tree, name), np.asarray(getattr(js.light_tree, name)))


def test_cluster_importance_matches_jax(lights):
    js, _, jtree, ttree, point, _ = lights
    node = np.random.default_rng(1).integers(0, ttree.energy.shape[0], N_RAYS).astype(np.int32)
    want = jlt.cluster_importance(jtree, jnp.asarray(node), jnp.asarray(point))
    got = tlt.cluster_importance(ttree, torch.as_tensor(node), torch.as_tensor(point))
    ref = jlt.cluster_importance(_tree64(js.light_tree), node, point.astype(np.float64))
    _check_close(got.numpy(), want, ref)


def test_pick_light_matches_jax(lights):
    js, _, jtree, ttree, point, rand = lights
    jtri, jpmf = jlt.pick_light(jtree, jnp.asarray(point), jnp.asarray(rand))
    ttri, tpmf = tlt.pick_light(ttree, torch.as_tensor(point), torch.as_tensor(rand))
    _, rpmf = jlt.pick_light(_tree64(js.light_tree), point.astype(np.float64), rand.astype(np.float64))
    same = ttri.numpy() == np.asarray(jtri)
    assert same.mean() >= 0.999
    assert (ttri.numpy() >= 0).all() and len(np.unique(ttri.numpy())) == 20
    _check_close(tpmf.numpy()[same], np.asarray(jpmf)[same], rpmf[same])


def test_emitter_pmf_matches_jax_and_inverts_pick(lights):
    js, _, jtree, ttree, point, rand = lights
    tri = np.asarray(js.emissive_tris)[np.random.default_rng(3).integers(0, 20, N_RAYS)]
    tri[:64] = 0                              # the floor: not in the tree, pmf 0
    tri[64:128] = -1                          # a miss
    want = jlt.emitter_pmf(jtree, jnp.asarray(tri), jnp.asarray(point))
    got = tlt.emitter_pmf(ttree, torch.as_tensor(tri), torch.as_tensor(point))
    ref = jlt.emitter_pmf(_tree64(js.light_tree), tri, point.astype(np.float64))
    _check_close(got.numpy(), want, ref)
    assert (got.numpy()[:128] == 0).all()
    # the pmf replayed for the picked emitter is the pick's own pmf
    ptri, ppmf = tlt.pick_light(ttree, torch.as_tensor(point), torch.as_tensor(rand))
    np.testing.assert_allclose(tlt.emitter_pmf(ttree, ptri, torch.as_tensor(point)).numpy(),
                               ppmf.numpy(), rtol=1e-5)

