"""The 4-wide BVH of the CUDA walk (``accel/wide.py``) and its plain walk.

The collapse must keep the binary tree's boxes bit for bit and every
triangle in exactly one slot; the edge records must be the float32
differences the hit test computes; the plain wide walk
(``ops/traverse.py::trace_rays_wide``, the CPU rehearsal of
``csrc/wide.cuh``) must give what ``trace_rays`` gives, bit for bit in
(tri, t, u, v), on camera rays, random rays, with ``t_max``, on one
triangle, on a stress scene in Morton order and on the Cornell camera's
exact ties, and on a chain BVH deeper than the kernels' stacks hold; and
it agrees with the JAX walk as ``trace_rays`` does
(tests/test_torch_trace.py).  The kernels' own checks against the plain
walk are in test_torch_cuda.py.
"""

import ctypes
import ctypes.util
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fypraytracer_tpu.scene.procedural as jproc
from fypraytracer_tpu.ops import traverse as jtrav
from fypraytracer_tpu_torch.accel import wide as twide
from fypraytracer_tpu_torch.core.camera import generate_rays
from fypraytracer_tpu_torch.ops import kernels
from fypraytracer_tpu_torch.ops import traverse as ttrav
from fypraytracer_tpu_torch.render.megakernel import k2_lanes, morton_permuted_scene
from fypraytracer_tpu_torch.scene import procedural as tproc
from fypraytracer_tpu_torch.scene.types import scene_from_arrays
from torch_skewed_bvh import skewed_scene

N_RAYS = 4096


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(name):
    """A host scene (NumPy leaves) and its camera."""
    if name == "cornell":
        b, cam = tproc.cornell_box(32, 32)
        return b.compile(), cam
    if name == "single_triangle":
        b, cam = tproc.single_triangle()
        return b.compile(), cam
    b, cam = tproc.stress(32, 32, grid=2, sphere_res=(6, 8))
    return morton_permuted_scene(b.compile())[0], cam


SCENES = ["cornell", "single_triangle", "stress_morton"]


def _random_rays(seed=2026, n=N_RAYS):
    r = np.random.default_rng(seed)
    o = r.uniform([-0.99, 0.01, -0.99], [0.99, 1.99, 0.99], (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return torch.as_tensor(o), torch.as_tensor(d)


@pytest.mark.parametrize("name", SCENES)
def test_collapse_keeps_boxes_slots_and_stack(name):
    scene, _ = _scene(name)
    bvh, wide = scene.bvh, scene.wide
    lo, hi, ref = twide.unpack_nodes(wide.nodes)
    live = ref != twide.EMPTY
    # every child box is one of the binary tree's boxes, bit for bit
    binary = {np.concatenate([a, b]).tobytes() for a, b in zip(bvh.lo, bvh.hi)}
    for box in np.concatenate([lo, hi], axis=-1)[live]:
        assert box.tobytes() in binary
    # every inner node but the root is one child of one node; every binary
    # leaf is one child of one node
    inner = ref[live & (ref >= 0)]
    np.testing.assert_array_equal(np.sort(inner), np.arange(1, wide.nodes.shape[0]))
    leaves = np.sort(-ref[live & (ref <= -2)] - 2)
    np.testing.assert_array_equal(leaves * twide.WIDTH, np.sort(bvh.first[bvh.first >= 0]))
    # every triangle in exactly one slot, in the binary leaves' slot order
    ids = wide.tris[:, 0, 3].view(np.int32)
    np.testing.assert_array_equal(ids, bvh.prim_idx)
    np.testing.assert_array_equal(np.sort(ids[ids >= 0]), np.arange(scene.num_triangles))
    # children fill a node from the front; the walk's stack fits the kernels'
    assert not (live[:, 1:] & ~live[:, :-1]).any()
    assert 1 <= wide.depth and 0 <= wide.stack_need <= twide.MAX_STACK
    assert wide.stack_need <= (twide.WIDTH - 1) * wide.depth
    assert wide.overflow.dtype == np.int32 and wide.overflow.tolist() == [0]


@pytest.mark.parametrize("name", SCENES)
def test_triangle_records_are_float32_edges(name):
    scene, _ = _scene(name)
    wide, g = scene.wide, scene.geometry
    ids = wide.tris[:, 0, 3].view(np.int32)
    live = ids >= 0
    tv = g.tri_v[ids[live]]
    p0, p1, p2 = (g.positions[tv[:, k]] for k in range(3))
    for got, want in ((wide.tris[live, 0, :3], p0), (wide.tris[live, 1, :3], p1 - p0),
                      (wide.tris[live, 2, :3], p2 - p0)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (wide.tris[~live].view(np.int32)[:, :, :3] == 0).all()
    assert (wide.tris[:, 1:, 3] == 0).all()


def _rays(case, cam):
    """(origins, directions, t_max) of a walk case."""
    if case == "camera":
        o, d = generate_rays(cam.inv_projection, cam.inv_view, cam.width, cam.height)
        return o, d, None
    o, d = _random_rays()
    if case == "t_max":
        return o, d, torch.as_tensor(np.random.default_rng(4).uniform(0.05, 2.0, N_RAYS).astype(np.float32))
    return o, d, None


@pytest.mark.parametrize("name, case", [("cornell", "camera"), ("cornell", "random"), ("cornell", "t_max"),
                                        ("single_triangle", "camera"), ("stress_morton", "camera"),
                                        ("stress_morton", "random")])
def test_plain_wide_walk_equals_trace_rays_bitwise(name, case):
    """``("cornell", "camera")`` is the 32² Cornell camera of
    test_torch_trace.py::test_ties_go_to_the_lowest_id, whose diagonal rays
    tie exactly on the edges where walls meet."""
    scene, cam = _scene(name)
    scene = scene.to("cpu")
    o, d, tm = _rays(case, cam)
    want = ttrav.trace_rays(scene.bvh, scene.geometry, o, d, tm)
    counts = {}
    got = ttrav.trace_rays_wide(scene.wide, o, d, tm, counts=counts)
    for k in ("tri", "t", "u", "v"):
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k].view(torch.int32), want[k].view(torch.int32)), k
    assert (want["tri"] >= 0).any()
    if tm is not None:
        hit = got["tri"] >= 0
        assert (got["t"][hit] < tm[hit]).all() and (~hit).any()
    # the wide walk visits fewer nodes than the binary one
    binary = {"nodes": 0, "tris": 0}
    ttrav.trace_rays(scene.bvh, scene.geometry, o, d, tm, counts=binary)
    assert 0 < counts["nodes"] <= binary["nodes"]


def test_exact_ties_reach_the_wide_walk():
    """The 32² Cornell camera holds rays whose closest hits tie exactly
    between triangles, and the wide walk keeps the lowest id there too."""
    scene, cam = _scene("cornell")
    scene = scene.to("cpu")
    o, d = generate_rays(cam.inv_projection, cam.inv_view, 32, 32)
    got = ttrav.trace_rays_wide(scene.wide, o, d)
    # every triangle's t along every ray: a tie is a second triangle at the best t
    g = scene.geometry
    tv = g.tri_v.long()
    from fypraytracer_tpu_torch.ops.intersect import moller_trumbore

    t, _, _, hit = moller_trumbore(o[:, None], d[:, None], g.positions[tv[:, 0]], g.positions[tv[:, 1]],
                                   g.positions[tv[:, 2]])
    t = torch.where(hit, t, float("inf"))
    best = t.amin(dim=1)
    tied = ((t == best[:, None]).sum(dim=1) > 1) & torch.isfinite(best)
    assert tied.any()
    lowest = torch.where(t == best[:, None], torch.arange(t.shape[1]), t.shape[1]).amin(dim=1)
    assert torch.equal(got["tri"][tied].long(), lowest[tied])


def test_plain_wide_walk_matches_jax_walk():
    """As test_torch_trace.py::test_plain_walk_matches_jax_walk, on the
    records built from the JAX package's scene."""
    jb, _ = jproc.cornell_box(32, 32)
    js = jb.compile(native=False)
    ts = scene_from_arrays(js, "cpu")
    o, d = _random_rays()
    want = jtrav.trace_rays(js.bvh, js.geometry, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    got = ttrav.trace_rays_wide(ts.wide, o, d)
    tri, want_tri = got["tri"].numpy(), np.asarray(want["tri"])
    assert (tri == want_tri).mean() >= 0.999
    both = (tri >= 0) & (want_tri >= 0)
    assert both.mean() > 0.5
    assert np.abs(got["t"].numpy()[both] - np.asarray(want["t"])[both]).max() <= 1e-4
    same = (tri == want_tri) & (tri >= 0)
    np.testing.assert_allclose(got["u"].numpy()[same], np.asarray(want["u"])[same], atol=1e-5)
    np.testing.assert_allclose(got["v"].numpy()[same], np.asarray(want["v"])[same], atol=1e-5)


def test_scene_carries_its_wide_bvh():
    """``Scene.to`` moves the records; ``morton_permuted_scene`` rebuilds
    them with the new ids; a CUDA walk refuses a scene without them or one
    whose stack would not fit."""
    scene, _ = _scene("cornell")
    moved = scene.to("cpu")
    assert isinstance(moved.wide.nodes, torch.Tensor) and moved.wide.stack_need == scene.wide.stack_need
    np.testing.assert_array_equal(moved.wide.tris.numpy(), scene.wide.tris)
    permuted, perm = morton_permuted_scene(scene)
    inv = np.argsort(perm)
    ids, new_ids = scene.wide.tris[:, 0, 3].view(np.int32), permuted.wide.tris[:, 0, 3].view(np.int32)
    np.testing.assert_array_equal(new_ids, np.where(ids >= 0, inv[np.maximum(ids, 0)], -1))
    assert ttrav.wide_records(moved) is moved.wide
    with pytest.raises(ValueError, match="no wide BVH"):
        ttrav.wide_records(dataclasses.replace(moved, wide=None))
    deep = dataclasses.replace(moved, wide=dataclasses.replace(moved.wide, stack_need=twide.MAX_STACK + 1))
    with pytest.raises(ValueError, match="shared memory"):
        ttrav.wide_records(deep)


@pytest.mark.parametrize("run", [16, 8, 4])
def test_skewed_tree_is_walked_or_refused(run):
    """A chain BVH over the Cornell box (tests/torch_skewed_bvh.py) needs
    a deeper stack than any scene the repository builds: 79 entries for
    runs of 16 triangles, 149 for 8, 290 for 4.  The plain wide walk still
    equals ``trace_rays`` bit for bit; a CUDA walk takes the tree while its
    stacks fit in a block's shared memory (``MAX_STACK``, 227 entries) and
    refuses it with the reason otherwise."""
    scene, cam = _scene("cornell")
    scene = skewed_scene(scene, run).to("cpu")
    assert scene.wide.stack_need > 48           # deeper than the stress scene's 37
    cam_o, cam_d = generate_rays(cam.inv_projection, cam.inv_view, cam.width, cam.height)
    rnd_o, rnd_d = _random_rays(n=1024)
    o, d = torch.cat([cam_o, rnd_o]), torch.cat([cam_d, rnd_d])
    want = ttrav.trace_rays(scene.bvh, scene.geometry, o, d)
    got = ttrav.trace_rays_wide(scene.wide, o, d)
    for k in ("tri", "t", "u", "v"):
        assert torch.equal(got[k].view(torch.int32), want[k].view(torch.int32)), k
    if scene.wide.stack_need <= twide.MAX_STACK:
        assert ttrav.wide_records(scene) is scene.wide
    else:
        with pytest.raises(ValueError, match=f"needs a stack of {scene.wide.stack_need} entries.*shared memory"):
            ttrav.wide_records(scene)


@pytest.mark.parametrize("frames, lanes", [(1, 1), (2, 2), (3, 2), (4, 4), (64, 4)])
def test_k2_lanes_leave_no_lane_idle(frames, lanes):
    """K2 gives a pixel as many threads as it has frames for, up to four:
    a lane without a frame would idle through the launch."""
    assert k2_lanes(frames) == lanes


def test_wide_bvh_needs_leaves_of_four():
    scene, _ = _scene("single_triangle")
    with pytest.raises(ValueError, match="leaves of 4"):
        twide.build_wide(dataclasses.replace(scene.bvh, leaf_size=2), scene.geometry)


def test_kernel_entries_are_bound_once(monkeypatch):
    """``kernels.load`` loads a library once and binds each entry once: the
    second call returns the same function with its argtypes untouched."""
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to load")
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "build", lambda name: libc)
    fn = kernels.load("libc", "abs", [ctypes.c_int])
    assert kernels.load("libc", "abs", [ctypes.c_double]) is fn
    assert tuple(fn.argtypes) == (ctypes.c_int,) and fn(-3) == 3
