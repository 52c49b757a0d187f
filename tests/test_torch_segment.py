"""The segment test of the wide walk, and the tiles of K3 and K5.

``ops/traverse.py::segment_visible_wide`` walks the 4-wide BVH in the
order of ``csrc/wide.cuh::segment_visible_wide1`` (K5's reconnection
visibility); it must give ``segment_visible``'s boolean bit for bit on the
Cornell box, on a stress scene in Morton order and on a chain BVH
(tests/torch_skewed_bvh.py), also for segments whose ends sit exactly at
dist ± tol, and the JAX wavefront's test |t_closest − dist| ≤ tol
(fypraytracer_tpu/render/restir_gi.py:336-343) on the same segments
through the JAX walk.  K2-K6 refuse a tree whose stacks would not fit
in one of their blocks; the split launch (``restir_common.tile_launch``)
puts every pixel in its tile at its lane, and K4's blocks of 128 read their
spatial neighbours where its plain version does.  The kernels' own checks
are in test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fypraytracer_tpu.scene.procedural as jproc
from fypraytracer_tpu.ops import hit as jhit
from fypraytracer_tpu.ops import traverse as jtrav
from fypraytracer_tpu_torch.accel.wide import MAX_STACK
from fypraytracer_tpu_torch.ops import traverse as ttrav
from fypraytracer_tpu_torch.render import restir_common as rc
from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
from fypraytracer_tpu_torch.scene import procedural as tproc
from fypraytracer_tpu_torch.scene.types import scene_from_arrays
from torch_skewed_bvh import skewed_scene

N = 2048


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(name):
    """A port scene on the CPU."""
    if name == "stress_morton":
        b, _ = tproc.stress(32, 32, grid=2, sphere_res=(6, 8))
        return morton_permuted_scene(b.compile())[0].to("cpu")
    b, _ = tproc.cornell_box(32, 32)
    scene = b.compile()
    if name.startswith("skewed"):
        scene = skewed_scene(scene, int(name[len("skewed"):]))
    return scene.to("cpu")


def _segments(scene, seed=2026, n=N):
    """Rays from random points in the box along random unit directions, and
    segment lengths around each ray's closest hit: at it, within and beyond
    the tolerance on both sides, and half way (the segment ends in the air,
    or a hit blocks it)."""
    r = np.random.default_rng(seed)
    o = torch.as_tensor(r.uniform([-0.99, 0.01, -0.99], [0.99, 1.99, 0.99], (n, 3)).astype(np.float32))
    d = torch.as_tensor(r.normal(size=(n, 3)).astype(np.float32))
    d = d / torch.sqrt((d * d).sum(1, keepdim=True))
    t = ttrav.trace_rays(scene.bvh, scene.geometry, o, d)["t"]
    t = torch.where(t > 0, t, 1.0)
    scale = torch.as_tensor(r.choice([1.0, 1.0005, 0.9995, 1.002, 0.998, 0.5, 2.0], n).astype(np.float32))
    return o, d.contiguous(), (t * scale).contiguous()


def _at_tolerance(scene, o, d):
    """Segments whose far end sits exactly at dist − tol or dist + tol from
    the ray's closest hit, as the kernels round them, and the lengths one
    float step longer and shorter: (origins, directions, dist, kind, step),
    kind 0 where t == dist − tol, 1 where t == dist + tol, step 0 for the
    exact length."""
    t = ttrav.trace_rays(scene.bvh, scene.geometry, o, d)["t"]
    hit = t > 0
    o, d, t = o[hit], d[hit], t[hit]
    inf = torch.full_like(t, float("inf"))
    out = []
    for kind, guess in ((0, t / (1.0 - 1e-3)), (1, t / (1.0 + 1e-3))):
        cand = torch.nextafter(torch.nextafter(guess, -inf), -inf)
        dist, found = cand.clone(), torch.zeros_like(hit[hit])
        for _ in range(5):                      # the float lengths around the guess
            tol = torch.clamp_min(cand * 1e-3, 1e-4)
            take = ((cand - tol if kind == 0 else cand + tol) == t) & ~found
            dist, found = torch.where(take, cand, dist), found | take
            cand = torch.nextafter(cand, inf)
        for step, ds in ((0, dist), (1, torch.nextafter(dist, inf)), (-1, torch.nextafter(dist, -inf))):
            n = int(found.sum())
            out.append((o[found], d[found], ds[found], torch.full((n,), kind), torch.full((n,), step)))
    return tuple(torch.cat(x) for x in zip(*out))


@pytest.mark.parametrize("name", ["cornell", "stress_morton", "skewed8", "skewed16"])
def test_segment_visible_wide_equals_threaded(name):
    scene = _scene(name)
    o, d, dist = _segments(scene)
    want = ttrav.segment_visible(scene.bvh, scene.geometry, o, d, dist)
    got = ttrav.segment_visible_wide(scene.wide, o, d, dist)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert 0.1 < want.float().mean().item() < 0.9          # both answers are exercised
    # the CPU wrapper of the kernel is its plain twin
    assert torch.equal(ttrav.trace_segments(scene, o, d, dist), got)


@pytest.mark.parametrize("name", ["cornell", "skewed8"])
def test_segment_ends_at_the_tolerance(name):
    """A hit exactly at dist − tol or dist + tol ends the segment (visible);
    one float step further the segment is blocked (kind 0, the hit falls
    below dist − tol) or ends in the air (kind 1).  Both walks agree on
    every such segment."""
    scene = _scene(name)
    o, d, _ = _segments(scene, seed=7)
    o, d, dist, kind, step = _at_tolerance(scene, o, d)
    want = ttrav.segment_visible(scene.bvh, scene.geometry, o, d, dist)
    got = ttrav.segment_visible_wide(scene.wide, o, d, dist)
    assert torch.equal(got, want)
    for k, blocked_step in ((0, 1), (1, -1)):
        exact = (kind == k) & (step == 0)
        assert exact.sum() > 100
        assert got[exact].all()                                  # a hit exactly on a bound ends the segment
        assert not got[(kind == k) & (step == blocked_step)].all()  # one float step past it, it may not


def test_segment_visible_wide_matches_jax_wavefront_test():
    """The JAX wavefront's visibility of a reconnection: the closest hit
    through the JAX walk, t from ``hit_payload``, visible where
    |t − dist| ≤ max(1e-4, 1e-3·dist).  The two tests round the bounds
    differently, so a segment whose hit lies within a float step of a
    bound may be answered either way."""
    jb, _ = jproc.cornell_box(32, 32)
    js = jb.compile(native=False)
    scene = scene_from_arrays(js, "cpu")
    o, d, dist = _segments(scene, seed=11)
    got = ttrav.segment_visible_wide(scene.wide, o, d, dist).numpy()
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    tri = jtrav.trace_rays(js.bvh, js.geometry, jo, jd)["tri"]
    t = np.asarray(jhit.hit_payload(js.geometry, jo, jd, tri)["t"])
    dn = dist.numpy()
    tol = np.maximum(np.float32(1e-4), dn * np.float32(1e-3))
    want = np.abs(t - dn) <= tol
    assert 0.1 < want.mean() < 0.9
    assert (got == want).mean() >= 0.999


def test_k3_and_k5_refuse_an_oversize_stack():
    """A block of 128 threads of K3-K6 holds 128 stacks and the tile's
    sums (8 bytes) in its 232,448 bytes of shared memory: 226 entries a
    stack; a block of 512, 56.  A chain BVH needing 290 is refused with the
    reason by the wrappers' own check, and so would one needing 227, which
    the one-thread walk of K1 takes; one needing 149 is handed to blocks of
    128, and refused for blocks of 512."""
    assert (rc.stack_fits(128), rc.stack_fits(512)) == (226, 56)
    deep = _scene("skewed4")
    assert deep.wide.stack_need > MAX_STACK
    for name in ("restir_di_k3", "restir_gi_mono", "restir_di_k4", "restir_gi_k1"):
        with pytest.raises(ValueError, match=rf"{name}: the wide BVH needs a stack of {deep.wide.stack_need} "
                                             r"entries a thread, and a block of 128 threads holds 226"):
            rc.tile_walk_records(name, deep, 128)
    at_k2s = dataclasses.replace(deep, wide=dataclasses.replace(deep.wide, stack_need=MAX_STACK))
    assert ttrav.wide_records(at_k2s) is at_k2s.wide
    with pytest.raises(ValueError, match="holds 226"):
        rc.tile_walk_records("restir_gi_mono", at_k2s, 128)
    ok = _scene("skewed8")
    assert rc.tile_walk_records("restir_gi_mono", ok, 128) is ok.wide
    with pytest.raises(ValueError, match="a block of 512 threads holds 56"):
        rc.tile_walk_records("restir_di_k3", ok, 512)


def test_k2_refuses_an_oversize_stack():
    """A block of 128 threads of K2 holds 128 stacks and each thread's kept
    primary surface and view (csrc/megakernel.cu::KeptSurf, 14 floats) in
    its 232,448 bytes of shared memory: 220 entries a stack.  A tree
    needing more is refused with the reason before any launch; the chain
    BVH needing 149, and one needing 220, are handed over."""
    from fypraytracer_tpu_torch.render import megakernel as mk

    assert mk.K2_MAX_STACK == 220
    deep = _scene("skewed4")
    for need in (221, MAX_STACK, deep.wide.stack_need):
        over = dataclasses.replace(deep, wide=dataclasses.replace(deep.wide, stack_need=need))
        with pytest.raises(ValueError, match=rf"megakernel: the wide BVH needs a stack of {need} entries a thread, "
                                             r"and a block of 128 threads holds 220 beside its kept surfaces"):
            mk.k2_walk_records(over)
    at = dataclasses.replace(deep, wide=dataclasses.replace(deep.wide, stack_need=220))
    assert mk.k2_walk_records(at) is at.wide
    ok = _scene("skewed8")
    assert mk.k2_walk_records(ok) is ok.wide


@pytest.mark.parametrize("num_pixels, stack_need, clustered", [
    (128 * 128, 37, True),          # stress 128²: 32 tiles, a quarter of the card as one block each
    (256 * 256, 21, False),         # Cornell 256²: 128 tiles
    (1920 * 1088, 21, False),       # 4,080 tiles
    (32 * 32, 21, True), (40 * 16, 21, True),
    (256 * 256, 149, True),         # a chain BVH's stacks fit blocks of 128 only
    (132 * 512, 21, False), (66 * 512, 21, True), (67 * 512, 21, False)])
def test_tile_clustered_splits_tiles_where_they_leave_the_card_idle(num_pixels, stack_need, clustered):
    """K3 and K5 split each tile over a cluster where the frame's tiles, one
    block each, would keep at most half of an H100's 132 multiprocessors
    busy, or where a block of a tile's threads cannot hold the stacks."""
    assert rc.tile_clustered(num_pixels, 132, stack_need) is clustered


@pytest.mark.parametrize("clustered", [True, False], ids=["split", "one block"])
@pytest.mark.parametrize("width, height, C", [(32, 32, 512), (16, 16, 256), (40, 16, 128), (1920, 1088, 512),
                                              (48, 16, 256)])
def test_tile_launch_puts_each_pixel_in_its_tile(width, height, C, clustered):
    """The launch of K3 and K5: blocks of 128 threads, C / 128 blocks a
    cluster, or one block of C threads a tile; block b's thread i is pixel
    b·threads + i, and the kernels' tile pix // C and lane pix − tile·C are
    the cluster's index and the thread's place in it, so tile·C + lane is
    the pixel, as in the one-block tile of the JAX megakernels."""
    B = width * height
    lay = rc.tile_launch(B, clustered)
    threads = 128 if clustered else C
    assert lay == dict(C=C, threads=threads, cluster=C // threads, grid=B // threads, clustered=clustered)
    assert lay["grid"] % lay["cluster"] == 0
    block, thread = np.divmod(np.arange(B), lay["threads"])
    pix = block * lay["threads"] + thread
    tile, lane = pix // C, pix - (pix // C) * C
    np.testing.assert_array_equal(tile, block // lay["cluster"])
    np.testing.assert_array_equal(lane, (block % lay["cluster"]) * lay["threads"] + thread)
    np.testing.assert_array_equal(tile * C + lane, np.arange(B))


@pytest.mark.parametrize("name, threads, fits", [("restir_di_k4", 128, 226), ("restir_gi_k1", 128, 226),
                                                 ("restir_gi_k1", 512, 56), ("restir_gi_k2", 128, 226),
                                                 ("diff_megakernel", 128, 226)])
def test_k4_and_k6_stack_limits(name, threads, fits):
    """K4, K6, K7 and K8 hold the stacks K3 and K5 hold: 226 entries a
    thread in a block of 128 (the only block of K4, K7 and K8), 56 in a
    block of 512 (K6's tile one block).  A tree that needs exactly that
    many is handed over; one that needs one more is refused with the
    reason, naming the kernel, before anything launches."""
    ok = _scene("skewed8")
    at = dataclasses.replace(ok, wide=dataclasses.replace(ok.wide, stack_need=fits))
    assert rc.tile_walk_records(name, at, threads) is at.wide
    over = dataclasses.replace(ok, wide=dataclasses.replace(ok.wide, stack_need=fits + 1))
    with pytest.raises(ValueError, match=rf"{name}: the wide BVH needs a stack of {fits + 1} entries a thread, "
                                         rf"and a block of {threads} threads holds {fits}"):
        rc.tile_walk_records(name, over, threads)


def _k4_reads(B, w, C, threads, offsets):
    """K4's spatial reads as the kernel computes them for a launch of blocks
    of ``threads``: block b's thread i is pixel b·threads + i, its tile
    pix / C and lane pix − tile·C; the neighbour at (dx, dy) is read at
    clamp(tile·C + dy·w + dx, 0, B − C) + lane, and counts only where the
    clamp left it.  Returns the pixels in launch order, and per offset the
    read index and whether it counts."""
    block, thread = np.divmod(np.arange(B), threads)
    pix = block * threads + thread
    tile = pix // C
    lane = pix - tile * C
    reads = []
    for dx, dy in offsets:
        s = tile * C + dy * w + dx
        sc = np.clip(s, 0, B - C)
        reads.append((sc + lane, s == sc))
    return pix, reads


@pytest.mark.parametrize("kernel, stream", [("K4", 7002), ("K7", 8002)])
@pytest.mark.parametrize("width, height, C", [(32, 32, 512), (16, 16, 256), (40, 16, 128), (48, 16, 256),
                                              (1920, 1088, 512)])
def test_k4_blocks_of_128_read_the_plain_versions_neighbours(width, height, C, kernel, stream):
    """K4 and K7 in blocks of 128 (no cluster: neither sums anything over
    a tile) cover every pixel once, each block within one tile, and read
    each frame-shared neighbour offset (their own stream of offsets) at the
    index their plain versions ``restir_di_k4_plain`` and
    ``restir_gi_k2_plain`` read (``stage[:, q]`` with q = clamp(tile·C +
    dy·W + dx, 0, B − C) + pix mod C), with the same unclamped test, as a
    launch of one block of C threads a tile does: at tiles of 512, 256 and
    128 pixels."""
    B = width * height
    assert rc.pick_ray_lanes(B) == C
    lay = rc.tile_launch(B, True)
    assert (lay["threads"], lay["grid"] * lay["threads"]) == (128, B)
    offsets = rc.spatial_offsets(3, 5, 30.0, stream=stream) + [(0, 0), (-width, 0), (0, height)]
    split_pix, split = _k4_reads(B, width, C, 128, offsets)
    block_pix, block = _k4_reads(B, width, C, C, offsets)
    np.testing.assert_array_equal(split_pix, np.arange(B))
    np.testing.assert_array_equal(block_pix, np.arange(B))
    first_tile = (np.arange(0, B, 128) // C)
    np.testing.assert_array_equal((np.arange(0, B, 128) + 127) // C, first_tile)     # a block lies in one tile
    pix = torch.arange(B)
    for (q, counts), (q1, counts1), (dx, dy) in zip(split, block, offsets):
        s = (pix // C) * C + dy * width + dx                     # restir_di_k4_plain's index arithmetic
        sc = torch.clamp(s, 0, B - C)
        np.testing.assert_array_equal(q, (sc + pix % C).numpy())
        np.testing.assert_array_equal(counts, (s == sc).numpy())
        np.testing.assert_array_equal(q, q1)
        np.testing.assert_array_equal(counts, counts1)
        assert q.min() >= 0 and q.max() < B
