"""The port's multi-device layer (``parallel/``) on the CPU: ranks in processes
of their own, joined by gloo over a ``FileStore`` (tests/torch_parallel_worker.py),
against the port's one-device paths and the JAX package's sharded functions.

Each world size runs its ranks once (module fixtures); the tests read their
results.  Gates:
  * ``sharded_render`` and ``sharded_megakernel_render`` (plain slabs): bit
    for bit the one-device frame;
  * sharded ReSTIR DI (2 and 4 ranks, radius 64 // n - 1; a moving camera
    at 4 ranks, radius 12) and GI (4 ranks, 2 frames) at 64²: bit for bit
    the port's one-device wavefront (every pixel's rays, keys and gathers
    are one device's), and against JAX ``make_restir_di/gi_sharded`` on as
    many virtual CPU devices under tests/test_restir_shard.py:173-178's
    gates (median |Δ| < 1e-6, < 3% of pixels off by 1e-3, mean within 1%,
    2% for GI) on frame 1 (the port traces Möller–Trumbore, JAX
    Baldwin–Weber, and from frame 2 on a static camera's reprojection onto
    pixel corners amplifies their last-ulp differences, ROADMAP queue 3);
  * the NEE mesh train step (16², 2 ranks): the loss within 1 ulp and the
    parameters within 1e-6 relative of the one-device step (the gradient
    is two slab sums added, not one); its first step against JAX
    ``make_train_step`` on one device, the loss within 1e-4 relative and
    each update within 1% of its largest entry (the tracers part at grazing
    pixels); JAX's on 2 devices (tests/test_multihost.py:61) takes each
    shard's own gradient twice, a fault of the reference pinned here;
  * the DI train step's gradient summed over ranks against the one-device
    DI loss's autograd gradient, within 1e-5 relative: the halo exchange's
    backward carries each halo's gradient home;
  * ``steps_per_call=2``: the micro-steps' losses and parameters bit for bit
    two calls of one step.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from fypraytracer_tpu_torch.ops.traverse import pick_tracer
from fypraytracer_tpu_torch.parallel import distributed, shard
from fypraytracer_tpu_torch.render import restir_di, restir_gi
from fypraytracer_tpu_torch.render.megakernel import megakernel_plain
from fypraytracer_tpu_torch.render.renderer import frame_hdr
from fypraytracer_tpu_torch.scene.types import with_materials

CASES2 = [("render", "render", {}), ("megakernel", "megakernel", {}), ("di", "di", dict(radius=31)),
          ("nee_train", "nee_train", {}), ("di_grad", "di_grad", {}), ("steps_per_call", "steps_per_call", {}),
          ("mesh", "mesh", {})]
CASES4 = [("di", "di", dict(radius=15)), ("di_move", "di", dict(radius=12, move=True)),
          ("gi", "gi", dict(radius=15)), ("di_grad", "di_grad", {}), ("mesh", "mesh", {})]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return W.run(2, tmp_path_factory.mktemp("world2"), CASES2)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return W.run(4, tmp_path_factory.mktemp("world4"), CASES4)


def _ranks(request, world):
    return request.getfixturevalue(f"ranks{world}")


def _gates(got, ref, mean_tol=0.01):
    """tests/test_restir_shard.py:173-178."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    assert float(np.median(diff)) < 1e-6
    assert (diff.max(axis=-1) > 1e-3).mean() < 0.03, diff.max()
    assert abs(got.mean() - ref.mean()) / max(ref.mean(), 1e-9) < mean_tol


@functools.lru_cache(maxsize=None)
def _one_device_restir(kind, radius, frames, move, size=W.RESTIR):
    """The port's one-device wavefront over the same frames (CPU), each
    frame's HDR, (frames, H*W, 3)."""
    scene, cam = W.restir_scene(size)
    scene = scene.to("cpu")
    settings = (W.di_settings if kind == "di" else W.gi_settings)(radius)
    module = restir_di if kind == "di" else restir_gi
    render = restir_di.render_restir_di if kind == "di" else restir_gi.render_restir_gi
    state, out, pix = module.init_state(size * size), [], torch.arange(size * size)
    for f, (ip, iv, ppv) in enumerate(W.camera_path(cam, frames, move)):
        o, d = shard.slab_rays(ip, iv, size, size, pix)
        hdr, state = render(scene, pick_tracer(scene), o, d, pix, f + 1, settings, state, size, size,
                            torch.as_tensor(ppv))
        out.append(hdr)
    return torch.stack(out)


@functools.lru_cache(maxsize=None)
def _jax_restir_first_frame(kind, n_devices, radius, move, size=W.RESTIR):
    """Frame 1 of JAX ``make_restir_di/gi_sharded`` on ``n_devices``
    virtual CPU devices, the port's camera."""
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.config import RenderSettings as JSettings
    from fypraytracer_tpu.config import SamplingTechnique as JTech
    from fypraytracer_tpu.parallel.restir_shard import make_restir_di_sharded, make_restir_gi_sharded
    from fypraytracer_tpu.parallel.shard import make_pixel_mesh, replicate_scene
    from fypraytracer_tpu.scene.procedural import cornell_box

    builder, _ = cornell_box(width=size, height=size, with_spheres=False)
    if kind == "di":
        settings = JSettings(technique=JTech.RESTIR_DI, light_candidates=4, spatial_neighbors=3,
                             spatial_radius=radius)
        make = make_restir_di_sharded
    else:
        settings = JSettings(technique=JTech.RESTIR_GI, bounces=2, spatial_neighbors=3, spatial_radius=radius)
        make = make_restir_gi_sharded
    mesh = make_pixel_mesh(jax.devices()[:n_devices])
    step, init_state = make(replicate_scene(builder.compile(), mesh), mesh, size, size, settings)
    ip, iv, ppv = W.camera_path(W.restir_scene(size)[1], 1, move)[0]
    hdr, _ = step(jnp.asarray(ip), jnp.asarray(iv), jnp.asarray(ppv), jnp.uint32(1), init_state())
    return np.asarray(hdr)


def test_sharded_render_equals_one_device(ranks2):
    scene, cam = W.restir_scene(32)
    ref = frame_hdr(scene.to("cpu"), cam, 1, W.COSINE).reshape(-1, 3)
    assert ranks2["render"].shape == ref.shape
    assert torch.equal(ranks2["render"], ref)


def test_sharded_megakernel_slabs_equal_one_launch(ranks2):
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    builder, cam = cornell_box(16, 16)
    ref = megakernel_plain(builder.compile().to("cpu"), cam, 1, 2, W.NEE_TRAIN)
    assert float(ref.mean()) > 0.01
    assert torch.equal(ranks2["megakernel"], ref)


RESTIR_CASES = [(2, "di", "di", 31, 3, False), (4, "di", "di", 15, 3, False), (4, "di_move", "di", 12, 3, True),
                (4, "gi", "gi", 15, 2, False)]
RESTIR_IDS = ["di-2", "di-4", "di-move-4", "gi-4"]


@pytest.mark.parametrize("world, name, kind, radius, frames, move", RESTIR_CASES, ids=RESTIR_IDS)
def test_sharded_restir_equals_one_device(request, world, name, kind, radius, frames, move):
    got = _ranks(request, world)[name]
    ref = _one_device_restir(kind, radius, frames, move)
    assert got.shape == ref.shape and float(ref.mean()) > 0.01
    for f in range(frames):
        off = (got[f] != ref[f]).any(-1).nonzero().flatten()
        assert off.numel() == 0, f"frame {f + 1}: {off.numel()} pixels differ, first {off[:8].tolist()}"


@pytest.mark.parametrize("world, name, kind, radius, frames, move", RESTIR_CASES, ids=RESTIR_IDS)
def test_sharded_restir_matches_jax(request, world, name, kind, radius, frames, move):
    """Frame 1, whose reservoirs start empty: over later frames a static
    camera reprojects each hit onto its pixel's corner and the two
    tracers' last-ulp hit positions decide which pixels keep their
    history, so the port and JAX part at a growing share of pixels (DI at
    64², radius 31: 0.8%, 9.4%, 17% after 1, 2, 3 frames, the port's
    one-device wavefront against JAX's alike; ROADMAP queue 3).  Later
    frames and the temporal halo are held bit for bit against the port's
    one device above."""
    got = _ranks(request, world)[name][0]
    ref = _jax_restir_first_frame(kind, world, radius, move)
    _gates(got.numpy(), ref, 0.01 if kind == "di" else 0.02)


FLOAT_FIELDS = ("albedo", "roughness", "metallic", "emission_color", "emission_power")


def _one_device_nee_train():
    scene, cam = W.train_scene()
    step = shard.make_train_step(scene, W.TRAIN, W.TRAIN, W.NEE_TRAIN, lr=0.05, device="cpu")
    params, losses, after = scene.to("cpu").materials, [], []
    for i in range(2):
        params, loss = step(params, cam.inv_projection, cam.inv_view, i + 1, torch.zeros((W.TRAIN ** 2, 3)))
        losses.append(loss)
        after.append(params)
    return torch.stack(losses), after


def test_nee_train_step_matches_one_device(ranks2):
    got = ranks2["nee_train"]
    losses, after = _one_device_nee_train()
    assert bool(torch.isfinite(got["losses"]).all()) and float(got["losses"][1]) < float(got["losses"][0])
    # the reported loss is accumulated in float64 (shard.reported_loss): 1 ulp
    assert ((got["losses"] - losses).abs() <= torch.as_tensor(np.spacing(losses.numpy()))).all()
    for got_p, params in zip(got["params"], after):
        for f in FLOAT_FIELDS:
            torch.testing.assert_close(got_p[f], getattr(params, f), rtol=1e-6, atol=1e-9)
        assert torch.equal(got_p["albedo_map"], params.albedo_map)


@functools.lru_cache(maxsize=None)
def _jax_nee_step(n_devices):
    """One step of JAX ``make_train_step`` (tests/test_multihost.py:61's
    settings) on ``n_devices`` virtual CPU devices: (loss, the start's and
    the new parameters)."""
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.config import RenderSettings as JSettings
    from fypraytracer_tpu.config import SamplingTechnique as JTech
    from fypraytracer_tpu.parallel.shard import make_pixel_mesh, make_train_step, replicate_scene
    from fypraytracer_tpu.scene.procedural import cornell_box

    builder, cam = cornell_box(width=W.TRAIN, height=W.TRAIN, sphere_res=(6, 10))
    mesh = make_pixel_mesh(jax.devices()[:n_devices])
    scene = replicate_scene(builder.compile(), mesh)
    settings = JSettings(technique=JTech.NEE_MIS, bounces=1, samples=1, sky_color=W.SKY)
    step = make_train_step(scene, mesh, W.TRAIN, W.TRAIN, settings, lr=0.05)
    params, loss = step(scene.materials, jnp.asarray(cam.inv_projection), jnp.asarray(cam.inv_view),
                        jnp.uint32(1), jnp.zeros((W.TRAIN ** 2, 3), jnp.float32))
    return float(loss), scene.materials, params


def _updates(before, after):
    return {f: np.asarray(getattr(after, f) if hasattr(after, f) else after[f]) - np.asarray(getattr(before, f))
            for f in FLOAT_FIELDS}


def test_nee_train_step_matches_jax(ranks2):
    """The first step against JAX ``make_train_step`` on one device: the
    loss within 1e-4 relative, each field's update within 1% of its largest
    entry (a grazing pixel traced by Möller–Trumbore here, Baldwin–Weber
    there, moves a gradient by up to 0.76% of its largest entry,
    tests/test_torch_gradients.py).  The second step is not compared: every
    float field trains, and step 1's metallic (about 1e-7 from 0) switches
    the BRDF mixture's lobe choice on (ROADMAP queue 3)."""
    loss, start, params = _jax_nee_step(1)
    got = ranks2["nee_train"]
    np.testing.assert_allclose(float(got["losses"][0]), loss, rtol=1e-4)
    want, ours = _updates(start, params), _updates(start, got["params"][0])
    for f in FLOAT_FIELDS:
        scale = max(np.abs(want[f]).max(), 1e-12)
        assert np.abs(ours[f] - want[f]).max() / scale < 0.01, f


def test_jax_mesh_train_step_takes_one_shard_gradient_times_the_devices(ranks2):
    """A fault of the reference, pinned: JAX ``make_train_step`` on 2
    devices (tests/test_multihost.py:61's) updates each device with the
    device count times its own shard's gradient (the grad of ``psum``
    under ``shard_map(check_vma=False)``), and returns device 0's.  The
    light is seen only in shard 0's rows at 16², so its emission's update
    is 2x the whole image's, which the port's ``all_reduce`` of the
    shards' gradients gives (ROADMAP queue 3)."""
    loss, start, params = _jax_nee_step(2)
    got = ranks2["nee_train"]
    np.testing.assert_allclose(float(got["losses"][0]), loss, rtol=1e-4)
    want, ours = _updates(start, params), _updates(start, got["params"][0])
    light = np.argmax(np.abs(ours["emission_power"]))
    assert ours["emission_power"][light] != 0.0
    np.testing.assert_allclose(want["emission_power"][light], 2.0 * ours["emission_power"][light], rtol=0.01)


@functools.lru_cache(maxsize=None)
def _one_device_di_grad(world):
    """The DI train step's loss and gradient on one device: the setup of
    ``world`` ranks (``torch_parallel_worker.di_grad_setup``: the radius
    follows the shard's rows), rendered whole."""
    radius = W.DI_GRAD // world - 1
    mesh = distributed.make_pixel_mesh(None, "cpu")
    step, (ip, iv, ppv), state, target, params = W.di_grad_setup(mesh, radius=radius)
    scene, _ = W.restir_scene(W.DI_GRAD)
    scene = scene.to("cpu")
    leaves = {f: getattr(params, f).clone().requires_grad_(True) for f in ("albedo", "emission_power")}
    sc = with_materials(scene, dataclasses.replace(params, **leaves))
    pix = torch.arange(W.DI_GRAD ** 2)
    o, d = shard.slab_rays(ip, iv, W.DI_GRAD, W.DI_GRAD, pix)
    hdr, _ = restir_di.render_restir_di(sc, pick_tracer(sc), o, d, pix, 2, W.di_settings(radius),
                                        state, W.DI_GRAD, W.DI_GRAD, torch.as_tensor(ppv))
    loss = ((hdr - target) ** 2).sum() / (W.DI_GRAD ** 2 * 3)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return shard.reported_loss(None, hdr - target, W.DI_GRAD ** 2), grads


@pytest.mark.parametrize("world", [2, 4])
def test_di_train_step_gradient_crosses_shards(request, world):
    got = _ranks(request, world)["di_grad"]
    loss, grads = _one_device_di_grad(world)
    assert abs(float(got["loss"]) - float(loss)) <= np.spacing(np.float32(loss))
    for f, g in grads.items():
        assert float(g.abs().max()) > 0.0, f
        err = float((got["grads"][f] - g).abs().max()) / float(g.abs().max())
        assert err < 1e-5, (f, err)


def test_steps_per_call_equals_the_per_step_loop(ranks2):
    got = ranks2["steps_per_call"]
    assert got["losses_scan"].shape == (2,)
    assert torch.equal(got["losses_scan"], got["losses_loop"])
    assert torch.equal(got["albedo_scan"], got["albedo_loop"])
    assert got["state_equal"]
    assert float(got["losses_scan"][1]) != float(got["losses_scan"][0])


@pytest.mark.parametrize("world", [2, 4])
def test_hosts_outer_mesh_and_batch_slice(request, world):
    """Rank 0 of ``world`` processes on one host: the hosts-outer order is
    the ranks' own, its batch slice the first of ``world``, and a second
    ``init_distributed`` leaves the group as it was."""
    got = _ranks(request, world)["mesh"]
    assert got == dict(index=0, order=list(range(world)), size=world, slice=[0, 10 // world])


def test_one_process_mesh_and_helpers():
    """Without a process group: one shard, collectives the identity, the
    batch slice the whole axis (JAX distributed.py:44-49)."""
    mesh = shard.make_pixel_mesh(device="cpu")
    assert (mesh.index, mesh.size, mesh.group) == (0, 1, None)
    distributed.init_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert distributed.local_batch_slice(10) == slice(0, 10)
    t = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(shard.gather_pixels(mesh, t), t)
    assert torch.equal(distributed.all_reduce_sum(mesh, t.clone()), t)
    assert distributed.pixel_mesh_hosts_outer(device="cpu") == mesh
    with pytest.raises(ValueError, match="equal slabs"):
        shard.shard_pixels(dataclasses.replace(mesh, size=3), 16, "cpu")
