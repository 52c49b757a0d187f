"""The ranks of tests/test_torch_parallel.py: each runs the port's sharded
paths in its own process on the CPU, joined by gloo over a ``FileStore``
rendezvous in the test's temporary directory (no port, so parallel test
workers cannot collide).  Imports no JAX.

``run(world, tmp_dir, cases)`` spawns ``world`` ranks with
``torch.multiprocessing``; each rank runs every named case and saves what it
returns, and the parent gets rank 0's results.  Each case renders at the
sizes of the JAX package's tests (tests/test_restir_shard.py,
tests/test_multihost.py).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.core.camera import Camera
from fypraytracer_tpu_torch.parallel import distributed, restir_shard, shard
from fypraytracer_tpu_torch.scene.procedural import cornell_box

SKY = (0.05, 0.06, 0.08)
RESTIR = 64          # the ReSTIR cases' width and height (tests/test_restir_shard.py)
TRAIN = 16           # the NEE train step's (tests/test_multihost.py)
DI_GRAD = 32         # the DI train step's gradient check


def di_settings(radius: int) -> RenderSettings:
    return RenderSettings(technique=SamplingTechnique.RESTIR_DI, light_candidates=4, spatial_neighbors=3,
                          spatial_radius=radius)


def gi_settings(radius: int) -> RenderSettings:
    return RenderSettings(technique=SamplingTechnique.RESTIR_GI, bounces=2, spatial_neighbors=3,
                          spatial_radius=radius)


NEE_TRAIN = RenderSettings(technique=SamplingTechnique.NEE_MIS, bounces=1, samples=1, sky_color=SKY)
COSINE = RenderSettings(technique=SamplingTechnique.COSINE, bounces=2, samples=1, sky_color=SKY)


def restir_scene(size: int = RESTIR):
    """Cornell without spheres and its camera (tests/test_restir_shard.py)."""
    builder, cam = cornell_box(width=size, height=size, with_spheres=False)
    return builder.compile(), cam


def train_scene():
    builder, cam = cornell_box(width=TRAIN, height=TRAIN, sphere_res=(6, 10))
    return builder.compile(), cam


def camera_path(cam: Camera, frames: int, move: bool):
    """(inv_proj, inv_view, prev proj @ view) of each frame: the camera
    static (its prev proj @ view), or panning up 0.05 a frame with frame
    f's prev proj @ view frame f-1's, as tests/test_restir_shard.py's
    moving-camera test poses it."""
    if not move:
        return [(cam.inv_projection, cam.inv_view, cam.prev_proj_view)] * frames
    poses = [Camera(position=(0.0, 1.0 + 0.05 * f, 2.6), forward=(0.0, 0.0, -1.0), vfov_deg=45.0,
                    width=cam.width, height=cam.height) for f in range(frames)]
    return [(p.inv_projection, p.inv_view, poses[max(f - 1, 0)].proj_view) for f, p in enumerate(poses)]


def restir_frames(make, settings, frames: int, move: bool, mesh, size: int = RESTIR):
    """The gathered HDR of each of ``frames`` frames of a sharded ReSTIR
    renderer, (frames, H*W, 3)."""
    scene, cam = restir_scene(size)
    step, init_state = make(shard.replicate_scene(scene, mesh), mesh, size, size, settings)
    state, out = init_state(), []
    for f, (ip, iv, ppv) in enumerate(camera_path(cam, frames, move)):
        hdr, state = step(ip, iv, ppv, f + 1, state)
        out.append(shard.gather_pixels(mesh, hdr))
    return torch.stack(out)


def case_render(mesh):
    scene, cam = restir_scene(32)
    render = shard.sharded_render(shard.replicate_scene(scene, mesh), mesh, 32, 32, COSINE, "cosine")
    return shard.gather_pixels(mesh, render(cam.inv_projection, cam.inv_view, 1))


def case_megakernel(mesh):
    builder, cam = cornell_box(16, 16)
    render = shard.sharded_megakernel_render(builder.compile(), mesh, 16, 16, NEE_TRAIN, 2)
    return shard.gather_pixels(mesh, render(cam, 1))


def case_di(mesh, radius, move=False):
    return restir_frames(restir_shard.make_restir_di_sharded, di_settings(radius), 3, move, mesh)


def case_gi(mesh, radius):
    return restir_frames(restir_shard.make_restir_gi_sharded, gi_settings(radius), 2, False, mesh)


def case_nee_train(mesh):
    """Two SGD steps of the mesh NEE train step (tests/test_multihost.py):
    the losses and the float fields after each step."""
    scene, cam = train_scene()
    step = shard.make_train_step(shard.replicate_scene(scene, mesh), TRAIN, TRAIN, NEE_TRAIN, lr=0.05,
                                 mesh=mesh)
    params, losses, after = shard.replicate_scene(scene, mesh).materials, [], []
    target = torch.zeros((TRAIN * TRAIN, 3))
    for i in range(2):
        params, loss = step(params, cam.inv_projection, cam.inv_view, i + 1, target)
        losses.append(loss)
        after.append({f.name: getattr(params, f.name) for f in dataclasses.fields(params)})
    return dict(losses=torch.stack(losses), params=after)


def di_grad_setup(mesh, steps_per_call=1, radius=None):
    """The DI train step at DI_GRAD² with a target of the scene's own
    first frame and a state after one frame of history."""
    scene, cam = restir_scene(DI_GRAD)
    st = di_settings(radius if radius is not None else DI_GRAD // mesh.size - 1)
    scene = shard.replicate_scene(scene, mesh)
    step, init_state = restir_shard.make_restir_di_train_step(
        scene, mesh, DI_GRAD, DI_GRAD, st, lr=0.5, fields=("albedo", "emission_power"),
        steps_per_call=steps_per_call, clip01=("albedo",))
    render, _ = restir_shard.make_restir_di_sharded(scene, mesh, DI_GRAD, DI_GRAD, st)
    ip, iv, ppv = cam.inv_projection, cam.inv_view, cam.prev_proj_view
    target, state = render(ip, iv, ppv, 1, init_state())
    target = shard.gather_pixels(mesh, target)
    params = dataclasses.replace(scene.materials, albedo=scene.materials.albedo * 0.8)
    return step, (ip, iv, ppv), state, target, params


def case_di_grad(mesh):
    """The summed gradient of one DI train step at frame 2."""
    step, (ip, iv, ppv), state, target, params = di_grad_setup(mesh)
    loss, grads, _ = step.loss_and_grad(params, ip, iv, ppv, 2, state, target)
    return dict(loss=loss, grads=grads)


def case_steps_per_call(mesh):
    """Two micro-steps in one call, and the same two steps as two calls."""
    step2, (ip, iv, ppv), state, target, params = di_grad_setup(mesh, steps_per_call=2)
    p2, s2, losses2 = step2(params, ip, iv, ppv, 2, state, target)
    step1 = di_grad_setup(mesh)[0]
    p1, losses1 = params, []
    for _ in range(2):
        p1, s1, loss = step1(p1, ip, iv, ppv, 2, state, target)
        losses1.append(loss)
    return dict(losses_scan=losses2, losses_loop=torch.stack(losses1), albedo_scan=p2.albedo,
                albedo_loop=p1.albedo, state_equal=all(torch.equal(a, b) for a, b in zip(_flat(s2), _flat(s1))))


def case_mesh(mesh):
    """The hosts-outer mesh and this rank's batch slice of 10 items (JAX
    distributed.py:37-49), and init_distributed again (a no-op)."""
    distributed.init_distributed("file:///nonexistent", mesh.size, mesh.index, backend="gloo")
    outer = distributed.pixel_mesh_hosts_outer(device="cpu")
    s = distributed.local_batch_slice(10)
    return dict(index=outer.index, order=list(outer.order), size=outer.size, slice=[s.start, s.stop])


def _flat(tree):
    return [t for v in tree.values() for t in (_flat(v) if isinstance(v, dict) else [v])]


CASES = dict(render=case_render, megakernel=case_megakernel, di=case_di, gi=case_gi, nee_train=case_nee_train,
             di_grad=case_di_grad, steps_per_call=case_steps_per_call, mesh=case_mesh)


def _rank(rank: int, world: int, tmp_dir: str, cases: list) -> None:
    torch.set_num_threads(1)
    distributed.init_distributed(f"file://{os.path.join(tmp_dir, 'rendezvous')}", world, rank, backend="gloo")
    try:
        mesh = shard.make_pixel_mesh(device="cpu")
        out = {}
        for name, fn, kw in cases:
            out[name] = CASES[fn](mesh, **kw)
        torch.save(out, os.path.join(tmp_dir, f"rank{rank}.pt"))
        dist.barrier()              # no rank leaves the group while another still talks to it
    finally:
        dist.destroy_process_group()


def run(world: int, tmp_dir, cases: list) -> dict:
    """Rank 0's results of ``cases`` ((name, case, kwargs) triples) run on
    ``world`` ranks; every rank's gathered results must agree."""
    tmp_dir = str(tmp_dir)
    mp.start_processes(_rank, args=(world, tmp_dir, cases), nprocs=world, start_method="spawn", join=True)
    return torch.load(os.path.join(tmp_dir, "rank0.pt"))
