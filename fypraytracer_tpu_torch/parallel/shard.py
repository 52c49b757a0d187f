"""Multi-device rendering and training: pixel-slab data parallelism over
``torch.distributed``.

The torch counterpart of ``fypraytracer_tpu/parallel/shard.py``.  Pixels are
the data-parallel axis: each process renders one contiguous slab of the
row-major pixels on its own device, with the whole scene replicated
(``replicate_scene``); training sums the slabs' gradients with
``all_reduce`` (JAX: ``psum``), and ``gather_pixels`` assembles an image
(JAX: the sharded output's layout).  Where the JAX package writes one
``shard_map`` program over a device mesh, here each process runs the same
Python on its shard, and ``parallel/distributed.py`` holds the process
group (``PixelMesh``) and the collectives: NCCL on CUDA devices, gloo on
the CPU (and gloo through host memory for two processes that share one
card).  Every shard's rays and random keys are its global pixels', so the
shards' pixels are the same bits as one device's.

* ``sharded_render`` (:44-81): a hemisphere-sampler wavefront frame of a
  slab, every trace the kernel ``csrc/trace.cu`` on a CUDA device;
* ``sharded_megakernel_render`` (:84-152): the fast path, K2
  (``csrc/megakernel.cu``) launched on the slab through its pixel-slab
  entry (``megakernel(..., pix0=, n_pix=)``);
* ``make_train_step`` (:160-278): inverse rendering, torch autograd through
  the wavefront integrators (NEE or a hemisphere sampler).  Discrete
  choices (hit triangles, light picks, lobe choices) carry no gradient, as
  in the JAX package; radiance differentiates with respect to the
  material table's float fields.  On a textured scene the integrators
  fetch the albedo maps; the texels are no parameters of the step.
  Without a mesh it is the single-device step.

Each entry point reads the walks' stack-overflow flag without waiting
(``ops.traverse.OverflowWatch``).
"""

from __future__ import annotations

import dataclasses

import torch

from fypraytracer_tpu_torch.core.camera import Camera, generate_rays
from fypraytracer_tpu_torch.ops.texture import check_scene_tex
from fypraytracer_tpu_torch.ops.traverse import OverflowWatch, pick_tracer
from fypraytracer_tpu_torch.parallel.distributed import (  # noqa: F401  (make_pixel_mesh: JAX shard.py's name)
    PixelMesh,
    all_gather_shards,
    all_reduce_sum,
    broadcast_from_first,
    make_pixel_mesh,
)
from fypraytracer_tpu_torch.render.integrators import radiance_hemisphere, radiance_nee_mis
from fypraytracer_tpu_torch.render.megakernel import K2Launcher, megakernel
from fypraytracer_tpu_torch.scene.types import FLOAT_MATERIAL_FIELDS, MaterialTable, Scene, with_materials


def replicate_scene(scene: Scene, mesh: PixelMesh) -> Scene:
    """The scene on this process's device, every tensor shard 0's (a
    broadcast from it, JAX :37-41's replicated upload).  Every process
    builds a scene of the same shapes first."""
    scene = scene.to(mesh.device)
    for t in _tensors(scene):
        broadcast_from_first(mesh, t)
    return scene


def _tensors(obj):
    """The tensor leaves of a scene's (nested) dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def shard_pixels(mesh: PixelMesh | None, n_pix: int, device) -> torch.Tensor:
    """This shard's slab of the row-major pixel ids ``0 .. n_pix-1``: the
    ``index``-th of ``size`` equal slabs (all of them without a mesh)."""
    if mesh is None:
        return torch.arange(n_pix, device=device)
    if n_pix % mesh.size:
        raise ValueError(f"{n_pix} pixels do not split into {mesh.size} equal slabs")
    per = n_pix // mesh.size
    return torch.arange(mesh.index * per, (mesh.index + 1) * per, device=device)


def gather_pixels(mesh: PixelMesh, local: torch.Tensor) -> torch.Tensor:
    """The whole image's rows from every shard's slab ``local``, in pixel
    order, on every shard."""
    return torch.cat(all_gather_shards(mesh, local), dim=0)


def slab_rays(inv_proj, inv_view, width: int, height: int, pixel_ids):
    """The camera rays of the pixels ``pixel_ids``: the same bits as the
    whole grid's (``generate_rays``)."""
    return generate_rays(inv_proj, inv_view, width, height, device=pixel_ids.device,
                         pixel_x=pixel_ids % width, pixel_y=pixel_ids // width)


def sharded_render(scene: Scene, mesh: PixelMesh, width: int, height: int, settings,
                   technique_sampler: str = "cosine"):
    """A frame renderer of this shard's slab (JAX :44-81): returns
    ``render(inv_proj, inv_view, frame) -> (H*W/size, 3)`` HDR of a frame
    of the hemisphere sampler ``technique_sampler``, every trace the kernel
    ``csrc/trace.cu`` on a CUDA device.  H*W must divide by the mesh's
    size; ``gather_pixels`` assembles the image."""
    scene = scene.to(mesh.device)
    check_scene_tex(scene)
    pixel_ids = shard_pixels(mesh, width * height, mesh.device)
    trace = pick_tracer(scene)
    overflow = OverflowWatch(scene)

    def render(inv_proj, inv_view, frame):
        overflow.poll()
        o, d = slab_rays(inv_proj, inv_view, width, height, pixel_ids)
        hdr = radiance_hemisphere(scene, trace, o, d, pixel_ids, frame, settings, technique_sampler)
        overflow.queue()
        return hdr

    return render


def sharded_megakernel_render(scene: Scene, mesh: PixelMesh, width: int, height: int, settings,
                              n_frames: int):
    """The multi-device fast path (JAX :84-152): returns ``render(camera,
    frame0) -> (H*W/size, 3)`` HDR of this shard's slab summed over
    ``n_frames`` frames from ``frame0``, one launch of K2
    (``csrc/megakernel.cu``) through its pixel-slab entry, the slab at
    ``pix0 = index · H·W/size``.  The slabs join into the one-launch image
    bit for bit.  Techniques 0-6; triangles numbered as given (hand it
    ``morton_permuted_scene(scene)[0]`` for the JAX megakernels' order, as
    ``MegakernelRenderer`` takes it)."""
    scene = scene.to(mesh.device)
    check_scene_tex(scene)
    ids = shard_pixels(mesh, width * height, "cpu")
    pix0, n_pix = int(ids[0]), ids.numel()
    overflow = OverflowWatch(scene)
    launcher = K2Launcher()         # the slab's launch, prepared at the first call

    def render(camera: Camera, frame0: int):
        if (camera.width, camera.height) != (width, height):
            raise ValueError(f"the camera is {camera.width}x{camera.height}, the mesh's image {width}x{height}")
        overflow.poll()
        out = megakernel(scene, camera, frame0, n_frames, settings, pix0=pix0, n_pix=n_pix, launcher=launcher)
        overflow.queue()
        return out

    return render


def reported_loss(mesh: PixelMesh | None, err: torch.Tensor, n_pix: int) -> torch.Tensor:
    """``sum(err²) / (3·n_pix)`` over every shard's ``err``, the float32
    loss a train step reports: accumulated in float64 and summed over the
    shards before the one rounding, so that it is the same to an ulp
    however the pixels are split (its gradient does not depend on the
    order of the sum)."""
    total = (err.detach().double() ** 2).sum()
    if mesh is not None:
        all_reduce_sum(mesh, total)
    return (total / (n_pix * 3)).float()


def make_train_step(scene: Scene, width: int, height: int, settings, lr: float = 0.05,
                    technique: str = "nee", optimizer=None, device="cuda",
                    fields=FLOAT_MATERIAL_FIELDS, mesh: PixelMesh | None = None):
    """An inverse-rendering step that moves the material parameters toward
    a target image (JAX :160-278).

    The loss of one frame is ``sum((hdr - target)²) / (3·W·H)`` over every
    pixel (:201-204).  With a ``mesh`` (``make_pixel_mesh``) each process
    renders its slab on the mesh's device (``device`` is then the mesh's),
    its loss is its slab's sum over the global pixel count, the gradients
    and the reported loss are summed over the shards with ``all_reduce``
    (JAX: grad-of-``psum``), and every shard applies the same update.  The
    reported loss is accumulated in float64 (``reported_loss``).
    ``technique``: ``"nee"`` (``radiance_nee_mis``) or a
    ``radiance_hemisphere`` sampler (``"cosine"``, ``"brdf"``, ...).  Only
    the float fields of the material table are updated, all of them by
    default as in the JAX function, or those named in ``fields`` as the
    JAX ReSTIR train steps take them (parallel/restir_shard.py);
    ``albedo_map`` is left as it is (:206-244).  ``target`` is the whole
    (H*W, 3) or (H, W, 3) image on every shard.

    ``optimizer``: None for plain SGD at ``lr``, returning
    ``step(params, inv_proj, inv_view, frame, target) -> (new_params, loss)``.
    Otherwise a factory of a ``torch.optim`` optimizer over a list of tensors
    (``functools.partial(torch.optim.Adam, lr=0.05)``), in place of the JAX
    package's optax transformation: ``make_train_step`` then returns
    ``(step, init_opt_state)``, with ``init_opt_state(params) -> opt_state``
    and ``step(params, opt_state, inv_proj, inv_view, frame, target) ->
    (new_params, opt_state, loss)``.  ``params`` is a ``MaterialTable`` of
    tensors on the device; the returned parameters are new tensors.  With a
    mesh a field the loss does not reach gets a zero gradient (the shards
    must sum the same tensors), where one device leaves it out.
    """
    device = mesh.device if mesh is not None else torch.device(device)
    scene = scene.to(device)
    check_scene_tex(scene)
    n_pix = width * height
    pixel_ids = shard_pixels(mesh, n_pix, device)
    rows = slice(int(pixel_ids[0]), int(pixel_ids[-1]) + 1)
    trace = pick_tracer(scene)
    overflow = OverflowWatch(scene)

    def error_of(params: MaterialTable, inv_proj, inv_view, frame, target):
        """hdr - target at the shard's pixels."""
        sc = with_materials(scene, params)
        origins, directions = slab_rays(inv_proj, inv_view, width, height, pixel_ids)
        if technique == "nee":
            hdr = radiance_nee_mis(sc, trace, origins, directions, pixel_ids, frame, settings)
        else:
            hdr = radiance_hemisphere(sc, trace, origins, directions, pixel_ids, frame, settings, technique)
        return hdr - torch.as_tensor(target, dtype=torch.float32, device=device).reshape(n_pix, 3)[rows]

    def summed(grads, values):
        """The gradients summed over the shards (zeros where the loss does
        not reach a field); one device keeps them as they are."""
        if mesh is None:
            return list(grads)
        return [all_reduce_sum(mesh, torch.zeros_like(v) if g is None else g) for g, v in zip(grads, values)]

    def leaves(params: MaterialTable) -> dict:
        """Fresh leaf tensors of the float fields, requiring grad."""
        return {f: getattr(params, f).detach().clone().requires_grad_(True) for f in fields}

    def table(params: MaterialTable, values: dict) -> MaterialTable:
        return dataclasses.replace(params, **values)

    def total(err):
        return reported_loss(mesh, err, n_pix)

    if optimizer is None:
        def step(params, inv_proj, inv_view, frame, target):
            overflow.poll()
            p = leaves(params)
            err = error_of(table(params, p), inv_proj, inv_view, frame, target)
            loss = (err * err).sum() / (n_pix * 3)
            grads = summed(torch.autograd.grad(loss, list(p.values()), allow_unused=True), p.values())
            with torch.no_grad():
                new = {f: v if g is None else v - lr * g for (f, v), g in zip(p.items(), grads)}
            overflow.queue()
            return table(params, {f: v.detach() for f, v in new.items()}), total(err)

        return step

    def init_opt_state(params):
        p = leaves(params)
        return dict(leaves=p, optimizer=optimizer(list(p.values())))

    def step_opt(params, opt_state, inv_proj, inv_view, frame, target):
        overflow.poll()
        p, opt = opt_state["leaves"], opt_state["optimizer"]
        with torch.no_grad():                      # the step starts from the given parameters
            for f, v in p.items():
                v.copy_(getattr(params, f))
        opt.zero_grad(set_to_none=True)
        err = error_of(table(params, p), inv_proj, inv_view, frame, target)
        ((err * err).sum() / (n_pix * 3)).backward()
        if mesh is not None:
            for v, g in zip(p.values(), summed([v.grad for v in p.values()], p.values())):
                v.grad = g
        opt.step()
        overflow.queue()
        return table(params, {f: v.detach().clone() for f, v in p.items()}), opt_state, total(err)

    return step_opt, init_opt_state
