"""Differentiable training step (inverse rendering) on one device.

The single-device part of ``fypraytracer_tpu/parallel/shard.py::
make_train_step`` (:160-250): torch autograd through the wavefront
integrators (NEE by default, or a hemisphere sampler), where every trace is
the kernel ``csrc/trace.cu`` on a CUDA device.  Discrete choices (hit
triangles, light picks, lobe choices) carry no gradient, as in the JAX
package; radiance differentiates with respect to the material table's float
fields.  On a textured scene the integrators fetch the albedo maps, as the
JAX step does; the texels are no parameters of the step (the JAX step
optimises the material table only), though the fetch is differentiable
(``ops/texture.py``).  Each step reads the walks' stack-overflow flag
without waiting (``ops.traverse.OverflowWatch``).  The pixel mesh and the
gradient all-reduce wait for the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses

import torch

from fypraytracer_tpu_torch.core.camera import generate_rays
from fypraytracer_tpu_torch.ops.texture import check_scene_tex
from fypraytracer_tpu_torch.ops.traverse import OverflowWatch, pick_tracer
from fypraytracer_tpu_torch.render.integrators import radiance_hemisphere, radiance_nee_mis
from fypraytracer_tpu_torch.scene.types import FLOAT_MATERIAL_FIELDS, MaterialTable, Scene, with_materials


def make_train_step(scene: Scene, width: int, height: int, settings, lr: float = 0.05,
                    technique: str = "nee", optimizer=None, device="cuda",
                    fields=FLOAT_MATERIAL_FIELDS):
    """An inverse-rendering step that moves the material parameters toward
    a target image.

    The loss of one frame is ``sum((hdr - target)²) / (3·W·H)`` over every
    pixel (:201-204).  ``technique``: ``"nee"`` (``radiance_nee_mis``) or a
    ``radiance_hemisphere`` sampler (``"cosine"``, ``"brdf"``, ...).  Only the
    float fields of the material table are updated, all of them by default
    as in the JAX function, or those named in ``fields`` as the JAX ReSTIR
    train steps take them (parallel/restir_shard.py); ``albedo_map`` is left
    as it is (:206-244).

    ``optimizer``: None for plain SGD at ``lr``, returning
    ``step(params, inv_proj, inv_view, frame, target) -> (new_params, loss)``.
    Otherwise a factory of a ``torch.optim`` optimizer over a list of tensors
    (``functools.partial(torch.optim.Adam, lr=0.05)``), in place of the JAX
    package's optax transformation: ``make_train_step`` then returns
    ``(step, init_opt_state)``, with ``init_opt_state(params) -> opt_state``
    and ``step(params, opt_state, inv_proj, inv_view, frame, target) ->
    (new_params, opt_state, loss)``.  ``params`` is a ``MaterialTable`` of
    tensors on ``device``; the returned parameters are new tensors.
    """
    device = torch.device(device)
    scene = scene.to(device)
    check_scene_tex(scene)
    n_pix = width * height
    pixel_ids = torch.arange(n_pix, device=device)
    trace = pick_tracer(scene)
    overflow = OverflowWatch(scene)

    def loss_of(params: MaterialTable, inv_proj, inv_view, frame, target):
        sc = with_materials(scene, params)
        origins, directions = generate_rays(inv_proj, inv_view, width, height, device=device)
        if technique == "nee":
            hdr = radiance_nee_mis(sc, trace, origins, directions, pixel_ids, frame, settings)
        else:
            hdr = radiance_hemisphere(sc, trace, origins, directions, pixel_ids, frame, settings, technique)
        err = hdr - torch.as_tensor(target, dtype=torch.float32, device=device).reshape(n_pix, 3)
        return (err * err).sum() / (n_pix * 3)

    def leaves(params: MaterialTable) -> dict:
        """Fresh leaf tensors of the float fields, requiring grad."""
        return {f: getattr(params, f).detach().clone().requires_grad_(True) for f in fields}

    def table(params: MaterialTable, values: dict) -> MaterialTable:
        return dataclasses.replace(params, **values)

    if optimizer is None:
        def step(params, inv_proj, inv_view, frame, target):
            overflow.poll()
            p = leaves(params)
            loss = loss_of(table(params, p), inv_proj, inv_view, frame, target)
            grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
            with torch.no_grad():
                new = {f: v if g is None else v - lr * g for (f, v), g in zip(p.items(), grads)}
            overflow.queue()
            return table(params, {f: v.detach() for f, v in new.items()}), loss.detach()

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
        loss = loss_of(table(params, p), inv_proj, inv_view, frame, target)
        loss.backward()
        opt.step()
        overflow.queue()
        return table(params, {f: v.detach().clone() for f, v in p.items()}), opt_state, loss.detach()

    return step_opt, init_opt_state
