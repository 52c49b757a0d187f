"""Sharded ReSTIR: spatiotemporal reuse across pixel-shard boundaries.

The torch counterpart of ``fypraytracer_tpu/parallel/restir_shard.py``.  The
image is sharded by pixel rows over the processes of a ``PixelMesh``
(``parallel/distributed.py``), each shard a slab of ``H/size`` rows.  Stage
1 (candidates and temporal reuse) first brings the PREVIOUS frame's state
of ``radius`` rows from each neighbouring shard (the halo exchange), so
that temporal reprojection under a moving camera reads exact history for
motion up to ``radius`` rows across a shard boundary; a reprojection past
the halo reads a reservoir with m = 0, which the temporal merge rejects
(history dropped, the estimator unbiased: a disocclusion's fallback).
Between the stages each shard exchanges ``radius`` rows of its stage-1
output with both neighbours; stage 2's neighbour gathers then index the
shard's rows and halo with global pixel ids, and read what one device
would read (|dy| <= radius by construction).

The exchange (``_halo_exchange``) is an all-gather of every shard's head
and tail rows, a collective that NCCL and gloo both carry, and a
``torch.autograd.Function``: its backward sends each halo's gradient back
to the shard that owns those rows and adds it to their gradient, the
transpose of JAX's ``ppermute`` that the DI and GI train steps
differentiate through.  A shard's fields cross it packed, one tensor a
dtype, so each exchange is one collective a dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from fypraytracer_tpu_torch.core.mathutils import encode_octahedral
from fypraytracer_tpu_torch.ops.texture import check_scene_tex
from fypraytracer_tpu_torch.ops.traverse import OverflowWatch, pick_tracer
from fypraytracer_tpu_torch.parallel.distributed import PixelMesh, all_gather_shards, all_reduce_sum
from fypraytracer_tpu_torch.parallel.shard import reported_loss, shard_pixels, slab_rays
from fypraytracer_tpu_torch.render import restir_di, restir_gi
from fypraytracer_tpu_torch.scene.types import FLOAT_MATERIAL_FIELDS, with_materials


class _Halo(torch.autograd.Function):
    """[the up-neighbour's last ``halo`` rows, x, the down-neighbour's first
    ``halo`` rows], zeros past the image's edge (JAX :36-56)."""

    @staticmethod
    def forward(ctx, x, halo: int, mesh: PixelMesh):
        ctx.halo, ctx.mesh = halo, mesh
        parts = all_gather_shards(mesh, torch.stack([x[:halo], x[x.shape[0] - halo:]]))
        i, zero = mesh.index, torch.zeros_like(x[:halo])
        above = parts[i - 1][1] if i > 0 else zero
        below = parts[i + 1][0] if i < mesh.size - 1 else zero
        return torch.cat([above, x, below])

    @staticmethod
    def backward(ctx, grad):
        halo, mesh, i = ctx.halo, ctx.mesh, ctx.mesh.index
        n = grad.shape[0] - 2 * halo
        parts = all_gather_shards(mesh, torch.stack([grad[:halo], grad[n + halo:]]))
        gx = grad[halo:n + halo].clone()
        if i < mesh.size - 1:                       # the down-neighbour's upper halo is this tail
            gx[n - halo:] += parts[i + 1][0]
        if i > 0:                                   # the up-neighbour's lower halo is this head
            gx[:halo] += parts[i - 1][1]
        return gx, None, None


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _halo_exchange(tree, halo: int, mesh: PixelMesh):
    """Every leaf of a (nested) dict of shard arrays with its halo rows, as
    ``_Halo`` gives them; the leaves of one dtype cross in one tensor."""
    leaves = list(_leaves(tree))
    out = {}
    for dtype in dict.fromkeys(v.dtype for _, v in leaves):
        group = [(p, v) for p, v in leaves if v.dtype == dtype]
        flat = [v.reshape(v.shape[0], -1) for _, v in group]
        packed = _Halo.apply(torch.cat(flat, dim=1), halo, mesh) if halo else torch.cat(flat, dim=1)
        for (p, v), part in zip(group, packed.split([f.shape[1] for f in flat], dim=1)):
            out[p] = part.reshape(packed.shape[0], *v.shape[1:])

    def rebuild(t, path=()):
        return {k: rebuild(v, path + (k,)) for k, v in t.items()} if isinstance(t, dict) else out[path]

    return rebuild(tree)


class _Shifted:
    """Global-index view of a shard's array whose row 0 is global pixel
    ``base``: indexing clamps ``idx - base`` into the rows (JAX :59-71).
    part1 and part2 index their inputs with global pixel ids, so a shard's
    arrays wear this view."""

    def __init__(self, arr, base: int):
        self.arr, self.base = arr, base

    def __getitem__(self, idx):
        return self.arr[torch.clamp(idx - self.base, 0, self.arr.shape[0] - 1)]


class _ShiftedZeroOutside(_Shifted):
    """``_Shifted`` that gives zeros for global indices outside the rows
    (JAX :74-84): worn by the reservoirs' ``m``, so that a reprojection past
    the halo reads m == 0 and the merge rejects it."""

    def __getitem__(self, idx):
        local = idx - self.base
        ok = (local >= 0) & (local < self.arr.shape[0])
        v = self.arr[torch.clamp(local, 0, self.arr.shape[0] - 1)]
        return torch.where(ok.reshape(ok.shape + (1,) * (v.dim() - ok.dim())), v, torch.zeros_like(v))


def _shift_tree(tree, base: int):
    """Every leaf of a (nested) state dict behind a global-index view."""
    if isinstance(tree, dict):
        return {k: _shift_tree(v, base) for k, v in tree.items()}
    return _Shifted(tree, base)


def _make_restir_body(width: int, height: int, settings, part1, part2, pack_state, mesh: PixelMesh):
    """The shard's ReSTIR frame (halo exchanges, part1 and part2), shared by
    the renderers and the train steps (JAX :94-142): returns
    ``body(scene, trace, inv_proj, inv_view, ppv, frame, state) -> (hdr of
    the shard's pixels, the shard's new state)``."""
    if height % mesh.size:
        raise ValueError(f"height {height} not divisible by {mesh.size}")
    rows = height // mesh.size
    radius = int(settings.spatial_radius)
    if radius > rows:
        raise ValueError(f"spatial radius {radius} exceeds shard rows {rows}; use fewer devices or a smaller radius")
    halo = radius * width
    pixel_ids = shard_pixels(mesh, width * height, mesh.device)
    base = (mesh.index * rows - radius) * width     # global pixel of halo row 0

    def body(scene, trace, inv_proj, inv_view, ppv, frame, state):
        o, d = slab_rays(inv_proj, inv_view, width, height, pixel_ids)
        # temporal halo: `radius` rows of the PREVIOUS frame's state, so a
        # moving camera's reprojection is exact across shard boundaries
        state_h = _halo_exchange(state, halo, mesh)
        view = dict(state_h, normal_oct=_Shifted(state_h["normal_oct"], base))
        rsv = _shift_tree(state_h["reservoir"], base)
        rsv["m"] = _ShiftedZeroOutside(state_h["reservoir"]["m"], base)
        view["reservoir"] = rsv
        g = part1(scene, trace, o, d, pixel_ids, frame, settings, view, width, height, ppv)
        # every stage-1 field with its halo, read with global ids by stage 2
        full = {k: _Shifted(v, base) for k, v in _halo_exchange(g, halo, mesh).items()}
        hdr, res = part2(scene, trace, o, d, pixel_ids, frame, settings, g, full, width, height)
        return hdr, pack_state(res, g)

    return body


def _di_pack_state(res, g):
    """ReSTIR DI's state of a frame (``restir_di.render_restir_di``'s)."""
    return dict(reservoir={k: res[k] for k in ("index", "w", "pdf", "wsum", "m")}, depth=g["t"],
                normal_oct=encode_octahedral(g["normal"]))


def _gi_pack_state(flat_res, g):
    """ReSTIR GI's state of a frame (``restir_gi.render_restir_gi``'s): the
    path sample's fields unflattened from their ``s_`` names."""
    sample = {k[2:]: v for k, v in flat_res.items() if k.startswith("s_")}
    return dict(reservoir=dict(sample=sample, w=flat_res["w"], m=flat_res["m"], wsum=flat_res["wsum"]),
                depth=g["t"], normal_oct=encode_octahedral(g["normal"]))


def _make_restir_sharded(scene, mesh: PixelMesh, width: int, height: int, settings, module, part1, part2,
                         pack_state):
    scene = scene.to(mesh.device)
    check_scene_tex(scene)
    body = _make_restir_body(width, height, settings, part1, part2, pack_state, mesh)
    trace = pick_tracer(scene)
    overflow = OverflowWatch(scene)

    def step(inv_proj, inv_view, ppv, frame, state):
        overflow.poll()
        with torch.no_grad():
            out = body(scene, trace, inv_proj, inv_view, ppv, frame, state)
        overflow.queue()
        return out

    def init_state():
        return module.init_state(width * height // mesh.size, device=mesh.device)

    return step, init_state


def make_restir_di_sharded(scene, mesh: PixelMesh, width: int, height: int, settings):
    """Sharded ReSTIR DI: ``(step, init_state)`` where ``step(inv_proj,
    inv_view, prev_proj_view, frame, state) -> (hdr of this shard's rows,
    state)`` and ``init_state()`` is the shard's zero state (JAX
    :145-209)."""
    return _make_restir_sharded(scene, mesh, width, height, settings, restir_di,
                                restir_di.restir_di_part1, restir_di.restir_di_part2, _di_pack_state)


def make_restir_gi_sharded(scene, mesh: PixelMesh, width: int, height: int, settings):
    """Sharded ReSTIR GI (the same halo pattern; the stage-1 fields include
    the path sample's, flattened with ``s_`` names) (JAX :359)."""
    return _make_restir_sharded(scene, mesh, width, height, settings, restir_gi,
                                restir_gi.restir_gi_part1, restir_gi.restir_gi_part2, _gi_pack_state)


def make_restir_di_train_step(scene, mesh: PixelMesh, width: int, height: int, settings, lr: float = 0.05,
                              fields=None, steps_per_call: int = 1, clip01: tuple = ()):
    """Differentiable ReSTIR DI: a data-parallel inverse-rendering step
    through the reservoir estimator (JAX :211-254).

    The discrete machinery (candidate indices, accept and merge decisions,
    neighbour picks, M/Z counts, visibility) carries no gradient; the
    continuous factors (the target pdf p̂ in the RIS weight sums, W and the
    final shade) differentiate with respect to the material table.  The
    incoming state is detached (JAX's ``stop_gradient``): a step
    differentiates one frame given its history.  The halo exchanges'
    backward carries the gradient across shards, and the shards' gradients
    are summed with ``all_reduce``.

    Returns ``(step, init_state)`` with ``step(params, inv_proj, inv_view,
    ppv, frame, state, target) -> (new_params, new_state, loss)``, the
    loss summed over the shards (``shard.reported_loss``); ``target`` is
    the whole (H*W, 3) image.
    ``step.loss_and_grad(params, ..., target) -> (loss, {field: grad},
    new_state)`` gives the summed gradient of one step without the update.
    See ``_make_restir_train_step`` for ``fields``, ``steps_per_call`` and
    ``clip01``."""
    return _make_restir_train_step(scene, mesh, width, height, settings, restir_di.restir_di_part1,
                                   restir_di.restir_di_part2, _di_pack_state, restir_di.init_state, lr, fields,
                                   steps_per_call, clip01)


def make_restir_gi_train_step(scene, mesh: PixelMesh, width: int, height: int, settings, lr: float = 0.05,
                              fields=None, steps_per_call: int = 1, clip01: tuple = ()):
    """Differentiable ReSTIR GI: inverse rendering through the path-sample
    reservoir estimator, with the detached-discrete design of
    ``make_restir_di_train_step`` (path throughput, sample radiance, p̂ =
    ‖L‖, the reconnection's shade term and W differentiate) (JAX
    :336-358)."""
    return _make_restir_train_step(scene, mesh, width, height, settings, restir_gi.restir_gi_part1,
                                   restir_gi.restir_gi_part2, _gi_pack_state, restir_gi.init_state, lr, fields,
                                   steps_per_call, clip01)


def _detached(tree):
    return {k: _detached(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.detach()


def _make_restir_train_step(scene, mesh: PixelMesh, width: int, height: int, settings, part1, part2, pack_state,
                            init_state_fn, lr: float, fields, steps_per_call: int = 1, clip01: tuple = ()):
    """The train step over a ReSTIR body (JAX :257-333).  ``fields`` names
    the material fields that SGD updates (all the float fields by
    default): the fields' curvatures under this loss differ widely, so one
    lr across all of them is ill-conditioned.  ``clip01`` names fields
    projected onto [0, 1] after each update.  ``steps_per_call`` > 1 runs
    that many SGD micro-steps from the same frame and incoming state,
    carrying the parameters (JAX's ``lax.scan``): the losses, then a
    (steps_per_call,) tensor, are bit for bit those of as many calls of one
    step, and the state returned is the last micro-step's."""
    scene = scene.to(mesh.device)
    check_scene_tex(scene)
    body = _make_restir_body(width, height, settings, part1, part2, pack_state, mesh)
    trace = pick_tracer(scene)
    overflow = OverflowWatch(scene)
    names = FLOAT_MATERIAL_FIELDS if fields is None else tuple(fields)
    n_pix = width * height
    pixel_ids = shard_pixels(mesh, n_pix, mesh.device)
    rows = slice(int(pixel_ids[0]), int(pixel_ids[-1]) + 1)

    def loss_and_grad(params, ip, iv, ppv, frame, state, target):
        leaves = {f: getattr(params, f).detach().clone().requires_grad_(True) for f in names}
        sc = with_materials(scene, dataclasses.replace(params, **leaves))
        hdr, new_state = body(sc, trace, ip, iv, ppv, frame, _detached(state))
        tgt = torch.as_tensor(target, dtype=torch.float32, device=mesh.device).reshape(n_pix, 3)[rows]
        err = hdr - tgt
        loss = (err * err).sum() / (n_pix * 3)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {f: all_reduce_sum(mesh, torch.zeros_like(v) if g is None else g)
                 for (f, v), g in zip(leaves.items(), grads)}
        return reported_loss(mesh, err, n_pix), grads, _detached(new_state)

    def micro(params, ip, iv, ppv, frame, state, target):
        loss, grads, new_state = loss_and_grad(params, ip, iv, ppv, frame, state, target)
        upd = {}
        with torch.no_grad():
            for f, g in grads.items():
                v = getattr(params, f) - lr * g
                upd[f] = torch.clamp(v, 0.0, 1.0) if f in clip01 else v
        return dataclasses.replace(params, **upd), new_state, loss

    def step(params, ip, iv, ppv, frame, state, target):
        overflow.poll()
        losses = []
        for _ in range(steps_per_call):
            params, new_state, loss = micro(params, ip, iv, ppv, frame, state, target)
            losses.append(loss)
        overflow.queue()
        return params, new_state, losses[0] if steps_per_call == 1 else torch.stack(losses)

    def init_state():
        return init_state_fn(n_pix // mesh.size, device=mesh.device)

    step.loss_and_grad = loss_and_grad
    return step, init_state
