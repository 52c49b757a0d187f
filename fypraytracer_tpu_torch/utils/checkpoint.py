"""Checkpoint / resume — long offline renders survive restarts.

The torch counterpart of ``fypraytracer_tpu/utils/checkpoint.py``.  The
reference has no checkpointing (SURVEY.md §5): a crash loses the render.
Here the render state — accumulation buffer, frame index, the wavefront
ReSTIR state (``Renderer.aux_state``), the megakernels' reservoir and
stage planes (``MegakernelReSTIRDI.state``, ``MegakernelReSTIRGI.state``
and ``.stage``) and the camera's previous matrices — is saved with
``torch.save`` to ``state.pt``, and the settings, camera and renderer to
``meta.json``; ``load_checkpoint`` rebuilds the renderer, and a resumed
render continues with the same bits as an uninterrupted one (the
reference's default budget is 120 min, WalnutApp.cpp:23).

A checkpoint refuses to resume into another renderer class, into the other
ReSTIR GI visibility estimator (``final_vis``), as the JAX checkpoint does
(:110-122), and into the other GI mode (``mono``), which the JAX
checkpoint does not check: both modes keep ``state`` and ``stage`` of one
shape, so a mono checkpoint would resume into ``mono=False`` and blend two
estimators into one accumulation buffer.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import torch

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique


def _tree_to(tree, device):
    """A nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _state(renderer) -> dict:
    cam = renderer.camera
    state = {"accum": renderer.accum.cpu(), "frame_index": torch.tensor(renderer.frame_index),
             "prev_view": torch.as_tensor(cam.prev_view), "prev_projection": torch.as_tensor(cam.prev_projection)}
    if getattr(renderer, "aux_state", None) is not None:      # the wavefront ReSTIR state
        state["aux_state"] = _tree_to(renderer.aux_state, "cpu")
    for name in ("state", "stage"):                            # the ReSTIR megakernels' planes
        v = getattr(renderer, name, None)
        if isinstance(v, torch.Tensor):
            state["mk_" + name] = v.cpu()
    return state


def _write(path: str, write) -> None:
    """Write a file through a temporary one renamed into place."""
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, renderer) -> None:
    """Save the renderer's state, settings and camera to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    _write(os.path.join(path, "state.pt"), functools.partial(torch.save, _state(renderer)))
    cam = renderer.camera
    meta = {
        # the renderer and its estimator options are part of the state: a
        # wavefront accumulation restored into a megakernel renderer has the
        # wrong shape, and a GI checkpoint resumed with the other visibility
        # estimator or the other mode would blend two estimators
        "renderer": {"class": type(renderer).__name__, "final_vis": getattr(renderer, "final_vis", None),
                     "mono": getattr(renderer, "mono", None)},
        "settings": {k: (int(v) if isinstance(v, SamplingTechnique) else v)
                     for k, v in dataclasses.asdict(renderer.settings).items()},
        "camera": {"position": cam.position.tolist(), "forward": cam.forward.tolist(), "vfov_deg": cam.vfov_deg,
                   "near": cam.near, "far": cam.far, "width": cam.width, "height": cam.height},
    }

    def dump(p):
        with open(p, "w") as f:
            json.dump(meta, f, indent=2)

    _write(os.path.join(path, "meta.json"), dump)


def read_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def load_checkpoint(path: str, scene, renderer_cls=None, device="cuda"):
    """Rebuild a renderer from a checkpoint directory and the compiled scene.

    ``renderer_cls(scene, camera, settings)`` makes the renderer to restore
    into: by default ``render.renderer.Renderer`` on ``device``; also a
    factory of ``MegakernelRenderer``, ``MegakernelReSTIRDI`` or
    ``MegakernelReSTIRGI``.  Raises ``ValueError`` where it is another
    class than the one that wrote the checkpoint, or a GI renderer with the
    other ``final_vis`` or ``mono``."""
    from fypraytracer_tpu_torch.core.camera import Camera
    from fypraytracer_tpu_torch.render.renderer import Renderer

    meta = read_meta(path)
    s = dict(meta["settings"])
    s["technique"] = SamplingTechnique(s["technique"])
    s["sky_color"] = tuple(s["sky_color"])
    settings = RenderSettings(**s)
    cam = Camera(**meta["camera"])
    state = torch.load(os.path.join(path, "state.pt"), weights_only=True)

    r = (renderer_cls or functools.partial(Renderer, device=device))(scene, cam, settings)
    saved = meta.get("renderer", {})
    if saved.get("class") is not None and saved["class"] != type(r).__name__:
        raise ValueError(f"checkpoint was written by {saved['class']}, not {type(r).__name__}: restoring "
                         "across renderer implementations mixes incompatible state layouts")
    for option in ("final_vis", "mono"):
        want, have = saved.get(option), getattr(r, option, None)
        if want is not None and have is not None and bool(want) != bool(have):
            raise ValueError(f"checkpoint used {option}={want}; resuming with {option}={have} would blend two "
                             "GI estimators into one accumulation buffer")
    r.accum = state["accum"].to(r.device)
    r.frame_index = int(state["frame_index"])
    r.camera.prev_view = state["prev_view"].numpy()
    r.camera.prev_projection = state["prev_projection"].numpy()
    if getattr(r, "aux_state", None) is not None:
        r.aux_state = _tree_to(state["aux_state"], r.device)
    for name in ("state", "stage"):
        if "mk_" + name in state:
            setattr(r, name, state["mk_" + name].to(r.device))
    return r
