"""Wavefront renderer — frame orchestration with device-resident state.

The torch counterpart of ``fypraytracer_tpu/render/renderer.py``
(``Renderer::Render``, Renderer.cu:13-284) for all nine techniques: the
scene is uploaded once, camera rays are made on the device from two 4×4
matrices, and the accumulation buffer stays on the device, updated in
place.  A frame of techniques 0-6 is one integrator over all pixels
(``frame_hdr``); ReSTIR DI and GI are stateful: their reservoirs and
G-buffer stay on the device between frames (``render_step_stateful``).  On a CUDA device
every trace is the kernel ``csrc/trace.cu`` (``ops.traverse.pick_tracer``), and
each call reads the walks' stack-overflow flag without waiting
(``ops.traverse.OverflowWatch``).
"""

from __future__ import annotations

import numpy as np
import torch

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.core.camera import Camera, generate_rays
from fypraytracer_tpu_torch.core.color import finalize_pixels, pack_abgr
from fypraytracer_tpu_torch.ops.texture import check_scene_tex
from fypraytracer_tpu_torch.ops.traverse import OverflowWatch, pick_tracer
from fypraytracer_tpu_torch.render import restir_di, restir_gi
from fypraytracer_tpu_torch.render.integrators import (
    radiance_hemisphere,
    radiance_light_source,
    radiance_nee_mis,
)
from fypraytracer_tpu_torch.scene.types import Scene

_SAMPLER_OF = {
    SamplingTechnique.BRUTE_FORCE: "brute",
    SamplingTechnique.UNIFORM: "uniform",
    SamplingTechnique.COSINE: "cosine",
    SamplingTechnique.GGX: "ggx",
    SamplingTechnique.BRDF: "brdf",
}


def frame_hdr(scene: Scene, camera: Camera, frame: int, settings: RenderSettings,
              trace_fn=None):
    """One stateless frame of HDR radiance, (H, W, 3), on the scene's device."""
    w, h = camera.width, camera.height
    pixel_ids = torch.arange(w * h, device=scene.geometry.positions.device)
    return pixels_hdr(scene, camera, frame, settings, pixel_ids, trace_fn).reshape(h, w, 3)


def pixels_hdr(scene: Scene, camera: Camera, frame: int, settings: RenderSettings, pixel_ids,
               trace_fn=None):
    """One stateless frame of HDR radiance at the pixels ``pixel_ids``
    (row-major ids on the scene's device), (n, 3): each pixel's the same
    bits as in the whole frame's, since rays and keys are the pixel's own."""
    w, h = camera.width, camera.height
    origins, directions = generate_rays(camera.inv_projection, camera.inv_view, w, h,
                                        device=pixel_ids.device, pixel_x=pixel_ids % w,
                                        pixel_y=pixel_ids // w)
    trace = trace_fn or pick_tracer(scene)
    tech = settings.technique
    args = (scene, trace, origins, directions, pixel_ids, frame, settings)
    if tech in _SAMPLER_OF:
        hdr = radiance_hemisphere(*args, _SAMPLER_OF[tech])
    elif tech == SamplingTechnique.LIGHT_SOURCE:
        hdr = radiance_light_source(*args)
    elif tech == SamplingTechnique.NEE_MIS:
        hdr = radiance_nee_mis(*args)
    else:
        raise NotImplementedError(f"technique {tech} is stateful: see render_step_stateful")
    return hdr


def render_step_stateful(scene: Scene, camera: Camera, prev_proj_view, frame: int,
                         settings: RenderSettings, state: dict, trace_fn=None):
    """One ReSTIR DI or GI frame (the reference's per-frame kernel pair,
    Renderer.cu:166-224): returns ((H, W, 3) HDR, new state)."""
    dev = scene.geometry.positions.device
    w, h = camera.width, camera.height
    origins, directions = generate_rays(camera.inv_projection, camera.inv_view, w, h, device=dev)
    pixel_ids = torch.arange(w * h, device=dev)
    trace = trace_fn or pick_tracer(scene)
    if settings.technique == SamplingTechnique.RESTIR_DI:
        render = restir_di.render_restir_di
    elif settings.technique == SamplingTechnique.RESTIR_GI:
        render = restir_gi.render_restir_gi
    else:
        raise NotImplementedError(f"technique {settings.technique} is not stateful")
    hdr, state = render(scene, trace, origins, directions, pixel_ids, frame, settings, state, w, h,
                        prev_proj_view)
    return hdr.reshape(h, w, 3), state


class Renderer:
    """Owns the per-frame device state (accumulation, frame index).

    Usage::
        r = Renderer(scene, camera, settings, device="cuda")
        img = r.render_frame()         # uint32 ABGR (H, W) on host
    """

    def __init__(self, scene: Scene, camera: Camera, settings: RenderSettings, device="cuda"):
        self.device = torch.device(device)
        self.camera = camera
        self.settings = settings
        self.accum = torch.zeros((camera.height, camera.width, 3), dtype=torch.float32,
                                 device=self.device)
        self.set_scene(scene)

    def set_scene(self, scene: Scene):
        """Render ``scene`` from now on (an edited scene,
        ``scene/manager.py::SceneManager.apply``): the scene is put on the
        device, its overflow watch made anew, and accumulation restarts."""
        self.scene = scene.to(self.device)
        self.overflow = OverflowWatch(self.scene)
        check_scene_tex(self.scene)
        self.reset()

    def _is_stateful(self) -> bool:
        return self.settings.technique in (SamplingTechnique.RESTIR_DI, SamplingTechnique.RESTIR_GI)

    def _init_aux_state(self):
        """Per-pixel reservoir/G-buffer state (ResizeReservoirs etc.,
        Renderer.cu:286-420); None for the stateless techniques."""
        if not self._is_stateful():
            return None
        module = restir_di if self.settings.technique == SamplingTechnique.RESTIR_DI else restir_gi
        return module.init_state(self.camera.width * self.camera.height, self.device)

    def reset(self):
        """ResetFrameIndex + clear accumulation (Renderer.h:46)."""
        self.frame_index = 1
        self.accum.zero_()
        self.aux_state = self._init_aux_state()

    def resize(self, width: int, height: int):
        """OnResize (Renderer.cpp:5-41): reallocate buffers, restart."""
        self.camera.resize(width, height)
        self.accum = torch.zeros((height, width, 3), dtype=torch.float32, device=self.device)
        self.frame_index = 1
        self.aux_state = self._init_aux_state()

    def _frame(self, frame: int, prev_proj_view) -> torch.Tensor:
        """HDR of frame ``frame``; a stateful technique advances its state."""
        if not self._is_stateful():
            return frame_hdr(self.scene, self.camera, frame, self.settings)
        hdr, self.aux_state = render_step_stateful(self.scene, self.camera, prev_proj_view, frame,
                                                   self.settings, self.aux_state)
        return hdr

    def render_hdr(self) -> torch.Tensor:
        """Render one frame; returns the running-average HDR image."""
        self.overflow.poll()
        hdr = self._frame(self.frame_index, self.camera.prev_proj_view)
        if self.settings.accumulate:
            self.accum += hdr
            avg = self.accum / float(self.frame_index)
            self.frame_index += 1
        else:
            self.accum.copy_(hdr)
            avg = self.accum.clone()
            self.frame_index = 1
        self.camera.commit_frame()
        self.overflow.queue()
        return avg

    def render_many(self, n_frames: int) -> torch.Tensor:
        """Accumulate ``n_frames`` frames and return the running-average
        HDR image (the offline-rendering path)."""
        assert self.settings.accumulate, "render_many requires accumulation"
        self.overflow.poll()
        ppv = self.camera.prev_proj_view      # every frame of the call, as the JAX renderer
        for i in range(n_frames):
            self.accum += self._frame(self.frame_index + i, ppv)
        self.frame_index += n_frames
        self.camera.commit_frame()
        self.overflow.queue()
        return self.accum / float(self.frame_index - 1)

    def render_frame(self) -> np.ndarray:
        """Render + tonemap + pack: host uint32 ABGR (H, W).  The image is
        read on the host, so the overflow flag is read there too."""
        rgb = finalize_pixels(self.render_hdr(), 1.0)
        img = pack_abgr(rgb).cpu().numpy().astype(np.uint32)
        self.overflow.check()
        return img
