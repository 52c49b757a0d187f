"""Progressive rendering through ``MegakernelRenderer.render_many``.

Set-up builds the configuration's scene with the port's own builders,
puts it on the device in a ``MegakernelRenderer`` and warms up the one
shape the window uses (``render_many(frames_per_update)``, which builds
the kernel library on a checkout's first run).  The accumulator is then
cleared and the renderer starts at a frame index drawn from the seed: the
port keys every random draw on (pixel, frame, sample, stream), so the seed
changes the paths and not the work.  An update is one
``render_many(frames_per_update)`` ended by a synchronize: a closed loop,
as an interactive preview waits for each image.

The check compares the renderer's accumulator (the sum of every frame
rendered in the window) at pixels drawn from the seed with the plain
reference's sum over the same frames.  ``render_many`` divides it by its
frame index less one, which counts frames only from index 1, so the
returned average itself is not what is compared.
"""

from __future__ import annotations

import torch

from gpubench.reference import nee, scenes
from gpubench.seeds import frame0_of

CALL_SPAN = "render_many"
REFERENCES = {"NEE_MIS": nee}      # technique: its plain reference in gpubench/reference/


def reference_of(tr: dict):
    """The plain reference of the traffic's technique; any other is refused."""
    if tr["technique"] not in REFERENCES:
        raise ValueError(f"render_many: no plain reference for technique {tr['technique']!r}")
    return REFERENCES[tr["technique"]]


def sample_pixels(seed: int, n_pixels: int, count: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n_pixels, generator=g)[:count]


class Program:
    unit = "frame"

    def __init__(self, cell, seed, device, rec):
        from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
        from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer, morton_permuted_scene
        from fypraytracer_tpu_torch.scene import procedural

        tr, cfg = cell.traffic, cell.config
        reference_of(tr)
        self.units_per_update = tr["frames_per_update"]
        with rec.span("scene_build"):
            builder, cam = getattr(procedural, cfg["scene"])(tr["width"], tr["height"])
            scene = builder.compile(native=cfg["native_builder"])
            if cfg["morton"]:
                scene = morton_permuted_scene(scene)[0]
        settings = RenderSettings(technique=SamplingTechnique[tr["technique"]], bounces=tr["bounces"],
                                  samples=tr["samples"], sky_color=tuple(tr["sky"]))
        with rec.span("upload"):
            self.mk = MegakernelRenderer(scene, cam, settings, device=device)
        with rec.span("warmup"):
            for _ in range(tr["warmup_updates"]):
                self.mk.render_many(self.units_per_update)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        self.mk.reset()
        self.frame0 = frame0_of(seed)
        self.mk.frame_index = self.frame0
        self.device = device

    def update(self, rec):
        with rec.span(CALL_SPAN):
            self.mk.render_many(self.units_per_update)
        with rec.span("synchronize"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def collect(self) -> dict:
        return dict(accum=self.mk.accum.detach().double().cpu(), frame0=self.frame0,
                    n_frames=self.mk.frame_index - self.frame0)


def setup(cell, seed, device, rec) -> Program:
    return Program(cell, seed, device, rec)


def reference_sums(cell, seed, pixels, frame0, n_frames, device, dtype=torch.float32):
    """The plain reference's (P, 3) sums at ``pixels`` over the frames."""
    tr = cell.traffic
    ref = reference_of(tr)
    scene, cam = scenes.build(cell.config, tr["width"], tr["height"])
    return ref.pixel_sums(scene.to(device, dtype), cam, pixels, frame0, n_frames, tr).cpu()


def gaps(prog_sums: torch.Tensor, ref_sums: torch.Tensor) -> dict:
    """The numbers compared, both float64 (P, 3): the whole sample's
    relative gap, and the widest pixel's gap (summed over its channels)
    against the mean pixel's sum, so that a dark pixel is not judged on
    its rounding alone."""
    total = ref_sums.sum().item()
    per_px = (prog_sums - ref_sums).abs().sum(1)
    mean_px = ref_sums.sum(1).abs().mean().item()
    return {"sum_gap": abs(prog_sums.sum().item() - total) / max(abs(total), 1e-30),
            "px_gap": per_px.max().item() / max(mean_px, 1e-30)}


def check(cell, seed, judged, device, dtype=torch.float32) -> dict:
    tr = cell.traffic
    pixels = sample_pixels(seed, tr["width"] * tr["height"], cell.data["check"]["pixels"])
    ref = reference_sums(cell, seed, pixels, judged["frame0"], judged["n_frames"], device, dtype)
    got = gaps(judged["accum"][pixels], ref)
    limits = cell.data["check"]["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in got.items()}


def count(cell, sample) -> dict:
    """K2's frozen work a launch (``gpubench/count/``): ``frames_per_update``
    frames of the whole image, their walks counted on the sample's pixels
    by the technique's plain reference."""
    from gpubench.count.count import rays_per_frame
    from gpubench.reference.camera import generate_rays

    tr = cell.traffic
    ref = reference_of(tr)
    W, H, cam = tr["width"], tr["height"], sample.camera
    for f in sample.frames:
        o, d = generate_rays(cam.inv_projection, cam.inv_view, W, H, pixel_x=sample.ids % W,
                             pixel_y=sample.ids // W)
        ref.radiance(sample.scene, sample.trace, o, d, sample.ids, f, tr["bounces"], tr["samples"], tr["sky"])
    frames = tr["frames_per_update"]
    formula = rays_per_frame(W, H, tr["samples"], tr["bounces"], shadow_rays_per_bounce=1) * frames
    return {"k2": sample.frozen(frames=frames, rays_formula=formula, written=W * H * 3 * 4, light_tree=True)}
