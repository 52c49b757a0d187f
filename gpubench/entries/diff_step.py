"""Inverse rendering through ``DiffRenderer.step``.

Set-up builds the configuration's scene with the port's own builders, a
``DiffRenderer`` on it, and from the seed (a ``torch.Generator`` on the
device) the initial material albedos in [0.2, 0.8) and a target image in
[0, 0.5).  It then drives that same renderer and albedo through the
window's own loop for the checked steps, each on its own frame (its own
paths); those steps build the kernel on a checkout's first run and are the
warm-up.  The window goes on from there: one step an update, the new
albedo clamped to the traffic's bounds as the port's own training loop
clamps it (``app/cli.py``), the loss read to the host every
``loss_every`` steps as a training loop logs it, the host free to run
ahead in between.  The window keeps a reference to the albedo, the loss
and the frame of its last checked steps (``step`` returns new tensors, so
this copies nothing and waits for nothing).

The check runs the plain reference's clamped SGD over the same frames
twice: from the seed's albedo over the set-up's steps (``start``), and
from the albedo that the window's last checked steps began with, the
program's own state, over those steps (``window``).  Each compares every
step's loss, the first gradient (the program's worked out from its albedo
after one step, ``(a0 - a1) / lr``) and the change over the steps, both by
their worst leaf (``gaps``).
"""

from __future__ import annotations

import collections
import sys

import torch

from gpubench.reference import diff, scenes
from gpubench.seeds import frame0_of

CALL_SPAN = "step"
TECHNIQUES = ("COSINE",)     # what the plain reference (reference/diff.py) implements


def refuse_unknown(tr: dict):
    if tr["technique"] not in TECHNIQUES:
        raise ValueError(f"diff_step: no plain reference for technique {tr['technique']!r}")


def inputs(seed: int, n_mats: int, n_pixels: int, device):
    """``(albedo (M, 3), target (P, 3))`` drawn from the seed on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    albedo = 0.2 + 0.6 * torch.rand((n_mats, 3), generator=g, device=device)
    target = 0.5 * torch.rand((n_pixels, 3), generator=g, device=device)
    return albedo, target


Kept = collections.namedtuple("Kept", "frame albedo new loss")


class Program:
    unit = "step"
    units_per_update = 1

    def __init__(self, cell, seed, device, rec):
        from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
        from fypraytracer_tpu_torch.render.megakernel_diff import DiffRenderer
        from fypraytracer_tpu_torch.scene import procedural

        tr, cfg = cell.traffic, cell.config
        refuse_unknown(tr)
        with rec.span("scene_build"):
            builder, cam = getattr(procedural, cfg["scene"])(tr["width"], tr["height"])
            scene = builder.compile(native=cfg["native_builder"])
            if cfg["morton"]:
                scene = morton_permuted_scene(scene)[0]
        with rec.span("upload"):
            self.dr = DiffRenderer(scene, cam, bounces=tr["bounces"], sky_color=tuple(tr["sky"]), device=device)
        self.lr, self.every, self.bounds = tr["lr"], tr["loss_every"], tuple(tr["clamp"])
        self.min_updates = tr["checked_steps"]
        self.albedo, self.target = inputs(seed, scene.materials.albedo.shape[0], tr["width"] * tr["height"],
                                          device)
        self.frame = frame0_of(seed)
        self.kept = collections.deque(maxlen=tr["checked_steps"])
        with rec.span("warmup"):
            for _ in range(tr["checked_steps"]):
                self.advance(rec)
        self.start = self.judged()
        self.steps = 0

    def advance(self, rec):
        """One step of the training loop, its inputs and outputs kept."""
        with rec.span(CALL_SPAN):
            new, loss = self.dr.step(self.albedo, self.target, self.frame, lr=self.lr)
        new = torch.clamp(new, *self.bounds)
        self.kept.append(Kept(self.frame, self.albedo, new, loss))
        self.albedo = new
        self.frame += 1
        return loss

    def update(self, rec):
        loss = self.advance(rec)
        self.steps += 1
        if self.steps % self.every == 0:
            with rec.span("loss_readback"):
                loss.item()

    def judged(self) -> dict:
        """The kept steps, on the host: their first frame, the albedo the
        first began with, each one's loss and new albedo, and the target."""
        k = list(self.kept)
        return dict(frame0=k[0].frame, albedo0=k[0].albedo.double().cpu(), losses=[float(s.loss) for s in k],
                    albedos=[s.new.double().cpu() for s in k], target=self.target.cpu())

    def collect(self) -> dict:
        return dict(start=self.start, window=self.judged())


def setup(cell, seed, device, rec) -> Program:
    return Program(cell, seed, device, rec)


def reference_steps(cell, judged, device, dtype=torch.float32):
    """The plain reference's losses, albedos and gradients over the judged
    steps, from the judged steps' first albedo (``diff.sgd``)."""
    tr = cell.traffic
    refuse_unknown(tr)
    scene, cam = scenes.build(cell.config, tr["width"], tr["height"])
    frames = [judged["frame0"] + k for k in range(len(judged["losses"]))]
    return diff.sgd(scene.to(device, dtype), cam, judged["albedo0"], judged["target"].to(device), frames,
                    tr["bounces"], tr["sky"], tr["lr"], tuple(tr["clamp"]))


def leaf_gaps(prog, ref, keep) -> torch.Tensor:
    """Per kept leaf (a material's albedo row): the gap between the
    program's norm and the reference's, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    pn, rn = prog.norm(dim=1)[keep], ref.norm(dim=1)[keep]
    floor = rn.median()
    return (pn - rn).abs() / torch.maximum(rn, floor)


def gaps(judged, ref_losses, ref_albedos, ref_grads, lr: float) -> dict:
    """The numbers compared, each against the reference's: ``loss_gap``,
    every step's loss, relative, the worst; ``grad_gap``, the first
    gradient (the program's worked out from its albedo after one step) by
    its worst leaf; ``change_gap``, the albedo's change over the steps by
    its worst leaf (``leaf_gaps``).  Leaves whose reference gradient (before
    the clamp) is under a thousandth of the median leaf's are left out: the
    light's albedo, which no path reads."""
    a0 = judged["albedo0"]
    g_prog = (a0 - judged["albedos"][0]) / lr
    g_ref = (ref_albedos[0] - ref_albedos[1]) / lr
    rn = ref_grads[0].norm(dim=1)
    keep = rn >= 1e-3 * rn.median()
    change = leaf_gaps(judged["albedos"][-1] - a0, ref_albedos[-1] - ref_albedos[0], keep)
    return {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(judged["losses"], ref_losses)),
            "grad_gap": worst(leaf_gaps(g_prog, g_ref, keep)),
            "change_gap": worst(change)}


def worst(gaps: torch.Tensor) -> float:
    """The largest gap; no number (NaN) where no leaf could be compared."""
    return float(gaps.max()) if gaps.numel() else float("nan")


def stage_gaps(cell, judged, device, dtype=torch.float32) -> dict:
    """``gaps`` of one stage's kept steps against the reference run from
    the same albedo over the same frames."""
    losses, albedos, grads = reference_steps(cell, judged, device, dtype)
    print(f"frames {judged['frame0']}+: losses program {judged['losses']}, reference {losses}", file=sys.stderr)
    return gaps(judged, losses, albedos, grads, cell.traffic["lr"])


def check(cell, seed, judged, device, dtype=torch.float32) -> dict:
    limits = cell.data["check"]["limits"]
    out = {}
    for stage in ("start", "window"):
        for k, v in stage_gaps(cell, judged[stage], device, dtype).items():
            out[f"{stage}.{k}"] = {"value": v, "limit": limits[f"{stage}.{k}"]}
    return out


def count(cell, sample) -> dict:
    """K8's frozen work a launch (``gpubench/count/``): one cosine frame of
    the whole image, its walks counted on the sample's pixels."""
    from gpubench.count.count import rays_per_frame

    tr = cell.traffic
    refuse_unknown(tr)
    W, H = tr["width"], tr["height"]
    for f in sample.frames:
        diff.render(sample.scene, sample.scene.materials.albedo, sample.camera, sample.ids, f, tr["bounces"],
                    tr["sky"], sample.trace)
    n_tri = sample.host.geometry.tri_v.shape[0]
    return {"k8": sample.frozen(frames=1, rays_formula=rays_per_frame(W, H, 1, tr["bounces"]),
                                written=W * H * 3 * 4 + n_tri * 3 * 4 + 4, light_tree=False)}   # target read, d_tri, loss
