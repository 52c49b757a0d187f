"""The check that decides ``correct`` fails where it must: its control (the
plain reference in bfloat16) fails each cell's limits, and a run driven
with the timed path broken underneath comes out not correct, once for each
fault the cell can have.  CPU, tiny sizes: the port's plain versions stand
in for its kernels here, so sound runs read (nearly) nothing."""

from unittest import mock

import pytest
import torch

from gpubench import control, run
from gpubench.entries import diff_step, render_many
from gpubench.reference import scenes
from gpubench.reference.bvh import tree

SIZE = (16, 8)
CPU = torch.device("cpu")


def tiny(name):
    cell = run.Cell.find(name, control.bench_with_held_out())
    cell.traffic = dict(cell.traffic, width=SIZE[0], height=SIZE[1])
    return cell


def failed_limits(cell, got):
    limits = cell.data["check"]["limits"]
    return [k for k in limits if not got[k] <= limits[k]]


def test_render_control_fails():
    cell = tiny("cornell-nee-1080p")
    pixels = render_many.sample_pixels(9, SIZE[0] * SIZE[1], cell.data["check"]["pixels"])
    ref = render_many.reference_sums(cell, 9, pixels, 1000, 16, CPU)
    low = render_many.reference_sums(cell, 9, pixels, 1000, 16, CPU, torch.bfloat16)
    assert failed_limits(cell, render_many.gaps(low, ref))


def test_train_control_fails():
    cell = tiny("cornell-train-1080p")
    albedo, target = diff_step.inputs(9, 6, SIZE[0] * SIZE[1], CPU)
    judged = dict(frame0=77, albedo0=albedo.double(), target=target, losses=[0.0] * 2)
    ref = diff_step.reference_steps(cell, judged, CPU)
    low_l, low_a, _ = diff_step.reference_steps(cell, judged, CPU, torch.bfloat16)
    got = diff_step.gaps(dict(judged, losses=low_l, albedos=low_a[1:]), *ref, cell.traffic["lr"])
    limits = cell.data["check"]["limits"]
    for stage in ("start", "window"):
        assert [k for k, v in got.items() if not v <= limits[f"{stage}.{k}"]]


def run_tiny(name, seed=21):
    return run.run_cell(name, seed, 0.3, False, "cpu", size=SIZE, bench=control.bench_with_held_out())


def late(fn, sound_calls):
    """``fn``'s fault from call ``sound_calls + 1`` on: the set-up's calls
    (the warm-up, and the training start's checked steps) run sound."""
    calls = [0]

    def wrapped(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw) if calls[0] > sound_calls else fn.sound(*a, **kw)
    return wrapped


def test_sound_runs_are_correct():
    assert run_tiny("cornell-nee-1080p")["correct"]
    assert run_tiny("cornell-train-1080p")["correct"]


def _half_frames(original):
    def k(scene, camera, frame0, n_frames, settings, **kw):
        return original(scene, camera, frame0, max(n_frames // 2, 1), settings, **kw) * 2.0
    return k


def _altered(original):
    def k(*a, **kw):
        return original(*a, **kw) * 1.01
    return k


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "altered_after_warmup"])
def test_render_faults_are_caught(fault):
    import fypraytracer_tpu_torch.render.megakernel as mk

    sound = mk.megakernel
    if fault == "unchanged":
        def broken(scene, camera, f0, n, s, **kw):
            return torch.zeros((camera.width * camera.height, 3))
    else:
        broken = (_half_frames if fault == "half_batch" else _altered)(sound)
    if fault.endswith("_after_warmup"):
        broken.sound = sound
        broken = late(broken, run.Cell.find("cornell-nee-1080p").traffic["warmup_updates"])
    with mock.patch.object(mk, "megakernel", broken):
        out = run_tiny("cornell-nee-1080p")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "unchanged_after_warmup",
                                   "altered_after_warmup", "stale_after_warmup"])
def test_train_faults_are_caught(fault):
    """Each fault a training step can have comes out not correct, also where
    it begins only in the window, after the set-up's checked steps: such as
    a step replayed on the albedo it was first given (a graph captured in
    warm-up)."""
    from fypraytracer_tpu_torch.render.megakernel_diff import DiffRenderer

    cell = tiny("cornell-train-1080p")
    host, cam = scenes.build(cell.config, *SIZE)
    scene = host.to(CPU)
    bvh = tree(scene.geometry)
    sound = DiffRenderer.step
    first = []

    def step(self, albedo, target, frame, lr=0.2):
        kind = fault.removesuffix("_after_warmup")
        if kind == "unchanged":
            return albedo, torch.tensor(1.0)
        if kind == "stale":
            return sound(self, first[-1], target, frame, lr=lr)
        new, loss, _ = control.planted_step(scene, cam, bvh, albedo, target, frame, cell.traffic, kind)
        return new, torch.tensor(loss)

    def remember(self, albedo, *a, **kw):
        first.append(albedo)
        return sound(self, albedo, *a, **kw)

    step.sound = remember
    broken = late(step, cell.traffic["checked_steps"]) if fault.endswith("_after_warmup") else step
    with mock.patch.object(DiffRenderer, "step", broken):
        out = run_tiny("cornell-train-1080p")
    assert out["correct"] is False, out["checks"]
    if fault.endswith("_after_warmup"):
        assert all(c["value"] <= c["limit"] for k, c in out["checks"].items() if k.startswith("start."))


def test_planted_step_without_fault_is_the_reference():
    """The fault planting is the reference's own step where nothing is planted."""
    cell = tiny("cornell-train-1080p")
    host, cam = scenes.build(cell.config, *SIZE)
    scene = host.to(CPU)
    albedo, target = diff_step.inputs(4, 6, SIZE[0] * SIZE[1], CPU)
    new, loss, grad = control.planted_step(scene, cam, tree(scene.geometry), albedo, target, 5, cell.traffic,
                                           "none")
    judged = dict(frame0=5, albedo0=albedo.double(), target=target, losses=[0.0])
    ref_l, ref_a, ref_g = diff_step.reference_steps(cell, judged, CPU)
    assert abs(loss - ref_l[0]) <= 1e-6 * abs(ref_l[0])
    assert torch.allclose(new.double(), ref_a[1], rtol=0, atol=1e-7)
    assert torch.allclose(grad.double(), ref_g[0], rtol=0, atol=1e-7)
