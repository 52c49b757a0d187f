"""K2's prepared launch (``render/megakernel.py``: ``PreparedK2``,
``K2Launcher``) on the CPU, with recording stand-ins for its C entries.

``MegakernelRenderer.render_many`` keeps one launch prepared while it fits:
these tests take it through the card's path on CPU tensors (``_runs_plain``
and ``kernels.load`` stood in for) and hold what it hands the C entries to
what a launch prepared afresh on the same inputs hands them, after each
change that must reach the kernel: a camera moved (``move_to``, ``fly``),
other settings, a new scene through ``SceneManager.apply``, and a frame
count with another lane count.  Unchanged calls prepare nothing and upload
no camera.  The card tests hold the images themselves
(``tests/test_torch_cuda.py``).
"""

import ctypes

import numpy as np
import pytest

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.ops import kernels
from fypraytracer_tpu_torch.render import megakernel as mk
from fypraytracer_tpu_torch.scene.manager import SceneManager
from fypraytracer_tpu_torch.scene.procedural import cornell_box

W, H = 16, 8
SETTINGS = RenderSettings(technique=SamplingTechnique.NEE_MIS, bounces=2, samples=1, sky_color=(0.05, 0.06, 0.08))


class FakeEntries:
    """``kernels.load`` for the megakernel library: the packing entry
    records its arguments, the launch entry the block's arguments as they
    stand at the launch, with the frames, and zeroes the output."""

    def __init__(self):
        self.packs = {}          # block address: the last packing call's arguments
        self.n_packs = 0
        self.launches = []       # (packing arguments, frame0, n_frames)

    def load(self, name, symbol, argtypes):
        assert name == "megakernel"
        return {"fyp_megakernel_prepared_bytes": lambda: 100, "fyp_megakernel_prepare": self.prepare,
                "fyp_megakernel_launch": self.launch}[symbol]

    def prepare(self, *args):
        assert len(args) == len(mk._PREPARE_ARGTYPES)
        self.packs[args[-1].value] = args
        self.n_packs += 1
        return 0

    def launch(self, block, frame0, n_frames, out, stream):
        args = self.packs[block.value]
        ctypes.memset(out, 0, args[6] * 3 * 4)
        self.launches.append((args, frame0, n_frames))
        return 0


@pytest.fixture
def fake(monkeypatch):
    entries = FakeEntries()
    monkeypatch.setattr(mk, "_runs_plain", lambda scene: False)
    monkeypatch.setattr(kernels, "load", entries.load)
    monkeypatch.setattr(kernels, "check_inputs", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "stream_ptr", lambda dev: ctypes.c_void_p(None))
    return entries


def resolved(args, prep):
    """The packing arguments with the prepared launch's own tensors (the
    camera and the emission table) read as values and its block as a
    name; every other pointer is the scene's tensor's address."""
    own = {prep.cam.data_ptr(): ("cam", prep.cam.tolist()), prep.emission.data_ptr(): ("emission",
                                                                                        prep.emission.tolist())}
    out = []
    for a in args[:-1]:
        if isinstance(a, ctypes.c_void_p):
            a = own.get(a.value, a.value)
        out.append(a)
    return out + ["block"]


def fresh_args(fake, renderer, n_frames):
    """What a launch prepared afresh, by a new launcher, hands the kernel
    for ``renderer``'s next call."""
    fresh = mk.K2Launcher()
    fresh(renderer.scene, renderer.camera, 0, n_frames, renderer.settings, mk.k2_lanes(n_frames), 0, W * H)
    return resolved(fake.launches.pop()[0], fresh.prepared)


def move_to(r, manager):
    r.camera.move_to(np.float32([0.1, 1.0, 3.2]), forward=np.float32([0.05, -0.1, -1.0]))


def fly(r, manager):
    assert r.camera.fly(0.05, forward=1.0, yaw_delta=2.0)


def settings(r, manager):
    r.settings = r.settings.replace(bounces=3, sky_color=(0.2, 0.1, 0.0))


def material(r, manager):
    manager.set_material(0, emission_power=2.5, albedo=(0.9, 0.2, 0.1))
    manager.apply(r)


def lanes(r, manager):
    pass                         # the frame count below: 2 frames run 2 lanes, not 4


# (change, frames after it, the builds and camera uploads it adds: the camera
# tensor is the launcher's, kept across builds)
CHANGES = [(move_to, 8, 0, 1), (fly, 8, 0, 1), (settings, 8, 1, 0), (material, 8, 1, 0), (lanes, 2, 1, 0)]


@pytest.mark.parametrize("change, n_frames, builds, uploads", CHANGES, ids=[c[0].__name__ for c in CHANGES])
def test_prepared_launch_passes_what_a_fresh_one_would(fake, change, n_frames, builds, uploads):
    """After each change the renderer's launch hands the kernel what a
    launch prepared afresh on its scene, camera, settings and frame count
    does, and the first frame and frame count of the call; the change
    prepares or uploads only what it must, and the next unchanged call
    nothing."""
    builder, cam = cornell_box(W, H, sphere_res=(4, 6))
    manager = SceneManager(builder, native=False)
    r = mk.MegakernelRenderer(manager.scene, cam, SETTINGS, device="cpu")
    r.render_many(8)
    r.render_many(8)
    assert (r.prepared_builds, r.camera_uploads) == (1, 1)
    change(r, manager)
    frame0 = r.frame_index
    r.render_many(n_frames)
    got, got_frame0, got_frames = fake.launches[-1]
    assert (got_frame0, got_frames) == (frame0, n_frames)
    assert resolved(got, r.k2.prepared) == fresh_args(fake, r, n_frames)
    assert got[1] == mk.k2_lanes(n_frames)
    assert (r.prepared_builds, r.camera_uploads) == (1 + builds, 1 + uploads)
    r.render_many(n_frames)
    assert (r.prepared_builds, r.camera_uploads) == (1 + builds, 1 + uploads)
    assert fake.launches[-1][0] is got and len(fake.launches) == 4


def test_unchanged_calls_prepare_nothing_and_upload_no_camera(fake):
    """Calls with nothing changed reuse the one prepared launch and its
    camera: one packing call, one upload, one launch a call, each call's
    frames after the last's; the accumulator is the launches' sum."""
    builder, cam = cornell_box(W, H, sphere_res=(4, 6))
    r = mk.MegakernelRenderer(builder.compile(), cam, SETTINGS, device="cpu")
    before = mk.megakernel.launches
    for _ in range(5):
        r.render_many(8)
    assert (r.prepared_builds, r.camera_uploads) == (1, 1)
    assert fake.n_packs == 1 and mk.megakernel.launches == before + 5
    assert [(f0, n) for _, f0, n in fake.launches] == [(1 + 8 * i, 8) for i in range(5)]
    assert r.k2.prepared.cam.tolist() == np.stack([cam.inv_projection, cam.inv_view]).tolist()
    assert float(r.accum.abs().sum()) == 0.0


def test_one_shot_calls_prepare_every_launch(fake):
    """``megakernel`` without a launcher prepares its launch for that call
    alone, as one-shot callers always did; with one it prepares once a
    slab (``sharded_megakernel_render``'s case), and another slab
    prepares anew."""
    builder, cam = cornell_box(W, H, sphere_res=(4, 6))
    scene = builder.compile().to("cpu")
    for _ in range(3):
        mk.megakernel(scene, cam, 1, 4, SETTINGS)
    assert fake.n_packs == 3
    launcher = mk.K2Launcher()
    for pix0, n_pix in [(0, 64), (0, 64), (64, 64), (64, 64)]:
        mk.megakernel(scene, cam, 1, 4, SETTINGS, pix0=pix0, n_pix=n_pix, launcher=launcher)
    assert (launcher.builds, launcher.camera_uploads) == (2, 1)
    assert [(a[5], a[6]) for a, _, _ in fake.launches[3:]] == [(0, 64), (0, 64), (64, 64), (64, 64)]


def test_camera_upload_compares_values_not_the_object(fake):
    """``Camera`` is mutable: a matrix edited in place is uploaded, an
    equal camera object is not."""
    import copy

    builder, cam = cornell_box(W, H, sphere_res=(4, 6))
    r = mk.MegakernelRenderer(builder.compile(), cam, SETTINGS, device="cpu")
    r.render_many(4)
    r.camera = copy.deepcopy(cam)
    r.render_many(4)
    assert r.camera_uploads == 1
    r.camera.inv_view[0, 3] += 0.25
    r.render_many(4)
    assert r.camera_uploads == 2 and r.k2.prepared.cam[1, 0, 3].item() == r.camera.inv_view[0, 3]
    assert r.prepared_builds == 1
