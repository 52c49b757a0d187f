"""The port's app surface: CLI commands, scene files, OBJ loader,
provenance and checkpoints, on the CPU (plain PyTorch versions).

The cases of tests/test_app.py on the port, then the port against the JAX
package on the same inputs (OBJ arrays, a scene file's compiled scene,
the CLI's image), then what the port does that the JAX package does not:
a checkpoint records ``mono`` and refuses the other GI mode, and a failing
megakernel inside ``cli render`` raises instead of re-rendering on the
wavefront.  Last, a guard that no file of the port imports JAX.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from fypraytracer_tpu_torch.scene.objloader import load_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CUBE_OBJ = """
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
f 1 2 3 4
f 5 8 7 6
f 1 5 6 2
f 3 7 8 4
f 2 6 7 3
f 1 4 8 5
"""

UV_OBJ = """
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0.5
vt 0 0
vt 1 0
vt 0 1
vt 1 1
vn 0 0 1
vn 0 0.6 0.8
f 1/1/1 2/2/1 3/3/1
f 2/2/2 4/4/2 3/3/2
f -1/-1/-1 -3/-3/-1 -2/-2/-1
"""


def _records(text):
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def _cli(*args):
    from fypraytracer_tpu_torch.app.cli import main

    main([*args, "--device", "cpu"])


# -- the cases of tests/test_app.py -------------------------------------------


def test_obj_loader_cube(tmp_path):
    obj = tmp_path / "cube.obj"
    obj.write_text(CUBE_OBJ)
    pos, tri, nrm, uv = load_obj(str(obj))
    assert tri.shape == (12, 3)  # 6 quads fan-triangulated
    assert nrm is None and uv is None
    # z-flip applied
    assert pos[:, 2].min() == -1.0 and pos[:, 2].max() == 1.0


def test_obj_loader_with_uv_normals(tmp_path):
    obj = tmp_path / "t.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\nvn 0 0 1\nf 1/1/1 2/2/1 3/3/1\n")
    pos, tri, nrm, uv = load_obj(str(obj))
    assert pos.shape == (3, 3)
    np.testing.assert_allclose(nrm[0], [0, 0, -1])  # z-flipped normal
    np.testing.assert_allclose(uv[:, 1], [1, 1, 0])  # FlipUVs


SCENE_SPEC = {
    "materials": [
        {"name": "w", "albedo": [0.7, 0.7, 0.7]},
        {"name": "l", "emission_color": [1, 1, 1], "emission_power": 3.0},
    ],
    "meshes": [
        {"type": "quad", "material": "w", "size": [2, 2]},
        {"type": "sphere", "material": "w", "radius": 0.4, "rows": 4, "cols": 6, "position": [0, 0.4, 0]},
        {"type": "quad", "material": "l", "position": [0, 2, 0], "rotation": [180, 0, 0]},
    ],
    "camera": {"position": [0, 1, 3], "width": 32, "height": 32},
}


def test_scene_json_roundtrip(tmp_path):
    from fypraytracer_tpu_torch.scene.sceneio import load_scene_file

    p = tmp_path / "scene.json"
    p.write_text(json.dumps(SCENE_SPEC))
    builder, cam = load_scene_file(str(p))
    scene = builder.compile()
    assert scene.num_triangles == 2 + 4 * 6 * 2 + 2
    assert scene.num_emissive == 2
    assert cam.width == 32


def test_cli_render_end_to_end(tmp_path):
    out = tmp_path / "out"
    _cli("render", "--scene", "cornell-empty", "--width", "32", "--height", "32", "--technique", "cosine",
         "--frames", "2", "-o", str(out))
    files = os.listdir(out)
    assert any(f.endswith(".bmp") for f in files)
    assert any(f.endswith(".png") for f in files)
    sidecars = [f for f in files if f.endswith(".json")]
    assert sidecars
    rec = json.load(open(out / sidecars[0]))
    assert rec["settings"]["technique"] == "COSINE"


def test_cli_benchmark_two_techniques(tmp_path):
    out = tmp_path / "bench"
    _cli("benchmark", "--scene", "cornell-empty", "--width", "24", "--height", "24", "--techniques", "cosine,nee",
         "--frames", "2", "--golden-frames", "4", "-o", str(out))
    rows = json.load(open(out / "benchmark.json"))
    assert {r["technique"] for r in rows} == {"cosine", "nee"}
    assert all(np.isfinite(r["psnr"]) or r["mse"] == 0 for r in rows)


def test_burst_run_protocol():
    """_burst_run: short dispatches + idle sleeps; reports the fastest rep
    net of host overhead and accumulates the full frame budget."""
    from fypraytracer_tpu_torch.app.cli import _burst_run

    class FakeMK:
        def __init__(self):
            self.calls = []

        def render_many(self, n):
            self.calls.append(n)
            return torch.ones((8, 8, 3), dtype=torch.float32)

    mk = FakeMK()
    avg, done, ms = _burst_run(mk, frames=8, burst=2, reps=2, idle=0.0)
    assert mk.calls == [2, 2, 2, 2]          # warm + 3 timed reps
    assert done == 8
    assert np.isfinite(ms) and ms >= 0.0
    assert avg.shape == (8, 8, 3)


def test_cli_burst_requires_frames():
    """--burst with a seconds budget must error, not report non-burst
    wavefront timings as the burst protocol."""
    with pytest.raises(SystemExit, match="frames"):
        _cli("benchmark", "--scene", "cornell-empty", "--width", "24", "--height", "24", "--techniques", "cosine",
             "--seconds", "1", "--burst", "8", "--golden-frames", "0")


def test_cli_benchmark_timing_only(tmp_path):
    """--golden-frames 0 skips the golden render and PSNR columns."""
    out = tmp_path / "bench"
    _cli("benchmark", "--scene", "cornell-empty", "--width", "24", "--height", "24", "--techniques", "cosine",
         "--frames", "2", "--golden-frames", "0", "-o", str(out))
    rows = json.load(open(out / "benchmark.json"))
    assert rows[0]["technique"] == "cosine"
    assert "psnr" not in rows[0]
    assert not os.path.exists(out / "golden.png")


def test_cli_train_reduces_loss(capsys):
    _cli("train", "--scene", "cornell-empty", "--width", "16", "--height", "16", "--bounces", "1", "--steps", "6",
         "--lr", "0.3")
    lines = _records(capsys.readouterr().out)
    losses = [r["loss"] for r in lines if "loss" in r]
    assert losses[-1] < losses[0]
    assert np.isfinite(lines[-1]["final_albedo_mae"])


@pytest.mark.parametrize("move", [False, True], ids=["static", "moved"])
def test_checkpoint_roundtrip(tmp_path, move):
    """``Renderer`` under ReSTIR DI: accumulation, frame index and the
    wavefront's reservoir state round-trip, and the resumed render equals
    the uninterrupted one bit for bit, also where the camera moved just
    before the save (the next frame reprojects through the previous
    matrices, which the checkpoint keeps)."""
    from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu_torch.render.renderer import Renderer
    from fypraytracer_tpu_torch.scene.procedural import cornell_box
    from fypraytracer_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    builder, cam = cornell_box(width=16, height=16, with_spheres=False)
    scene = builder.compile()
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_DI, light_candidates=2, spatial_neighbors=2,
                              spatial_radius=4)
    r = Renderer(scene, cam, settings, device="cpu")
    for _ in range(3):
        r.render_hdr()
    if move:
        r.camera.move_to((0.05, 1.05, 2.5))

    ck = tmp_path / "ckpt"
    save_checkpoint(str(ck), r)
    r2 = load_checkpoint(str(ck), scene, device="cpu")
    assert r2.frame_index == r.frame_index
    assert torch.equal(r2.accum, r.accum)

    def leaves(tree):
        return [x for v in tree.values() for x in leaves(v)] if isinstance(tree, dict) else [tree]

    assert all(torch.equal(a, b) for a, b in zip(leaves(r.aux_state), leaves(r2.aux_state)))

    for _ in range(2):
        a, b = r.render_hdr(), r2.render_hdr()
    assert torch.equal(a, b)


def test_checkpoint_roundtrip_megakernel_restir_gi(tmp_path):
    """``MegakernelReSTIRGI`` (mono): accumulation, frame index and the
    state and stage planes round-trip; the resumed render continues bit
    for bit."""
    from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu_torch.render.megakernel_restir_gi import MegakernelReSTIRGI
    from fypraytracer_tpu_torch.scene.procedural import cornell_box
    from fypraytracer_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    builder, cam = cornell_box(width=32, height=32, with_spheres=False)
    scene = builder.compile()
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_GI, bounces=2, spatial_neighbors=2,
                              spatial_radius=4)
    mk = MegakernelReSTIRGI(scene, cam, settings, device="cpu")
    mk.render_many(4)

    ck = tmp_path / "ckpt_mk"
    save_checkpoint(str(ck), mk)
    mk2 = load_checkpoint(str(ck), scene, renderer_cls=lambda s, c, st: MegakernelReSTIRGI(s, c, st, device="cpu"))
    assert mk2.frame_index == mk.frame_index
    assert torch.equal(mk2.state, mk.state) and torch.equal(mk2.stage, mk.stage)
    assert torch.equal(mk.render_many(4), mk2.render_many(4))


def test_checkpoint_roundtrip_megakernel_restir_di(tmp_path):
    """``MegakernelReSTIRDI``: accumulation, frame index and the reservoir
    plane round-trip, and the resumed render continues bit for bit."""
    from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
    from fypraytracer_tpu_torch.scene.procedural import cornell_box
    from fypraytracer_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    builder, cam = cornell_box(width=16, height=16)
    scene = builder.compile()
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_DI, light_candidates=4, spatial_neighbors=2,
                              spatial_radius=4)
    mk = MegakernelReSTIRDI(scene, cam, settings, device="cpu")
    mk.render_many(3)
    save_checkpoint(str(tmp_path / "ck"), mk)
    mk2 = load_checkpoint(str(tmp_path / "ck"), scene,
                          renderer_cls=lambda s, c, st: MegakernelReSTIRDI(s, c, st, device="cpu"))
    assert mk2.frame_index == mk.frame_index == 4 and torch.equal(mk2.state, mk.state)
    assert torch.equal(mk.render_many(2), mk2.render_many(2))


def test_cli_render_checkpoint_resume(tmp_path):
    """`cli render --checkpoint-dir`: an interrupted render resumed from its
    checkpoint gives the same image as an uninterrupted run."""
    from fypraytracer_tpu_torch.utils.image import load_png

    out_a, out_b = tmp_path / "a", tmp_path / "b"
    base = ["render", "--scene", "cornell", "--technique", "cosine", "--width", "16", "--height", "16", "--impl",
            "wavefront", "--bounces", "1"]
    _cli(*base, "--frames", "4", "-o", str(out_a), "--checkpoint-dir", str(tmp_path / "ck_a"))
    ck = str(tmp_path / "ck_b")
    _cli(*base, "--frames", "2", "-o", str(tmp_path / "scratch"), "--checkpoint-dir", ck)
    _cli(*base, "--frames", "4", "-o", str(out_b), "--checkpoint-dir", ck)
    a = load_png(str(next(out_a.glob("*.png"))))
    b = load_png(str(next(out_b.glob("*.png"))))
    np.testing.assert_array_equal(a, b)


def test_cli_render_checkpoint_resume_megakernel(tmp_path, capsys):
    """Checkpointed CLI render on the megakernel path: resumed ==
    uninterrupted, and the checkpoint's meta keeps a resume without --impl
    on the megakernel; a finished checkpoint resumed again writes the same
    image from its accumulation."""
    from fypraytracer_tpu_torch.utils.image import load_png

    out_a, out_b, out_c = tmp_path / "a", tmp_path / "b", tmp_path / "c"
    base = ["render", "--scene", "cornell", "--technique", "cosine", "--width", "32", "--height", "32", "--impl",
            "megakernel", "--bounces", "1", "--checkpoint-every", "2"]
    _cli(*base, "--frames", "4", "-o", str(out_a), "--checkpoint-dir", str(tmp_path / "ck_a"))
    ck = str(tmp_path / "ck_b")
    _cli(*base, "--frames", "2", "-o", str(tmp_path / "scratch"), "--checkpoint-dir", ck)
    resume = [a for a in base if a not in ("--impl", "megakernel")]
    capsys.readouterr()
    _cli(*resume, "--frames", "4", "-o", str(out_b), "--checkpoint-dir", ck)
    _cli(*resume, "--frames", "4", "-o", str(out_c), "--checkpoint-dir", ck)
    impls = [r["impl"] for r in _records(capsys.readouterr().out) if "impl" in r]
    assert impls == ["megakernel-ckpt"] * 2
    a = load_png(str(next(out_a.glob("*.png"))))
    for out in (out_b, out_c):
        np.testing.assert_array_equal(load_png(str(next(out.glob("*.png")))), a)


# -- the port against the JAX package on the same inputs ----------------------


@pytest.mark.parametrize("text", [CUBE_OBJ, UV_OBJ], ids=["cube", "uv-normals-negative-ids"])
def test_load_obj_equals_jax(tmp_path, text):
    from fypraytracer_tpu.scene.objloader import load_obj as jload

    obj = tmp_path / "m.obj"
    obj.write_text(text)
    for flip_z in (True, False):
        got, want = load_obj(str(obj), flip_z=flip_z), jload(str(obj), flip_z=flip_z)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_scene_file_compiles_to_jax_scene(tmp_path):
    """A scene file with every mesh type, an OBJ and a BMP texture: the
    port's compile equals JAX ``compile(native=False)``, field by field."""
    from fypraytracer_tpu.scene.sceneio import load_scene_file as jload
    from fypraytracer_tpu_torch.scene.sceneio import load_scene_file
    from fypraytracer_tpu_torch.utils.image import save_bmp
    from test_torch_scene import _assert_scenes_equal

    (tmp_path / "m.obj").write_text(UV_OBJ)
    tex = np.random.default_rng(11).integers(0, 256, (8, 12, 3), dtype=np.uint8)
    save_bmp(str(tmp_path / "t.bmp"), tex)
    spec = json.loads(json.dumps(SCENE_SPEC))
    spec["materials"].append({"name": "t", "texture": "t.bmp", "roughness": 0.3, "metallic": 0.5})
    spec["meshes"] += [{"type": "box", "material": "t", "size": [0.3, 0.5, 0.2], "position": [0.5, 0.2, 0]},
                       {"type": "obj", "material": "t", "path": "m.obj", "scale": [0.5, 0.5, 0.5],
                        "rotation": [10, 20, 30]}]
    spec["camera"].update(forward=[0, -0.2, -1], vfov=50)
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(spec))
    tb, tcam = load_scene_file(str(p))
    jb, jcam = jload(str(p))
    ts, js = tb.compile(), jb.compile(native=False)
    _assert_scenes_equal(ts, js)
    assert ts.tex is not None
    for name in ("inv_projection", "inv_view"):
        np.testing.assert_array_equal(getattr(tcam, name), getattr(jcam, name))


def test_cli_render_image_matches_jax(tmp_path):
    """`render --technique cosine --frames 2` at 32² through both CLIs (both
    the wavefront, both scenes built by the same C++ library): the 8-bit
    images differ by more than one level at fewer than 1% of the pixels
    (the wavefronts' tracers can part on exact ties)."""
    from fypraytracer_tpu.app.cli import main as jmain
    from fypraytracer_tpu_torch.utils.image import load_png

    args = ["render", "--scene", "cornell", "--technique", "cosine", "--width", "32", "--height", "32",
            "--frames", "2"]
    _cli(*args, "-o", str(tmp_path / "port"))
    jmain([*args, "-o", str(tmp_path / "jax")])
    a = load_png(str(next((tmp_path / "port").glob("*.png")))).astype(np.int16)
    b = load_png(str(next((tmp_path / "jax").glob("*.png")))).astype(np.int16)
    off = (np.abs(a - b).max(axis=-1) > 1).mean()
    assert off < 0.01, off
    assert a.mean() > 3


# -- what the port does that the JAX package does not -------------------------


def _gi_checkpoint(tmp_path):
    from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu_torch.render.megakernel_restir_gi import MegakernelReSTIRGI
    from fypraytracer_tpu_torch.scene.procedural import cornell_box
    from fypraytracer_tpu_torch.utils.checkpoint import save_checkpoint

    builder, cam = cornell_box(width=16, height=16, with_spheres=False)
    scene = builder.compile()
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_GI, spatial_neighbors=2, spatial_radius=4)
    mk = MegakernelReSTIRGI(scene, cam, settings, device="cpu", mono=True)
    mk.render_many(2)
    save_checkpoint(str(tmp_path / "ck"), mk)
    return scene, MegakernelReSTIRGI


@pytest.mark.parametrize("mode", [dict(mono=False), dict(mono=True, final_vis=True)], ids=["mono", "final_vis"])
def test_checkpoint_refuses_the_other_gi_mode(tmp_path, mode):
    """A mono, per-neighbour GI checkpoint refuses to resume into
    ``mono=False`` and into ``final_vis``: both keep state and stage of the
    same shape, and either would blend two estimators in one buffer."""
    from fypraytracer_tpu_torch.utils.checkpoint import load_checkpoint, read_meta

    scene, cls = _gi_checkpoint(tmp_path)
    assert read_meta(str(tmp_path / "ck"))["renderer"] == {"class": "MegakernelReSTIRGI", "final_vis": False,
                                                           "mono": True}
    option = "final_vis" if mode.get("final_vis") else "mono"
    with pytest.raises(ValueError, match=option):
        load_checkpoint(str(tmp_path / "ck"), scene, renderer_cls=lambda s, c, st: cls(s, c, st, device="cpu", **mode))
    r = load_checkpoint(str(tmp_path / "ck"), scene, renderer_cls=lambda s, c, st: cls(s, c, st, device="cpu"))
    assert r.mono and r.frame_index == 3


def test_jax_checkpoint_resumes_mono_into_two_kernels(tmp_path):
    """A fault of the reference, pinned: the JAX checkpoint records
    ``final_vis`` but not ``mono`` (utils/checkpoint.py:55-62, 110-122), so
    a mono GI checkpoint resumes into ``mono=False`` without a word and
    the two estimators share one accumulation buffer.  The port refuses
    (test_checkpoint_refuses_the_other_gi_mode)."""
    from fypraytracer_tpu.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu.render.megakernel_restir_gi import MegakernelReSTIRGI
    from fypraytracer_tpu.scene.procedural import cornell_box
    from fypraytracer_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

    builder, cam = cornell_box(width=32, height=32, with_spheres=False)
    scene = builder.compile(native=False)
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_GI, spatial_neighbors=2, spatial_radius=4)
    mk = MegakernelReSTIRGI(scene, cam, settings, interpret=True, mono=True)
    mk.render_many(2)
    save_checkpoint(str(tmp_path / "ck"), mk)
    meta = json.load(open(tmp_path / "ck" / "meta.json"))
    assert "mono" not in meta["renderer"]
    r = load_checkpoint(str(tmp_path / "ck"), scene,
                        renderer_cls=lambda s, c, st: MegakernelReSTIRGI(s, c, st, interpret=True, mono=False))
    assert r.mono is False and r.frame_index == 3
    np.testing.assert_array_equal(np.asarray(r.state), np.asarray(mk.state))


@pytest.mark.parametrize("impl", ["megakernel", "auto"])
def test_cli_render_megakernel_fault_propagates(tmp_path, monkeypatch, impl):
    """A megakernel that raises inside `cli render` propagates: it is not
    re-rendered on the wavefront (the JAX CLI falls back, cli.py:166-174),
    whether asked for or chosen by `auto` (16 frames at 16²)."""
    from fypraytracer_tpu_torch.render import megakernel, renderer

    def broken(self, n_frames):
        raise RuntimeError("injected megakernel fault")

    def no_wavefront(*a, **k):
        raise AssertionError("fell back to the wavefront")

    monkeypatch.setattr(megakernel.MegakernelRenderer, "render_many", broken)
    monkeypatch.setattr(renderer.Renderer, "__init__", no_wavefront)
    with pytest.raises(RuntimeError, match="injected megakernel fault"):
        _cli("render", "--scene", "cornell-empty", "--width", "16", "--height", "16", "--technique", "nee",
             "--impl", impl, "--frames", "16", "--strict", "-o", str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def test_room_without_assets_raises(tmp_path, monkeypatch):
    """``room`` looks in $FYP_ASSETS and <repo>/assets only, and names
    FYP_ASSETS when its assets are missing (they are not in the
    repository)."""
    from fypraytracer_tpu_torch.scene import procedural
    from fypraytracer_tpu_torch.scene.sceneio import builtin_scene

    monkeypatch.setenv("FYP_ASSETS", str(tmp_path))
    assert procedural._asset_dirs() == [str(tmp_path), os.path.join(REPO, "assets")]
    with pytest.raises(FileNotFoundError, match="FYP_ASSETS"):
        procedural.room(16, 16)
    with pytest.raises(FileNotFoundError, match="bananaDiffuse.png"):
        builtin_scene("room", 16, 16)


def test_room_reads_its_assets_from_fyp_assets(tmp_path, monkeypatch):
    """With the four assets in $FYP_ASSETS (stand-ins written here: a
    triangle OBJ and two PNGs), ``room`` builds the reference's scene: 9
    materials, 2 textures, 6 walls and 5 emissive planes around both
    meshes."""
    from fypraytracer_tpu_torch.scene import procedural
    from fypraytracer_tpu_torch.utils.image import save_png

    for name in ("banana.obj", "toaster.obj"):
        (tmp_path / name).write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    for name, shade in (("bananaDiffuse.png", 200), ("toasterBaseColor.png", 90)):
        save_png(str(tmp_path / name), np.full((4, 4, 3), shade, np.uint8))
    monkeypatch.setenv("FYP_ASSETS", str(tmp_path))
    builder, cam = procedural.room(32, 32)
    scene = builder.compile()
    assert scene.materials.albedo.shape[0] == 9 and scene.textures.pages.shape[0] == 2
    assert scene.num_triangles == 2 + 6 * 2 + 5 * 2 and scene.num_emissive == 10
    assert scene.tex is not None and (cam.width, cam.height) == (32, 32)


def test_cli_train_megakernel_and_restir_on_the_cpu(capsys):
    """`train --impl megakernel` (``DiffRenderer``, K8's plain version here)
    and `train --technique restir-di` (the ReSTIR DI train step) lower
    their losses; `--impl megakernel` refuses a ReSTIR technique."""
    common = ["train", "--scene", "cornell-empty", "--width", "16", "--height", "16", "--bounces", "1"]
    _cli(*common, "--impl", "megakernel", "--steps", "6")
    lines = _records(capsys.readouterr().out)
    losses = [r["loss"] for r in lines if "loss" in r]
    assert losses[-1] < losses[0] and lines[-1]["impl"] == "megakernel"
    _cli(*common, "--technique", "restir-di", "--steps", "4", "--radius", "4", "--neighbors", "2")
    lines = _records(capsys.readouterr().out)
    assert lines[-1]["impl"] == "restir-di" and np.isfinite(lines[-1]["final_albedo_mae"])
    with pytest.raises(SystemExit, match="megakernel"):
        _cli(*common, "--impl", "megakernel", "--technique", "restir-gi")


def test_cli_train_on_two_processes_equals_one():
    """`train --devices 2` as two processes (the ``env://`` variables that
    torchrun sets, a rendezvous on this host, gloo on the CPU) prints the
    one-process run's losses and albedo error: each shard renders its
    pixels' rays and keys, the gradients are summed by ``all_reduce``, and
    the loss is summed in float64 (losses within 1e-6 relative, the error
    within 1e-6).

    The rendezvous store is this process's, listening from the moment it
    binds a free port, and both ranks join it as clients, as under
    torchrun's agent (``TORCHELASTIC_USE_AGENT_STORE``).  A port picked by
    binding and closing a socket, for rank 0 to bind again seconds later,
    can be taken in between by any other process of the host (the other
    test workers' gloo listeners and connections among them), and rank 0
    then fails to listen."""
    import subprocess
    import sys

    from torch.distributed import TCPStore

    store = TCPStore("127.0.0.1", 0, 2, is_master=True, wait_for_workers=False)
    args = [sys.executable, "-m", "fypraytracer_tpu_torch.app.cli", "train", "--scene", "cornell-empty", "--width",
            "16", "--height", "16", "--bounces", "1", "--steps", "3", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port), WORLD_SIZE="2",
               TORCHELASTIC_USE_AGENT_STORE="True")
    procs = [subprocess.Popen([*args, "--devices", "2"], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-2000:] + outs[1][1][-2000:]
    one = subprocess.run(args, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-2000:]
    two, ref = _records(outs[0][0])[1:], _records(one.stdout)[1:]
    assert _records(outs[1][0])[1:] == []                  # shard 1 prints its scene line only
    assert [r.get("step") for r in two] == [r.get("step") for r in ref] == [0, 1, 2, None]
    np.testing.assert_allclose([r["loss"] for r in two[:3]], [r["loss"] for r in ref[:3]], rtol=1e-6)
    assert abs(two[-1]["final_albedo_mae"] - ref[-1]["final_albedo_mae"]) <= 1e-6


def test_cli_prints_which_builder_ran(tmp_path, capsys):
    from fypraytracer_tpu_torch.accel import native

    _cli("render", "--scene", "triangle", "--width", "16", "--height", "16", "--technique", "cosine",
         "--frames", "1", "-o", str(tmp_path))
    rec = _records(capsys.readouterr().out)[0]
    want = "native" if native.available() else "numpy"
    assert rec["builders"] == {"bvh": want, "light_tree": "none"} and rec["triangles"] == 1


# -- the port imports nothing of JAX -------------------------------------------


def _port_files():
    pkg = os.path.join(REPO, "fypraytracer_tpu_torch")
    for root, _, names in os.walk(pkg):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.join(root, n)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "fypraytracer_tpu")


def test_port_imports_no_jax():
    """Every .py of the port and chip_smoke.py, parsed with ``ast``: no
    import (at any depth, relative or not) names jax, jaxlib or the JAX
    package ``fypraytracer_tpu``."""
    files = list(_port_files())
    assert len(files) > 40
    bad = []
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert bad == []
