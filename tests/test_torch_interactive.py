"""The port's interactive live-edit session (the reference viewer's loop,
headless), on the CPU: edits flow through the port's SceneManager, camera
moves restart accumulation, renders stay live across edits.

The cases of tests/test_interactive.py on the port, then ``fly`` (whose JAX
counterpart passes keywords that ``Camera.fly`` does not take, so every
``fly`` there is an error: pinned below), the session on each entry
point's derived state after a mesh edit, and ``main`` reading a script.
"""

import io
import json

import numpy as np
import torch

from fypraytracer_tpu_torch.scene.procedural import cornell_box


class _Capture:
    def __init__(self):
        self.lines = []

    def write(self, s):
        self.lines.append(s)

    def flush(self):
        pass

    def records(self):
        return [json.loads(x) for x in "".join(self.lines).splitlines() if x]


def _session(size=32, **kw):
    from fypraytracer_tpu_torch.app.interactive import InteractiveSession

    builder, cam = cornell_box(width=size, height=size, with_spheres=False)
    out = _Capture()
    return InteractiveSession(builder, cam, out=out, device="cpu", **kw), out


def test_interactive_session_edit_loop(tmp_path):
    sess, out = _session()
    png = tmp_path / "frame.png"
    sess.run([
        "tech cosine",
        "bounces 1",
        "step 2",
        "mat 0 albedo 0.9 0.1 0.1",     # repaint the white walls red
        "step 2",
        "move 0 1.2 2.4",               # camera move resets accumulation
        "step 1",
        "mesh 0 position 0 0.2 0",      # geometry edit -> full recompile
        "step 1",
        f"save {png}",
        "info",
        "quit",
    ])
    rec = out.records()
    steps = [r for r in rec if "frame_ms" in r]
    assert len(steps) == 4
    assert all(r["finite"] for r in steps)
    assert abs(steps[1]["mean"] - steps[0]["mean"]) > 1e-4
    assert steps[2]["frames"] == 1
    assert png.exists()
    info = [r for r in rec if "triangles" in r][-1]
    assert info["scene_version"] == 2          # material edit + mesh edit
    assert abs(info["camera"][1] - 1.2) < 1e-6


def test_interactive_load_and_add_sphere(tmp_path):
    """`load`/`add-sphere` grow the scene and the next `step` renders
    through the rebuilt structures."""
    sess, out = _session()
    obj = tmp_path / "tri.obj"
    obj.write_text("v -0.5 0 0\nv 0.5 0 0\nv 0 0.8 0\nf 1 2 3\n")
    sess.run([
        "tech cosine",
        "bounces 1",
        "step 1",
        "info",
        "add-sphere 0 0.55 0 0 0",
        f"load {obj} 1 0 0 0.5",
        "step 1",
        "info",
        "quit",
    ])
    rec = out.records()
    infos = [r for r in rec if "scene_version" in r]
    steps = [r for r in rec if "frame_ms" in r]
    assert len(steps) == 2 and all(r["finite"] for r in steps)
    loaded = [r for r in rec if "loaded" in r]
    assert loaded and loaded[0]["triangles"] == 1
    assert infos[1]["scene_version"] == infos[0]["scene_version"] + 1
    assert infos[1]["triangles"] > infos[0]["triangles"] + 1
    assert abs(steps[1]["mean"] - steps[0]["mean"]) > 1e-5


def test_interactive_session_bad_command_survives():
    sess, out = _session(16)
    sess.run(["bogus 1 2", "mat 99 albedo 1 0 0", "info", "quit"])
    rec = out.records()
    assert sum("error" in r for r in rec) == 2
    assert any("triangles" in r for r in rec)


def test_interactive_texture_and_camera_knobs(tmp_path):
    """`texture` + `mat N map`, `fov`, `clip`, and the live `restir` knobs
    (WalnutApp.cpp:548-560, :617-643, :674)."""
    from fypraytracer_tpu_torch.utils.image import save_png

    sess, out = _session()
    png = tmp_path / "green.png"
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[..., 1] = 255
    save_png(str(png), tex)
    sess.run([
        "tech cosine",
        "bounces 1",
        "step 2",
        f"texture {png}",
        "mat 0 map 0",            # texture the white walls green
        "step 2",
        "fov 70",
        "step 1",
        "clip 0.05 50",
        "step 1",
        "tech restir-di",
        "restir candidates 2",
        "restir neighbors 2",
        "restir radius 8",
        "restir history 3",
        "restir temporal 0",
        "restir spatial 0",
        "sky 0.1 0.2 0.3",
        "accumulate 1",
        "step 1",
        "info",
        "quit",
    ])
    rec = out.records()
    assert not any("error" in r for r in rec), rec
    steps = [r for r in rec if "frame_ms" in r]
    assert len(steps) == 5 and all(r["finite"] for r in steps)
    assert abs(steps[1]["mean"] - steps[0]["mean"]) > 1e-4
    assert steps[2]["frames"] == 1
    assert abs(steps[2]["mean"] - steps[1]["mean"]) > 1e-5
    tex_rec = [r for r in rec if "texture_id" in r]
    assert tex_rec and tex_rec[0]["texture_id"] == 0
    s = sess.settings
    assert (s.light_candidates, s.spatial_neighbors, s.spatial_radius, s.temporal_history_limit) == (2, 2, 8, 3)
    assert s.temporal_reuse is False and s.spatial_reuse is False
    assert s.sky_color == (0.1, 0.2, 0.3)
    assert sess.camera.vfov_deg == 70.0 and sess.camera.far == 50.0


def test_interactive_fly_moves_the_camera():
    """`fly fwd right up [yaw pitch]` moves and turns the camera and restarts
    accumulation."""
    sess, out = _session(16)
    pos0, fwd0 = sess.camera.position.copy(), sess.camera.forward.copy()
    sess.run(["tech cosine", "bounces 1", "step 2", "fly 0.1 0 0 2 1", "step 1", "info"])
    rec = out.records()
    assert not any("error" in r for r in rec), rec
    assert [r["frames"] for r in rec if "frame_ms" in r] == [2, 1]
    assert not np.allclose(sess.camera.position, pos0) and not np.allclose(sess.camera.forward, fwd0)
    np.testing.assert_allclose(rec[-1]["camera"], sess.camera.position, rtol=0, atol=1e-6)


def test_jax_session_fly_is_an_error():
    """A fault of the reference, pinned: JAX ``cmd_fly`` calls
    ``Camera.fly(..., yaw=, pitch=)``, whose parameters are ``yaw_delta``
    and ``pitch_delta`` (core/camera.py:111-112), so every `fly` command
    reports a TypeError and the camera stays where it was."""
    from fypraytracer_tpu.app.interactive import InteractiveSession as JSession
    from fypraytracer_tpu.scene.procedural import cornell_box as jcornell

    builder, cam = jcornell(width=16, height=16, with_spheres=False)
    out = _Capture()
    sess = JSession(builder, cam, out=out)
    pos0 = sess.camera.position.copy()
    sess.run(["fly 0.1 0 0", "info"])
    rec = out.records()
    assert "TypeError" in rec[0]["error"] and "yaw" in rec[0]["error"]
    np.testing.assert_array_equal(sess.camera.position, pos0)


def test_interactive_mesh_edit_keeps_the_renderer_live():
    """After a `mesh` edit the session's renderer renders the rebuilt scene
    as a renderer made anew on it does (``SceneManager.apply`` hands the
    scene to ``Renderer.set_scene``), and ReSTIR state restarts."""
    from fypraytracer_tpu_torch.render.renderer import Renderer

    sess, out = _session(16)
    sess.run(["tech restir-di", "restir radius 4", "step 2", "mesh 2 position 0 1 -0.9", "step 1"])
    r = sess._get_renderer()
    fresh = Renderer(sess.manager.scene, sess.camera, sess.settings, device="cpu")
    fresh.render_hdr()
    assert r.frame_index == 2 and torch.equal(r.accum, fresh.accum)
    assert sess.manager.version == 1


def test_interactive_main_reads_a_script(monkeypatch, capsys):
    """``main`` builds the named scene and runs the lines of stdin."""
    from fypraytracer_tpu_torch.app import interactive

    monkeypatch.setattr("sys.stdin", io.StringIO("tech cosine\nbounces 1\nstep 1\ninfo\nquit\n"))
    interactive.main(["--scene", "cornell-empty", "--width", "16", "--height", "16", "--device", "cpu"])
    rec = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert rec[0]["frames"] == 1 and rec[0]["finite"] and rec[1]["triangles"] == 12
