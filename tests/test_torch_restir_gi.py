"""The port's ReSTIR GI against the JAX package's, at matched seeds.

Cornell box at 32² (two tiles of 512 pixels), 2 bounces, 3 neighbours,
radius 8, the goldens' sky.  Module-level helpers, the wavefront
``Renderer`` and the megakernel plain versions are held against their JAX
counterparts (the JAX megakernels in Pallas interpret mode).  Gates are
the DI precedent: median |Δ| < 1e-5 and image mean within 1%; pixels off
by more than 1e-3 at most 3% for a static camera and 1% off pixel corners.

Why 3% for a static camera (ROADMAP queue 3, as for ReSTIR DI): the
camera's rays leave through pixel corners, so a static camera reprojects
each hit point onto its own pixel's corner and the hit position's last ulp
decides whether a pixel keeps its history.  That ulp differs between the
sides (XLA's rsqrt in the camera ray, Baldwin–Weber vs Möller–Trumbore t,
and torch's float32 sqrt on this CPU), and a GI reservoir that loses its
history changes its pixel and, through spatial reuse, its neighbours.
Measured at 32² from ``POS``: 1.4-2.5% of pixels after 2 frames, 2.9-4.8%
after 4.  So the static cases run 2 frames.  The witnesses: with temporal
reuse off, or with a camera that moves a little every frame (reprojection
then lands inside pixels), every path meets the 1% gate over 4 frames, and
a frame started from the JAX megakernel's own history through
``from_tiled`` does too.  The kernels' own checks against the plain
versions are in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fypraytracer_tpu.scene.procedural as jproc
from fypraytracer_tpu.config import RenderSettings as JSettings
from fypraytracer_tpu.config import SamplingTechnique as JTech
from fypraytracer_tpu.core import rng as jrng
from fypraytracer_tpu.core.camera import Camera as JCamera
from fypraytracer_tpu.ops import hit as jhit
from fypraytracer_tpu.ops import traverse as jtrav
from fypraytracer_tpu.render import megakernel_restir_gi as jmg
from fypraytracer_tpu.render import restir_gi as jgi
from fypraytracer_tpu.render.megakernel_restir_gi import MegakernelReSTIRGI as JMegakernelGI
from fypraytracer_tpu.render.renderer import Renderer as JRenderer
from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.core import rng
from fypraytracer_tpu_torch.core.camera import Camera, generate_rays
from fypraytracer_tpu_torch.ops import hit as thit
from fypraytracer_tpu_torch.ops import traverse as ttrav
from fypraytracer_tpu_torch.render import megakernel_restir_gi as tmg
from fypraytracer_tpu_torch.render import restir_gi as tgi
from fypraytracer_tpu_torch.render.megakernel_restir_gi import MegakernelReSTIRGI
from fypraytracer_tpu_torch.render.renderer import Renderer
from fypraytracer_tpu_torch.scene import procedural as tproc
from fypraytracer_tpu_torch.scene.types import scene_from_arrays

W = H = 32
SKY = (0.05, 0.06, 0.08)
KW = dict(bounces=2, spatial_neighbors=3, spatial_radius=8, sky_color=SKY)
# just off the box's symmetry plane (test_torch_render.py's DI_POS)
POS = (0.013, 1.011, 2.6)
STATIC_PX_SHARE = 0.03


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gates(got, ref, px_share=0.01):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    assert bool(np.isfinite(got).all())
    assert float(np.median(diff)) < 1e-5
    share = (diff.reshape(-1, 3).max(axis=-1) > 1e-3).mean()
    assert share <= px_share, share
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.01


def _settings(**kw):
    kw = dict(KW, **kw)
    return RenderSettings(technique=SamplingTechnique.RESTIR_GI, **kw), \
        JSettings(technique=JTech.RESTIR_GI, **kw)


def _scenes():
    jb, _ = jproc.cornell_box(W, H, sphere_res=(6, 10))
    tb, _ = tproc.cornell_box(W, H, sphere_res=(6, 10))
    return jb.compile(native=False), tb.compile()


def _cams(pos=POS):
    return (JCamera(position=pos, forward=(0, 0, -1), width=W, height=H),
            Camera(position=pos, forward=(0, 0, -1), width=W, height=H))


def _creep(i):
    """The camera at frame ``i`` of the moving-camera witnesses: a small step
    a frame, so each frame reprojects through a new pose (test_torch_render.py)."""
    return (0.0037 * i, 1.0 - 0.0021 * i, 2.6)


# ---- module level ------------------------------------------------------------------

def _res_inputs(r, n=2048):
    def v3():
        return r.normal(size=(n, 3)).astype(np.float32)

    def f1(lo=0.0, hi=2.0):
        return r.uniform(lo, hi, n).astype(np.float32)

    return dict(sp=v3(), sn=v3(), rad=np.abs(v3()), phat=f1(), w=f1(), m=np.floor(f1(0, 6)),
                wsum=f1(0, 3), cand=(v3(), v3(), np.abs(v3())), weight=f1(0, 3), count=np.floor(f1(1, 4)),
                pdf=f1(), u=f1(0, 1), active=r.uniform(size=n) < 0.7)


def test_megakernel_reservoir_helpers_match_jax():
    """``gi_res_update``, ``w_of`` and ``rad_norm`` against the JAX
    megakernel's on the same random reservoirs, bit for bit."""
    x = _res_inputs(np.random.default_rng(3))
    tt = {k: torch.as_tensor(v) for k, v in x.items() if k != "cand"}
    res = dict(sp=tt["sp"], sn=tt["sn"], rad=tt["rad"], phat=tt["phat"], w=tt["w"], m=tt["m"],
               wsum=tt["wsum"])
    cand = dict(zip(("sp", "sn", "rad"), (torch.as_tensor(c) for c in x["cand"])))
    got = tmg.gi_res_update(res, cand, tt["weight"], tt["count"], tt["pdf"], tt["u"], tt["active"])
    jres = dict(sp=tuple(x["sp"].T), sn=tuple(x["sn"].T), rad=tuple(x["rad"].T), phat=x["phat"],
                w=x["w"], m=x["m"], wsum=x["wsum"])
    jcand = dict(zip(("sp", "sn", "rad"), (tuple(c.T) for c in x["cand"])))
    want = jmg._gi_res_update(jres, jcand, x["weight"], x["count"], x["pdf"], x["u"], x["active"])
    for k in ("sp", "sn", "rad"):
        np.testing.assert_array_equal(got[k].numpy(), np.stack([np.asarray(c) for c in want[k]], -1))
    for k in ("phat", "w", "m", "wsum"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(tmg.w_of(got).numpy(), np.asarray(jmg._w_of(want)))
    np.testing.assert_allclose(tmg.rad_norm(got["rad"]).numpy(),
                               np.asarray(jmg._rad_norm(want["rad"])), rtol=1e-6)


def test_wavefront_reservoir_update_and_norm_match_jax():
    x = _res_inputs(np.random.default_rng(4))

    def res(conv):
        oct2 = x["sn"][:, :2]
        sample = dict(vis_point=x["sp"], vis_normal=oct2, sample_point=x["sp"], sample_normal=oct2,
                      radiance=x["rad"], pdf=x["phat"])
        return dict(sample={k: conv(v) for k, v in sample.items()}, w=conv(x["w"]),
                    m=conv(x["m"].astype(np.int32)), wsum=conv(x["wsum"]))

    cand = dict(vis_point=x["cand"][0], vis_normal=x["cand"][1][:, :2], sample_point=x["cand"][0],
                sample_normal=x["cand"][1][:, :2], radiance=x["cand"][2])
    args = (x["weight"], x["count"].astype(np.int32), x["pdf"], x["u"], x["active"])
    got = tgi.reservoir_update(res(torch.as_tensor), {k: torch.as_tensor(v) for k, v in cand.items()},
                               *(torch.as_tensor(a) for a in args))
    want = jgi.reservoir_update(res(np.asarray), cand, *args)
    for k, v in want["sample"].items():
        np.testing.assert_array_equal(got["sample"][k].numpy(), np.asarray(v), err_msg=k)
    for k in ("m", "wsum"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(tgi._w_of(got).numpy(), np.asarray(jgi._w_of(want)))
    rad = np.concatenate([x["rad"], np.zeros((16, 3), np.float32)])
    np.testing.assert_allclose(tgi._luminance_norm(torch.as_tensor(rad)).numpy(),
                               np.asarray(jgi._luminance_norm(rad)), rtol=1e-6)


def test_trace_sample_path_matches_jax():
    """One BRDF path from each primary hit, the JAX function on NumPy
    arrays with the JAX BVH walk, the port's with its own walk."""
    js, ts = _scenes()
    settings, jsettings = _settings()
    cam = _cams()[1]
    o, d = generate_rays(cam.inv_projection, cam.inv_view, W, H)
    tscene = ts.to("cpu")
    prim = thit.hit_payload(tscene.geometry, o, d, ttrav.trace_rays(tscene.bvh, tscene.geometry, o, d)["tri"])
    shade = prim["t"] >= 0
    pix = torch.arange(W * H)
    key, sample, sky_direct, src_pdf = tgi._trace_sample_path(
        tscene, ttrav.pick_tracer(tscene), prim, -d, rng.path_key(pix, 5, 0, stream=8001), settings)

    def jtrace(oo, dd):
        return np.asarray(jtrav.trace_rays(js.bvh, js.geometry, jnp.asarray(oo), jnp.asarray(dd))["tri"])

    jprim = jhit.hit_payload(js.geometry, o.numpy(), d.numpy(), prim["tri"].numpy())
    jkey, jsample, jsky, jpdf = jgi._trace_sample_path(
        js, jtrace, jprim, -d.numpy(), jrng.path_key(pix.numpy().astype(np.uint32), 5, 0, stream=8001),
        jsettings)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey).astype(np.int64))
    same = np.isclose(src_pdf.numpy(), np.asarray(jpdf), rtol=1e-4, atol=1e-6) & shade.numpy()
    assert same.sum() >= 0.99 * shade.sum().item()
    for k in ("sample_point", "radiance"):
        np.testing.assert_allclose(sample[k].numpy()[same], np.asarray(jsample[k])[same],
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(sky_direct.numpy()[same], np.asarray(jsky)[same], rtol=1e-3, atol=1e-5)
    assert float(sample["radiance"].abs().sum()) > 0.0 and float(sky_direct.abs().sum()) > 0.0


def test_tiled_layout_round_trips():
    r = np.random.default_rng(5)
    tiled = r.normal(size=(2 * tmg.JAX_GS_ROWS, 512)).astype(np.float32)
    x = tmg.from_tiled(tiled, tmg.JAX_GS_ROWS, tmg.GS_ROWS)
    assert x.shape == (tmg.GS_ROWS, W * H)
    # pixel 512 + 7 is tile 1, lane 7
    assert float(x[tmg.GS_T, 519]) == tiled[tmg.JAX_GS_ROWS + tmg.GS_T, 7]
    back = tmg.to_tiled(x, tmg.JAX_GS_ROWS).reshape(2, tmg.JAX_GS_ROWS, 512)
    np.testing.assert_array_equal(back[:, :tmg.GS_ROWS], tiled.reshape(2, -1, 512)[:, :tmg.GS_ROWS])
    assert not back[:, tmg.GS_ROWS:].any()


# ---- renderers ---------------------------------------------------------------------
#
# The JAX megakernel compiles anew for every instance and frame count (5-6 s
# in interpret mode), so each mode's JAX run is made once, one frame a call,
# and shared by the comparisons below.

def _jax_pair(mono=True, final_vis=False, pos=POS, **kw):
    js, ts = _scenes()
    settings, jsettings = _settings(**kw)
    jcam, tcam = _cams(pos)
    jg = JMegakernelGI(js, jcam, jsettings, interpret=True, mono=mono, final_vis=final_vis)
    tg = MegakernelReSTIRGI(ts, tcam, settings, device="cpu", mono=mono, final_vis=final_vis)
    return jg, tg


MODES = {"mono": dict(mono=True), "final_vis": dict(mono=True, final_vis=True), "split": dict(mono=False)}
_RUNS: dict = {}


def _frame_of(mk, n=1):
    """Render ``n`` frames; return the HDR they added."""
    a0 = np.asarray(mk.accum).copy()
    mk.render_many(n)
    return np.asarray(mk.accum) - a0


def _static_run(mode):
    """Both sides from ``POS``: two static frames as two calls (the
    reservoirs carried across them), then the camera moved and one frame
    reprojected through the old pose with the tile-mean offset."""
    if ("static", mode) not in _RUNS:
        jg, tg = _jax_pair(**MODES[mode])
        out = {}
        for i in range(2):
            out[f"jax{i}"], out[f"port{i}"] = _frame_of(jg), _frame_of(tg)
        out["jax_avg"], out["port_avg"] = np.asarray(jg.accum) / 2, tg.accum.numpy() / 2
        out["port_m_max"] = float(tg.state[tmg.GT_M].max())
        for mk in (jg, tg):
            mk.camera.move_to((0.15, 1.0, 2.6))
        out["jax_moved"], out["port_moved"] = _frame_of(jg), _frame_of(tg)
        assert tg.frame_index == jg.frame_index == 4
        _RUNS["static", mode] = out
    return _RUNS["static", mode]


def _creep_run(mode):
    """The JAX megakernel from ``_creep(0)``, the camera moved before each of
    4 frames; its state and stage after 2 frames are kept for the port."""
    if ("creep", mode) not in _RUNS:
        jg, tg = _jax_pair(pos=_creep(0), **MODES[mode])
        out = dict(frames=[])
        for i in range(4):
            if i:
                jg.camera.move_to(_creep(i))
            if i == 2:
                out["state"], out["stage"] = np.asarray(jg.state), np.asarray(jg.stage)
            out["frames"].append(_frame_of(jg))
        out["port"] = tg
        _RUNS["creep", mode] = out
    return _RUNS["creep", mode]


def test_restir_gi_wavefront_matches_jax_renderer():
    js, ts = _scenes()
    settings, jsettings = _settings()
    jcam, tcam = _cams()
    jr, r = JRenderer(js, jcam, jsettings), Renderer(ts, tcam, settings, device="cpu")
    for _ in range(2):
        ref = np.asarray(jr.render_hdr())
        got = r.render_hdr()
    assert int(r.aux_state["reservoir"]["m"].max()) > 1
    _gates(got.numpy(), ref, STATIC_PX_SHARE)


@pytest.mark.parametrize("mode", MODES)
def test_restir_gi_megakernel_plain_matches_jax_static(mode):
    run = _static_run(mode)
    assert run["port_m_max"] > 1.0        # history and neighbours merged
    for i in range(2):
        _gates(run[f"port{i}"], run[f"jax{i}"], STATIC_PX_SHARE)
    _gates(run["port_avg"], run["jax_avg"], STATIC_PX_SHARE)


@pytest.mark.parametrize("mode", MODES)
def test_restir_gi_megakernel_plain_matches_jax_after_move(mode):
    run = _static_run(mode)
    _gates(run["port_moved"], run["jax_moved"], STATIC_PX_SHARE)


@pytest.mark.parametrize("mode", MODES)
def test_restir_gi_megakernel_matches_jax_moving_camera(mode):
    """A witness for the 3%: with the camera moving a little before every
    frame, reprojection lands inside pixels, and the port meets the 1% gate
    over 4 frames."""
    run = _creep_run(mode)
    tg = run["port"]
    for i in range(4):
        if i:
            tg.camera.move_to(_creep(i))
        got = _frame_of(tg)
        _gates(got, run["frames"][i])
    assert float(tg.state[tmg.GT_M].max()) > 2.0        # history was kept


@pytest.mark.parametrize("mode", ["mono", "split"])
def test_restir_gi_starts_from_jax_history(mode):
    """The port starts a frame from the JAX megakernel's own state and stage
    after 2 frames (``from_tiled``), off pixel corners."""
    run = _creep_run(mode)
    _, tg = _jax_pair(pos=_creep(1), **MODES[mode])
    tg.state = tmg.from_tiled(run["state"], tmg.JAX_GT_ROWS, tmg.GT_ROWS)
    tg.stage = tmg.from_tiled(run["stage"], tmg.JAX_GS_ROWS, tmg.GS_ROWS)
    tg.frame_index = 3
    assert float(tg.state[tmg.GT_M].max()) > 1.0
    np.testing.assert_array_equal(tmg.to_tiled(tg.state, tmg.JAX_GT_ROWS), run["state"])
    tg.camera.move_to(_creep(2))
    _gates(_frame_of(tg), run["frames"][2])


@pytest.mark.parametrize("mode", list(MODES) + ["wavefront"])
def test_restir_gi_matches_jax_without_temporal_reuse(mode):
    """The other witness: temporal reuse off, every path meets the 1% gate
    over 3 frames from ``POS``."""
    if mode == "wavefront":
        js, ts = _scenes()
        settings, jsettings = _settings(temporal_reuse=False)
        jcam, tcam = _cams()
        jr, r = JRenderer(js, jcam, jsettings), Renderer(ts, tcam, settings, device="cpu")
        for _ in range(3):
            ref, got = np.asarray(jr.render_hdr()), r.render_hdr().numpy()
    else:
        jg, tg = _jax_pair(temporal_reuse=False, **MODES[mode])
        for _ in range(3):
            ref, got = _frame_of(jg), _frame_of(tg)
    _gates(got, ref)


def test_restir_gi_wavefront_matches_jax_moving_camera():
    js, ts = _scenes()
    settings, jsettings = _settings()
    jcam, tcam = _cams(_creep(0))
    jr, r = JRenderer(js, jcam, jsettings), Renderer(ts, tcam, settings, device="cpu")
    for i in range(4):
        if i:
            jr.camera.move_to(_creep(i))
            r.camera.move_to(_creep(i))
        ref, got = np.asarray(jr.render_hdr()), r.render_hdr()
    _gates(got.numpy(), ref)


def test_mono_frame_loop_leaves_its_inputs_and_carries_state():
    """The frame loop ping-pongs its own buffers: the caller's state and
    stage are only read; two calls of 1 frame equal one call of 2."""
    _, ts = _scenes()
    scene = ts.to("cpu")
    settings, _ = _settings()
    cam = _cams()[1]
    B = W * H
    state, stage = torch.zeros((tmg.GT_ROWS, B)), torch.zeros((tmg.GS_ROWS, B))
    ppv = cam.proj_view
    both, st2, sg2 = tmg.restir_gi_megakernel(scene, cam, state, stage, 1, 2, settings, ppv, ppv)
    assert not state.any() and not stage.any()
    one, st1, sg1 = tmg.restir_gi_megakernel(scene, cam, state, stage, 1, 1, settings, ppv, ppv)
    two, st_b, sg_b = tmg.restir_gi_megakernel(scene, cam, st1, sg1, 2, 1, settings, ppv, ppv)
    assert torch.equal(one + two, both) and torch.equal(st_b, st2) and torch.equal(sg_b, sg2)
    assert float(st2[tmg.GT_M].max()) > 1.0
    with pytest.raises(ValueError, match="final_vis"):
        MegakernelReSTIRGI(ts, cam, settings, device="cpu", mono=False, final_vis=True)


def test_restir_gi_launches_nothing_on_cpu_and_uses_morton_order():
    js, ts = _scenes()
    settings, _ = _settings()
    before = (tmg.restir_gi_mono.launches, tmg.restir_gi_k1.launches, tmg.restir_gi_k2.launches)
    tg = MegakernelReSTIRGI(ts, _cams()[1], settings, device="cpu", mono=False)
    tg.render_many(1)
    assert (tmg.restir_gi_mono.launches, tmg.restir_gi_k1.launches, tmg.restir_gi_k2.launches) == before
    jm = scene_from_arrays(jmg.morton_permuted_scene(js)[0], "cpu")
    assert torch.equal(tg.scene.geometry.tri_v, jm.geometry.tri_v)
