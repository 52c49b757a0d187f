"""The premise of K4's shadow walk bounded by its emitter (``csrc/restir_di.cu``).

K4 (ReSTIR DI's second stage) shades a pixel with the chosen emitter where
its shadow ray's closest hit is that emitter's triangle, and adds the sky
where the ray escapes (the JAX ``k2`` at
fypraytracer_tpu/render/megakernel_restir.py:546-590).  The kernel walks the
ray first with ``t_max = dist + tol``, ``tol = max(1e-4, 1e-3 dist)`` (K2's
NEE rule), and walks it again unbounded only where that walk finds no hit.
A bounded closest-hit walk finds every hit nearer than ``t_max`` as the
unbounded walk does (ties to the lowest id), so where it finds one it is the
unbounded walk's closest hit; where it finds none the second walk is the
unbounded walk itself.  The two passes then give the unbounded walk's hit,
and so its answer: the emitter visible, the ray escaped, or blocked.

Here two frames of the plain DI loop (``restir_di_megakernel_plain``) run
with K4's shadow rays recorded (``_emitter_ray`` and the shadow trace), the
rays of the pixels that shade (those the kernel traces) go through the
plain wide walk (``trace_rays_wide``) unbounded and in the kernel's two
passes, and the test counts the rays that need the second pass and the
nodes and leaves both ways visit.  Cornell at 32² and a stress scene cut to
tier-1's size, both built by the native builders in Morton order.
"""

import pytest
import torch

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.ops.traverse import trace_rays, trace_rays_wide
from fypraytracer_tpu_torch.render import megakernel_restir as mr
from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
from fypraytracer_tpu_torch.scene import procedural as tproc

SIZE = 32
SETTINGS = RenderSettings(technique=SamplingTechnique.RESTIR_DI, bounces=2, samples=1,
                          sky_color=(0.05, 0.06, 0.08))


def _scene(name):
    if name == "stress":
        builder, cam = tproc.stress(SIZE, SIZE, grid=2, sphere_res=(6, 8))
    else:
        builder, cam = tproc.cornell_box(SIZE, SIZE)
    return morton_permuted_scene(builder.compile(native=True))[0].to("cpu"), cam


def _shadow_rays(scene, cam, monkeypatch):
    """Two frames of the plain DI loop; for each frame K4's shadow rays of
    the pixels that shade: origins, directions, the distance to the point
    on the chosen emitter, as the kernel computes it, and that emitter's
    triangle."""
    frames, pending = [], {}
    emitter_ray, trace = mr._emitter_ray, mr.trace_rays
    em = mr.prepare_emissive_table(scene)

    def emitter_ray_logged(table, e, pos, up1, up2):
        l, dist2 = emitter_ray(table, e, pos, up1, up2)
        pending.update(dist=torch.sqrt(dist2), sel=table.tri[e])
        return l, dist2

    def trace_logged(bvh, geometry, o, d, **kw):
        if pending:                          # K4's shadow trace follows its emitter ray
            frames.append(dict(o=o, d=d, **pending))
            pending.clear()
        return trace(bvh, geometry, o, d, **kw)

    def k4_logged(scene, em, camera, frame, settings, stage, state, accum):
        shade = stage[mr.S_SHADE] > 0.5
        mr.restir_di_k4_plain(scene, em, camera, frame, settings, stage, state, accum)
        frames[-1]["shade"] = shade

    monkeypatch.setattr(mr, "_emitter_ray", emitter_ray_logged)
    monkeypatch.setattr(mr, "trace_rays", trace_logged)
    state = torch.zeros((mr.ST_ROWS, SIZE * SIZE))
    mr._frames(mr.restir_di_k3_plain, k4_logged, scene, em, cam, state, 1, 2, SETTINGS, cam.proj_view,
               cam.proj_view)
    assert len(frames) == 2
    return [{k: (v[f["shade"]] if k != "shade" else v) for k, v in f.items()} for f in frames]


@pytest.mark.parametrize("name", ["cornell", "stress"])
def test_bounded_then_unbounded_shadow_walk_is_the_unbounded_walk(name, monkeypatch):
    scene, cam = _scene(name)
    seen = {"visible": 0, "escaped": 0, "blocked": 0}
    for f, rays in enumerate(_shadow_rays(scene, cam, monkeypatch)):
        o, d, dist, sel = rays["o"], rays["d"], rays["dist"], rays["sel"]
        assert o.shape[0] > SIZE * SIZE // 4, (f, o.shape[0])
        t_max = dist + torch.clamp_min(dist * 1e-3, 1e-4)            # csrc/restir_di.cu::k4_shade
        c_free, c_first, c_second = {}, {}, {}
        free = trace_rays_wide(scene.wide, o, d, counts=c_free)
        # the unbounded wide walk is the plain version's walk, bit for bit
        assert torch.equal(free["tri"], trace_rays(scene.bvh, scene.geometry, o, d)["tri"])
        first = trace_rays_wide(scene.wide, o, d, t_max=t_max, counts=c_first)
        again = first["tri"] < 0
        second = trace_rays_wide(scene.wide, o[again], d[again], counts=c_second)
        tri = first["tri"].clone()
        tri[again] = second["tri"]
        # the two passes give the unbounded walk's hit, so its answer
        assert torch.equal(tri, free["tri"]), f"frame {f}: rays {(tri != free['tri']).nonzero()[:16].tolist()}"
        visible = (free["tri"] == sel) & (sel >= 0)
        escaped = free["tri"] < 0
        seen["visible"] += int(visible.sum())
        seen["escaped"] += int(escaped.sum())
        seen["blocked"] += int((~visible & ~escaped).sum())
        # the emitter's hit lies below t_max wherever the unbounded walk
        # reaches it, so the second pass serves only rays that escape or are
        # blocked past the emitter
        assert bool((free["t"][visible] < t_max[visible]).all())
        near = (free["tri"] >= 0) & (free["t"] < t_max)
        assert torch.equal(again, ~near)
        assert not bool((visible & again).any())
        # the first pass and the second together visit no more nodes and
        # leaves than the unbounded walk
        visits = lambda c: c.get("nodes", 0) + c.get("leaves", 0)  # noqa: E731
        assert visits(c_first) + visits(c_second) <= visits(c_free), (f, c_first, c_second, c_free, int(again.sum()))
        assert int(again.sum()) < o.shape[0] // 4, (f, int(again.sum()))
        print(f"{name} frame {f + 1}: {o.shape[0]} rays, {int(again.sum())} walked twice; nodes+leaves "
              f"{visits(c_first)} + {visits(c_second)} against {visits(c_free)} unbounded")
    # the emitter is seen and hidden
    assert seen["visible"] > 0 and seen["blocked"] > 0, seen
