"""The premise of K2's bounded NEE shadow walk (``csrc/megakernel.cu``).

K2 NEE uses a shadow ray only to ask whether the sampled light triangle is
its closest hit (``sh_tri == lt_tri``, the JAX ``_nee_direct`` at
fypraytracer_tpu/render/megakernel.py:2088-2090), so it walks the ray with
``t_max = dist + tol``, ``tol = max(1e-4, 1e-3 dist)``, instead of
unbounded.  The answer is the same whenever the light's hit lies below
``t_max``: a bounded closest-hit walk finds every hit nearer than
``t_max`` as the unbounded walk does (ties to the lowest id), and where the
unbounded walk's closest hit lies past ``t_max`` the bounded one returns -1.

Here one NEE frame runs through the plain integrator (``radiance_nee_mis``,
what ``megakernel_plain`` sums), its shadow rays, light picks and light
points recorded at both bounces, and each bounce's shadow rays go through
the plain wide walk (``trace_rays_wide``) bounded and unbounded, the rays
of the paths still live there (those the kernel traces): the light is
visible for the same rays, the light's hit lies below ``t_max`` wherever
the unbounded walk reaches it, and the bounded walk visits no more nodes.
Cornell at 32² and a stress scene cut to tier-1's size, both built by the
native builders (``compile(native=True)``), at two frames.
"""

import numpy as np
import pytest
import torch

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.core.camera import generate_rays
from fypraytracer_tpu_torch.core.mathutils import dot3
from fypraytracer_tpu_torch.ops.traverse import trace_rays, trace_rays_wide
from fypraytracer_tpu_torch.render import integrators
from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
from fypraytracer_tpu_torch.scene import procedural as tproc

SIZE = 32
SETTINGS = RenderSettings(technique=SamplingTechnique.NEE_MIS, bounces=2, samples=1,
                          sky_color=(0.05, 0.06, 0.08))


def _scene(name):
    if name == "stress":
        builder, cam = tproc.stress(SIZE, SIZE, grid=2, sphere_res=(6, 8))
        return morton_permuted_scene(builder.compile(native=True))[0].to("cpu"), cam
    builder, cam = tproc.cornell_box(SIZE, SIZE)
    return builder.compile(native=True).to("cpu"), cam


def _shadow_rays(scene, cam, frame, monkeypatch):
    """One NEE frame of the plain integrator; for each bounce its shadow
    rays' origins and directions, the picked light triangles, the distance
    to the light points, as the kernel computes it, and the rays of paths
    still live there (the kernel traces only those: the plain version
    traces every lane and masks the ended paths' results)."""
    traces, picks, points, pdfs = [], [], [], []

    def trace(o, d):
        tri = trace_rays(scene.bvh, scene.geometry, o, d)["tri"]
        traces.append((o, d, tri))
        return tri

    pick, point, sample = integrators.pick_light, integrators._sample_point_on_triangle, \
        integrators.brdf_sample_hemisphere

    def pick_logged(tree, position, u):
        lt_tri, pmf = pick(tree, position, u)
        picks.append((lt_tri, position))
        return lt_tri, pmf

    def point_logged(*args):
        out = point(*args)
        points.append(out[0])
        return out

    def sample_logged(*args):
        l, pdf = sample(*args)
        pdfs.append(pdf)
        return l, pdf

    monkeypatch.setattr(integrators, "pick_light", pick_logged)
    monkeypatch.setattr(integrators, "_sample_point_on_triangle", point_logged)
    monkeypatch.setattr(integrators, "brdf_sample_hemisphere", sample_logged)
    o, d = generate_rays(cam.inv_projection, cam.inv_view, SIZE, SIZE, device="cpu")
    pixel_ids = torch.arange(SIZE * SIZE)
    integrators.radiance_nee_mis(scene, trace, o, d, pixel_ids, frame, SETTINGS)
    # the traces: the primary rays, then a shadow and a continuation a bounce
    assert len(traces) == 1 + 2 * SETTINGS.bounces and len(picks) == len(points) == SETTINGS.bounces

    def ends(tri):
        """The hit ends a path: a miss or an emitter."""
        em = integrators.material_emission(scene, torch.where(tri >= 0, scene.geometry.tri_mat[tri.clamp_min(0)], -1))
        return (tri < 0) | (dot3(em, em, keepdims=False) > 0.0)

    live = ~ends(traces[0][2])
    out = []
    for b in range(SETTINGS.bounces):
        so, sd, _ = traces[1 + 2 * b]
        lt_tri, position = picks[b]
        tl = points[b] - position
        dist = torch.sqrt(torch.clamp_min(dot3(tl, tl, keepdims=False), 1e-20))
        out.append((so, sd, lt_tri, dist, live.clone()))
        live &= (pdfs[b] > 0.0) & ~ends(traces[2 + 2 * b][2])
    return out


@pytest.mark.parametrize("frame", [1, 2])
@pytest.mark.parametrize("name", ["cornell", "stress"])
def test_bounded_shadow_walk_sees_the_same_light(name, frame, monkeypatch):
    scene, cam = _scene(name)
    for b, (o, d, lt_tri, dist, live) in enumerate(_shadow_rays(scene, cam, frame, monkeypatch)):
        assert int(live.sum()) > o.shape[0] // 4, (b, int(live.sum()))
        o, d, lt_tri, dist = o[live], d[live], lt_tri[live], dist[live]
        t_max = dist + torch.clamp_min(dist * 1e-3, 1e-4)       # csrc/megakernel.cu::nee_vertex
        c_free, c_bound = {}, {}
        free = trace_rays_wide(scene.wide, o, d, counts=c_free)
        bound = trace_rays_wide(scene.wide, o, d, t_max=t_max, counts=c_bound)
        # the unbounded wide walk is the plain version's walk, bit for bit
        assert torch.equal(free["tri"], trace_rays(scene.bvh, scene.geometry, o, d)["tri"])
        lit_free = (free["tri"] == lt_tri) & (lt_tri >= 0)
        lit_bound = (bound["tri"] == lt_tri) & (lt_tri >= 0)
        off = (lit_free != lit_bound).nonzero().flatten()
        assert off.numel() == 0, f"bounce {b}: rays {off[:16].tolist()} see the light only one way"
        assert bool((free["t"][lit_free] < t_max[lit_free]).all())
        # both answers occur, and the bounded walk visits no more nodes
        assert 0 < int(lit_free.sum()) < o.shape[0], (b, int(lit_free.sum()))
        assert c_bound["nodes"] + c_bound.get("leaves", 0) <= c_free["nodes"] + c_free.get("leaves", 0)
        # a bounded walk's hit lies below its bound, and where the unbounded
        # walk's closest hit does too, both walks give it
        hit = bound["tri"] >= 0
        assert bool((bound["t"][hit] < t_max[hit]).all())
        near = (free["tri"] >= 0) & (free["t"] < t_max)
        assert torch.equal(bound["tri"][near], free["tri"][near])
        assert bool((bound["tri"][~near] == -1).all())
        assert np.isfinite(dist.numpy()).all()
