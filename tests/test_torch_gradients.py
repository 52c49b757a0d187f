"""Gradients of the port's wavefront estimators: torch autograd against
central finite differences (the checks of tests/test_gradients.py, run on
the port), against ``jax.grad`` of the JAX wavefronts, and the training step
``parallel.shard.make_train_step``.

Discrete choices (hit triangles, light picks, lobe and reservoir decisions)
carry no gradient, as in the JAX package; radiance differentiates with
respect to the material table's float fields and the sky colour.  Against
``jax.grad`` the loss is weighted by a fixed mask of the pixels whose
forward values agree within 1e-4: a pixel whose ray grazes a triangle edge
takes another path on each side (the port walks the BVH with
Möller–Trumbore, the JAX dense tracer Baldwin–Weber), and one such pixel
moves a gradient by up to 0.76% of its largest entry.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fypraytracer_tpu.scene.procedural as jproc
from fypraytracer_tpu.config import RenderSettings as JSettings
from fypraytracer_tpu.config import SamplingTechnique as JTech
from fypraytracer_tpu.core.camera import generate_rays as jrays
from fypraytracer_tpu.ops.dense import pick_tracer as jpick_tracer
from fypraytracer_tpu.render import integrators as jint
from fypraytracer_tpu.render import restir_di as jdi
from fypraytracer_tpu.render import restir_gi as jgi
from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.core.camera import generate_rays
from fypraytracer_tpu_torch.ops.traverse import pick_tracer
from fypraytracer_tpu_torch.parallel.shard import make_train_step
from fypraytracer_tpu_torch.render import integrators as tint
from fypraytracer_tpu_torch.render import restir_di as tdi
from fypraytracer_tpu_torch.render import restir_gi as tgi
from fypraytracer_tpu_torch.scene import procedural as tproc
from fypraytracer_tpu_torch.scene.types import materials_from_arrays, scene_from_arrays, with_materials

W = H = 16
B = W * H
FIELDS = ("albedo", "emission_power", "roughness", "metallic")
DI = dict(light_candidates=4, spatial_neighbors=3, spatial_radius=6)
GI = dict(bounces=2, spatial_neighbors=2, spatial_radius=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small batches of many tiny ops: threads only add sync overhead, and
    under several test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_scene():
    builder, cam = jproc.cornell_box(width=W, height=H, with_spheres=False)
    return builder.compile(native=False), cam


@functools.lru_cache(maxsize=None)
def _port_scene():
    """The JAX scene's arrays, so both sides walk the same BVH."""
    scene, cam = _jax_scene()
    return scene_from_arrays(scene, "cpu"), cam


def _rays(flip=False):
    _, cam = _jax_scene()
    o, d = generate_rays(cam.inv_projection, cam.inv_view, W, H, device="cpu")
    if flip:                     # half the rays backwards: the primary-miss path
        d = d.clone()
        d[::2] = -d[::2]
    return o.contiguous(), d.contiguous()


def _settings(technique, **kw):
    return RenderSettings(technique=technique, **kw)


def _frame(scene, technique, settings, frame=1, state=None, rays=None):
    """``(hdr (B, 3), new state)`` of one frame of the port's wavefront for
    ``technique`` ("cosine", "nee", "di", "gi"); the state is None for the
    stateless two."""
    o, d = rays if rays is not None else _rays()
    pix = torch.arange(B)
    trace = pick_tracer(scene)
    _, cam = _jax_scene()
    if technique == "cosine":
        return tint.radiance_hemisphere(scene, trace, o, d, pix, frame, settings, "cosine"), None
    if technique == "nee":
        return tint.radiance_nee_mis(scene, trace, o, d, pix, frame, settings), None
    module, render = (tdi, tdi.render_restir_di) if technique == "di" else (tgi, tgi.render_restir_gi)
    state = module.init_state(B) if state is None else state
    return render(scene, trace, o, d, pix, frame, settings, state, W, H, cam.prev_proj_view)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def _mats_with(field=None, value=None, requires_grad=()):
    """The scene's material table as tensors, ``field`` replaced by
    ``value`` (a float64 NumPy array, cast to float32 as the JAX tests do)."""
    scene, _ = _jax_scene()
    mats = scene.materials
    if field is not None:
        mats = dataclasses.replace(mats, **{field: value.astype(np.float32)})
    return materials_from_arrays(mats, "cpu", requires_grad=requires_grad)


def _grads(loss_of_mats, fields):
    mats = _mats_with(requires_grad=fields)
    loss = loss_of_mats(mats)
    return dict(zip(fields, torch.autograd.grad(loss, [getattr(mats, f) for f in fields])))


def _central_difference(loss_of_mats, field, idx, eps):
    scene, _ = _jax_scene()
    base = np.asarray(getattr(scene.materials, field), np.float64)
    vals = {}
    for sign in (1, -1):
        pert = base.copy()
        pert[idx] += sign * eps
        with torch.no_grad():
            vals[sign] = float(loss_of_mats(_mats_with(field, pert)))
    return (vals[1] - vals[-1]) / (2 * eps)


def _mean_loss(technique, settings, frame=1, state=None):
    scene, _ = _port_scene()

    def loss(mats):
        return _frame(with_materials(scene, mats), technique, settings, frame, state)[0].mean()
    return loss


# ---- against central finite differences (tests/test_gradients.py) -------


@pytest.mark.parametrize("field", FIELDS)
def test_material_grads_match_finite_differences(field):
    """tests/test_gradients.py:41-70: cosine, 1 bounce, <= 2e-3."""
    loss = _mean_loss("cosine", _settings(SamplingTechnique.COSINE, bounces=1, samples=1))
    g = _grads(loss, (field,))[field].numpy()
    for fi in (0, 1, min(3, g.size - 1)):
        idx = np.unravel_index(fi, g.shape)
        fd = _central_difference(loss, field, idx, 1e-3)
        ad = float(g[idx])
        assert abs(fd - ad) <= 2e-3 * max(abs(fd), abs(ad), 1.0), (field, idx, fd, ad)


def test_sky_color_gradient():
    """tests/test_gradients.py:73-120: the gradient with respect to a tensor
    sky through the primary miss, the bounce miss and NEE's shadow-ray
    escape, <= 1% of central differences."""
    scene, _ = _port_scene()
    rays = _rays(flip=True)
    base = _settings(SamplingTechnique.NEE_MIS, bounces=2, samples=1)

    def loss(sky):
        return _frame(scene, "nee", base.replace(sky_color=sky), rays=rays)[0].mean()

    sky0 = torch.tensor([0.3, 0.5, 0.7], requires_grad=True)
    g = torch.autograd.grad(loss(sky0), sky0)[0].numpy()
    assert np.isfinite(g).all() and (g > 0).all(), g
    eps = 1e-3
    for ch in range(3):
        with torch.no_grad():
            hi = float(loss(sky0.detach() + eps * torch.eye(3)[ch]))
            lo = float(loss(sky0.detach() - eps * torch.eye(3)[ch]))
        fd = (hi - lo) / (2 * eps)
        assert abs(fd - g[ch]) <= 0.01 * max(abs(fd), abs(g[ch])), (ch, fd, g[ch])


def _fd_probes(loss, grads, probes):
    for field, idx, eps in probes:
        fd = _central_difference(loss, field, idx, eps)
        ad = float(grads[field][idx])
        assert abs(fd - ad) <= 0.01 * max(abs(fd), abs(ad), 1e-4), (field, idx, fd, ad)


def _light():
    scene, _ = _jax_scene()
    return int(np.argmax(np.asarray(scene.materials.emission_power)))


def test_nee_mis_grads_match_finite_differences():
    """tests/test_gradients.py:123-174: NEE+MIS at 2 bounces, <= 1%."""
    loss = _mean_loss("nee", _settings(SamplingTechnique.NEE_MIS, bounces=2, samples=1))
    grads = _grads(loss, ("albedo", "emission_power"))
    _fd_probes(loss, grads, [("albedo", (0, 0), 1e-3), ("albedo", (1, 1), 1e-3),
                             ("emission_power", (_light(),), 1e-2)])


@functools.lru_cache(maxsize=None)
def _di_state1():
    """The port's DI state after frame 1 with the true materials, detached."""
    scene, _ = _port_scene()
    with torch.no_grad():
        _, st1 = _frame(scene, "di", _settings(SamplingTechnique.RESTIR_DI, **DI), frame=1)
    return _detached(st1)


def test_restir_di_grads_match_finite_differences():
    """tests/test_gradients.py:217-256: frame 2 over the detached frame-1
    state, so candidates, temporal merge, spatial reuse and the shade are
    all on the differentiated path; <= 1%."""
    loss = _mean_loss("di", _settings(SamplingTechnique.RESTIR_DI, **DI), frame=2, state=_di_state1())
    grads = _grads(loss, FIELDS)
    for field in FIELDS:
        assert np.isfinite(grads[field].numpy()).all(), field
    _fd_probes(loss, grads, [("albedo", (0, 0), 1e-3), ("albedo", (1, 1), 1e-3), ("albedo", (2, 2), 1e-3),
                             ("emission_power", (_light(),), 1e-2)])


def test_restir_di_pixel_grads_match_finite_differences():
    """tests/test_gradients.py:259-286: the (B, 3) Jacobian of the DI image
    with respect to the light's emission power, by one forward-mode product
    (``torch.func.jvp``), against central differences on every pixel, 1%."""
    scene, _ = _port_scene()
    settings = _settings(SamplingTechnique.RESTIR_DI, **DI)
    light = _light()
    st1 = _di_state1()
    p0 = float(scene.materials.emission_power[light])

    def img(p):
        ep = scene.materials.emission_power.clone()
        ep = torch.where(torch.arange(ep.shape[0]) == light, p, ep)
        mats = dataclasses.replace(scene.materials, emission_power=ep)
        return _frame(with_materials(scene, mats), "di", settings, frame=2, state=st1)[0]

    _, jac = torch.func.jvp(img, (torch.tensor(p0),), (torch.tensor(1.0),))
    jac = jac.numpy()
    eps = 1e-2
    with torch.no_grad():
        fd = (img(torch.tensor(p0 + eps)).numpy() - img(torch.tensor(p0 - eps)).numpy()) / (2 * eps)
    rel = np.abs(fd - jac) / np.maximum(np.abs(fd), 1e-6)
    assert (rel > 0.01).mean() == 0.0, (rel.max(), (rel > 0.01).mean())
    assert np.abs(jac).sum() > 1e-3


def test_restir_gi_grads_match_finite_differences():
    """tests/test_gradients.py:289-347: ReSTIR GI at frame 1, <= 1%."""
    loss = _mean_loss("gi", _settings(SamplingTechnique.RESTIR_GI, **GI))
    grads = _grads(loss, FIELDS)
    for field in FIELDS:
        assert np.isfinite(grads[field].numpy()).all(), field
    _fd_probes(loss, grads, [("albedo", (0, 0), 1e-3), ("albedo", (1, 1), 1e-3),
                             ("emission_power", (_light(),), 1e-2)])


# ---- against jax.grad of the JAX wavefronts --------------------------------


JAX_TECH = {"cosine": (JTech.COSINE, dict(bounces=2, samples=1)),
            "nee": (JTech.NEE_MIS, dict(bounces=2, samples=1)),
            "di": (JTech.RESTIR_DI, DI),
            "gi": (JTech.RESTIR_GI, GI)}
PORT_TECH = {"cosine": SamplingTechnique.COSINE, "nee": SamplingTechnique.NEE_MIS,
             "di": SamplingTechnique.RESTIR_DI, "gi": SamplingTechnique.RESTIR_GI}
SKY = (0.05, 0.06, 0.08)


def _jax_hdr(technique, materials, frame, state):
    scene, cam = _jax_scene()
    tech, kw = JAX_TECH[technique]
    settings = JSettings(technique=tech, sky_color=SKY, **kw)
    s = dataclasses.replace(scene, materials=materials)
    o, d = jrays(cam.inv_projection, cam.inv_view, W, H, xp=np)
    o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
    pix = jnp.arange(B, dtype=jnp.uint32)
    trace = jpick_tracer(s, "dense")
    if technique == "cosine":
        return jint.radiance_hemisphere(s, trace, o, d, pix, jnp.uint32(frame), settings, "cosine"), None
    if technique == "nee":
        return jint.radiance_nee_mis(s, trace, o, d, pix, jnp.uint32(frame), settings), None
    module = jdi if technique == "di" else jgi
    fn = module.render_restir_di if technique == "di" else module.render_restir_gi
    return fn(s, trace, o, d, pix, jnp.uint32(frame), settings, state, W, H, jnp.asarray(cam.prev_proj_view))


@pytest.mark.parametrize("technique", ["cosine", "nee", "di", "gi"])
def test_material_grads_match_jax_grad(technique):
    """d(masked mean HDR)/d(albedo, emission_power, roughness, metallic) of
    one frame (DI: frame 2 over the detached frame-1 state of each side)
    against ``jax.grad``; max |Δ| <= 1e-3 of max |g| for each field."""
    jscene, _ = _jax_scene()
    jmats = jax.tree_util.tree_map(jnp.asarray, jscene.materials)
    tech, kw = JAX_TECH[technique]
    frame, jstate, tstate = 1, None, None
    if technique in ("di", "gi"):
        module = jdi if technique == "di" else jgi
        jstate = jax.tree_util.tree_map(jnp.asarray, module.init_state(B))
        tstate = (tdi if technique == "di" else tgi).init_state(B)
    if technique == "di":
        frame = 2
        _, jstate = _jax_hdr("di", jmats, 1, jstate)
        jstate = jax.lax.stop_gradient(jstate)
        tstate = _di_state1()

    settings = _settings(PORT_TECH[technique], sky_color=SKY, **kw)
    pscene, _ = _port_scene()
    with torch.no_grad():
        t_img = _frame(pscene, technique, settings, frame, tstate)[0].numpy()
    j_img = np.asarray(_jax_hdr(technique, jmats, frame, jstate)[0])
    mask = (np.abs(t_img - j_img).max(-1) <= 1e-4).astype(np.float32)
    assert mask.mean() > 0.9, (technique, int(B - mask.sum()))

    def jloss(params):
        mats = dataclasses.replace(jmats, **params)
        return jnp.mean(_jax_hdr(technique, mats, frame, jstate)[0] * mask[:, None])

    jg = jax.grad(jloss)({f: getattr(jmats, f) for f in FIELDS})
    tmask = torch.as_tensor(mask)[:, None]

    def tloss(mats):
        return (_frame(with_materials(pscene, mats), technique, settings, frame, tstate)[0] * tmask).mean()

    tg = _grads(tloss, FIELDS)
    for f in FIELDS:
        ref, got = np.asarray(jg[f]), tg[f].numpy()
        assert np.abs(got - ref).max() <= 1e-3 * max(np.abs(ref).max(), 1e-9), \
            (technique, f, np.abs(got - ref).max(), np.abs(ref).max(), int(B - mask.sum()))


# ---- the training step --------------------------------------------------------


def _train_setup():
    scene, cam = _port_scene()
    settings = _settings(SamplingTechnique.COSINE, bounces=1, samples=2)
    target = tint.radiance_hemisphere(scene, pick_tracer(scene), *_rays(), torch.arange(B), 1, settings, "cosine")
    true_albedo = scene.materials.albedo
    params = dataclasses.replace(scene.materials, albedo=torch.clamp(true_albedo + 0.3, 0.0, 1.0))
    return scene, cam, settings, target, params


def test_train_step_recovers_albedo():
    """tests/test_gradients.py:431-464 on one device: SGD through the
    cosine wavefront, 25 steps, the last loss under 0.2 of the first."""
    scene, cam, settings, target, params = _train_setup()
    step = make_train_step(scene, W, H, settings, lr=1.0, technique="cosine", device="cpu")
    losses = []
    for _ in range(25):
        params, loss = step(params, cam.inv_projection, cam.inv_view, 1, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.2, losses[:3] + losses[-3:]
    assert not params.albedo.requires_grad


def test_train_step_with_torch_adam():
    """tests/test_gradients.py:467-505 with ``torch.optim.Adam(lr=0.05)``:
    30 steps, the last loss under 0.1 of the first, ``albedo_map`` (the one
    int field) untouched."""
    scene, cam, settings, target, params = _train_setup()
    step, init_opt = make_train_step(scene, W, H, settings, technique="cosine",
                                     optimizer=functools.partial(torch.optim.Adam, lr=0.05), device="cpu")
    opt = init_opt(params)
    losses = []
    for _ in range(30):
        params, opt, loss = step(params, opt, cam.inv_projection, cam.inv_view, 1, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.1, losses[:2] + losses[-2:]
    assert torch.equal(params.albedo_map, scene.materials.albedo_map)


def test_train_step_nee_updates_only_the_named_fields():
    """NEE with ``fields=("albedo",)``, as the JAX ReSTIR train steps take
    fields: 5 SGD steps at lr 30 lower the loss every step, and the other
    fields stay as they were.  (With every float field, a metallic that
    leaves 0 switches the BRDF mixture's lobe choice on, so the fixed-seed
    loss jumps; see ROADMAP queue 3.)"""
    scene, cam = _port_scene()
    settings = _settings(SamplingTechnique.NEE_MIS, bounces=2, samples=1, sky_color=SKY)
    target = _frame(scene, "nee", settings)[0]
    rng = np.random.default_rng(0)
    params = dataclasses.replace(scene.materials, albedo=torch.as_tensor(np.clip(
        scene.materials.albedo.numpy() + rng.normal(0.0, 0.25, scene.materials.albedo.shape), 0.05, 0.95
    ).astype(np.float32)))
    step = make_train_step(scene, W, H, settings, lr=30.0, technique="nee", device="cpu", fields=("albedo",))
    losses = []
    for _ in range(5):
        params, loss = step(params, cam.inv_projection, cam.inv_view, 1, target)
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    for f in ("roughness", "metallic", "emission_color", "emission_power"):
        assert torch.equal(getattr(params, f), getattr(scene.materials, f)), f


def test_nee_roughness_gradient_is_finite():
    """At Cornell 64² a GGX sample draws cos θ = 1 exactly, where a plain
    sqrt's infinite slope made the roughness gradient NaN (the JAX package's
    ``jax.grad`` gives NaN there too); ``mathutils.sqrt0`` keeps the value
    and gives the slope 0."""
    builder, cam = tproc.cornell_box(64, 64)
    scene = builder.compile().to("cpu")
    settings = _settings(SamplingTechnique.NEE_MIS, bounces=2, samples=1, sky_color=SKY)
    rough = scene.materials.roughness.clone().requires_grad_(True)
    sc = with_materials(scene, dataclasses.replace(scene.materials, roughness=rough))
    o, d = generate_rays(cam.inv_projection, cam.inv_view, 64, 64)
    hdr = tint.radiance_nee_mis(sc, pick_tracer(sc), o, d, torch.arange(64 * 64), 1, settings)
    (g,) = torch.autograd.grad(hdr.mean(), rough)
    assert bool(torch.isfinite(g).all()), g
    assert float(g.abs().max()) > 0.0
