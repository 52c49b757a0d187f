"""K2's pixel-slab entry and the camera rays it keys on, on the CPU.

* ``megakernel_plain(..., pix0=, n_pix=)`` slabs join into the one-call
  image bit for bit, at any boundary (the JAX witness: tests/test_chunked.py:31);
* the port's plain slab against JAX ``make_megakernel(chunk_rows=...)(...,
  pix0=)`` in interpret mode at 64², 2 slabs, under the parity gates of
  tests/test_render_parity.py:111-114;
* ``generate_rays`` on pixel subsets equals the full grid's rays bit for bit;
* the plain camera rays equal a float64 model of ``csrc/shading.cuh::
  camera_ray`` that rounds every step to float32 once (the kernel's IEEE
  float32 operations), at 40x16, 80x48 and 256².  The kernels' own rays are
  held to the same on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.core.camera import Camera, generate_rays
from fypraytracer_tpu_torch.render import megakernel as tmk
from fypraytracer_tpu_torch.scene import procedural as tproc

SKY = (0.05, 0.06, 0.08)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(tech, **kw):
    return RenderSettings(technique=SamplingTechnique[tech], **dict(dict(bounces=2, samples=1, sky_color=SKY), **kw))


# (technique, width, height, slab starts): a ragged last slab, and slabs
# that end off any multiple of K2's block (128 threads) or lanes (1, 2, 4)
SLABS = [("NEE_MIS", 16, 16, (0, 77, 128, 131, 256)), ("COSINE", 24, 10, (0, 1, 119, 240)),
         ("LIGHT_SOURCE", 16, 12, (0, 100, 101, 192)), ("BRDF", 12, 12, (0, 63, 144)),
         ("BRUTE_FORCE", 12, 12, (0, 97, 144)), ("GGX", 12, 12, (0, 5, 144)), ("UNIFORM", 12, 12, (0, 72, 144))]


@pytest.mark.parametrize("tech, w, h, starts", SLABS, ids=[s[0] for s in SLABS])
def test_plain_slabs_join_into_the_image(tech, w, h, starts):
    builder, cam = tproc.cornell_box(w, h, sphere_res=(6, 10))
    scene = builder.compile().to("cpu")
    st = _settings(tech)
    whole = tmk.megakernel_plain(scene, cam, 3, 2, st)
    assert whole.shape == (w * h, 3) and float(whole.mean()) > 0.0
    parts = [tmk.megakernel(scene, cam, 3, 2, st, pix0=a, n_pix=b - a) for a, b in zip(starts, starts[1:])]
    assert [p.shape[0] for p in parts] == [b - a for a, b in zip(starts, starts[1:])]
    assert torch.equal(torch.cat(parts), whole)


def test_textured_plain_slabs_join_into_the_image():
    from torch_textured_scene import port_textured

    scene, cam = port_textured(16, 16, 64)
    scene = scene.to("cpu")
    st = _settings("NEE_MIS")
    whole = tmk.megakernel_plain(scene, cam, 1, 2, st)
    parts = [tmk.megakernel_plain(scene, cam, 1, 2, st, pix0=a, n_pix=b - a) for a, b in ((0, 93), (93, 256))]
    assert torch.equal(torch.cat(parts), whole)


def test_slab_outside_the_image_raises():
    builder, cam = tproc.cornell_box(8, 8)
    scene = builder.compile().to("cpu")
    for pix0, n in ((60, 5), (-1, 3), (0, 65)):
        with pytest.raises(ValueError, match="leaves"):
            tmk.megakernel(scene, cam, 1, 1, _settings("COSINE"), pix0=pix0, n_pix=n)
    assert tmk.megakernel(scene, cam, 1, 1, _settings("COSINE"), pix0=64, n_pix=0).shape == (0, 3)


@pytest.mark.parametrize("sampler", ["nee", "cosine"])
def test_plain_slab_matches_jax_chunk_entry(sampler):
    """Two slabs of 2,048 pixels at Cornell 64² (C = 512 lanes, 4 kernel
    rows a slab): the port's plain slab against the JAX megakernel's chunk
    entry (``pix0``) in interpret mode, Morton order in both."""
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.render import megakernel as MK
    from fypraytracer_tpu.scene.procedural import cornell_box

    builder, cam = cornell_box(width=64, height=64)
    mscene, _ = MK.morton_permuted_scene(builder.compile())
    dscene = jax.tree_util.tree_map(jnp.asarray, mscene)
    P, AT = MK.prepare_scene_tables(dscene)
    L, depth = MK.prepare_light_table(dscene)
    render = MK.make_megakernel(64, 64, bounces=2, samples=1, sky_color=SKY, n_frames=2,
                                n_tris=mscene.geometry.tri_v.shape[0], sampler=sampler,
                                n_light_nodes=L.shape[1], light_depth=depth, frame_group=2, ray_lanes=512,
                                chunk_rows=4, interpret=True)
    cam_mats = jnp.concatenate([jnp.asarray(cam.inv_projection), jnp.asarray(cam.inv_view)], axis=0)
    kw = {"L": L} if sampler == "nee" else {}

    tbuilder, tcam = tproc.cornell_box(64, 64)
    tscene = tmk.morton_permuted_scene(tbuilder.compile())[0].to("cpu")
    st = _settings("NEE_MIS" if sampler == "nee" else "COSINE")
    for pix0 in (0, 2048):
        ref = np.asarray(render(cam_mats, P, AT, jnp.asarray([[1]], jnp.int32), pix0=jnp.int32(pix0), **kw))
        got = tmk.megakernel(tscene, tcam, 1, 2, st, pix0=pix0, n_pix=2048).numpy()
        assert ref.shape == got.shape == (2048, 3)
        diff = np.abs(got.astype(np.float64) - ref)
        assert float(np.median(diff)) < 1e-5
        assert (diff.max(axis=-1) > 1e-3).mean() < 0.01
        assert abs(got.mean() - ref.mean()) / ref.mean() < 0.01


CAMERAS = [(40, 16), (80, 48), (256, 256), (17, 9)]


@pytest.mark.parametrize("w, h", CAMERAS, ids=[f"{w}x{h}" for w, h in CAMERAS])
def test_rays_of_a_pixel_subset_equal_the_full_grid(w, h):
    cam = Camera(position=(0.3, 1.1, 2.4), forward=(-0.1, -0.05, -1.0), vfov_deg=50.0, width=w, height=h)
    o, d = generate_rays(cam.inv_projection, cam.inv_view, w, h)
    pix = torch.as_tensor(np.random.default_rng(w * h).permutation(w * h)[: w * h // 3])
    so, sd = generate_rays(cam.inv_projection, cam.inv_view, w, h, pixel_x=pix % w, pixel_y=pix // w)
    assert torch.equal(sd, d[pix]) and torch.equal(so, o[pix])
    slab = torch.arange(w * h // 2, w * h)
    _, sd = generate_rays(cam.inv_projection, cam.inv_view, w, h, pixel_x=slab % w, pixel_y=slab // w)
    assert torch.equal(sd, d[w * h // 2:])


def camera_ray_model(ip, iv, w, h):
    """``csrc/shading.cuh::camera_ray`` in float64, every operation rounded
    once to float32 (each is exact in float64 before the rounding, or for
    the root rounds as the correctly rounded float32 root: 53 >= 2·24 + 2)."""
    def r(x):
        return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)

    ip, iv = np.asarray(ip, np.float64), np.asarray(iv, np.float64)
    pix = np.arange(w * h)
    cx = r(r(r((pix % w) / w) * 2.0) - 1.0)
    cy = r(1.0 - r(r((pix // w) / h) * 2.0))

    def ip_row(k):
        return r(r(r(r(ip[k, 0] * cx) + r(ip[k, 1] * cy)) + ip[k, 2]) + ip[k, 3])

    tw = ip_row(3)
    t = [r(ip_row(k) / tw) for k in range(3)]
    norm = r(np.sqrt(np.maximum(r(r(r(t[0] * t[0]) + r(t[1] * t[1])) + r(t[2] * t[2])), r(1e-20))))
    d = [r(x / norm) for x in t]
    out = [r(r(r(iv[k, 0] * d[0]) + r(iv[k, 1] * d[1])) + r(iv[k, 2] * d[2])) for k in range(3)]
    return np.stack(out, axis=-1).astype(np.float32)


@pytest.mark.parametrize("w, h", CAMERAS[:3], ids=[f"{w}x{h}" for w, h in CAMERAS[:3]])
@pytest.mark.parametrize("scene", ["cornell", "stress"])
def test_plain_rays_round_as_the_kernels(w, h, scene):
    """Before the repair, PyTorch's float32 root on the CPU (not correctly
    rounded for every input) parted from this model at 35 of 3,840 rays at
    80x48; on a CUDA tensor the divisions by W and H (a product with the
    reciprocal of a Python scalar) parted wherever W or H is no power of
    two (ROADMAP queue 3)."""
    if scene == "cornell":
        _, cam = tproc.cornell_box(w, h)
    else:
        # scene/procedural.py::stress's camera, without its 200,712 triangles
        cam = Camera(position=(0.0, 2.0, 4.5), forward=(0.0, -0.1, -1.0), vfov_deg=50.0, width=w, height=h)
    _, d = generate_rays(cam.inv_projection, cam.inv_view, w, h)
    want = camera_ray_model(cam.inv_projection, cam.inv_view, w, h)
    off = (d.numpy() != want).any(-1)
    assert not off.any(), f"{int(off.sum())} of {w * h} rays differ"
