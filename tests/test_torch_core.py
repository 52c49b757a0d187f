"""core/ of the port against the JAX package on the same seeded inputs.

Two checks for every mathutils function:

1. The formula, in float64 on both sides: the port's function on float64
   tensors against the JAX module's function on float64 NumPy arrays
   (``_xp`` returns numpy for them), rtol 1e-10.  A wrong formula fails
   here whatever the machine.
2. The float32 accuracy, measured against that float64 result ``r``: the
   port's float32 error |g - r| and the JAX float32 error |w - r| over the
   whole array.  The port's largest error may be at most 4x JAX's largest
   (plus 1e-6), its 99.9th percentile at most 4x JAX's, and its mean error
   in units of the tolerance (atol 1e-6 + rtol 1e-5 |r|) at most 1.75x
   JAX's, so a port twice as inaccurate as JAX across the array fails.
   The share of its elements within that tolerance of ``r`` or of ``w``
   must reach the share of JAX's elements within it of ``r`` (capped at
   99%): float32 itself cannot hold 1e-5 on the ill-conditioned GGX pdfs,
   where only ~85% of JAX's own elements do.

The criterion this replaces held each element to "within 4x of the JAX
float32 error" wherever the two float32 results differed by more than
1e-5.  That error depends on how XLA compiles cos/sin/sqrt for the
machine's CPU: where XLA lands near float64 on an ill-conditioned GGX
element (near the lobe's peak D amplifies a 1-ulp change of n·h by
1/(1 - (n·h)²(1-α²)), up to ~2000 at roughness 0.15), the port's ordinary
float32 error exceeds 4x of a near-zero one.  On one x86 CPU 48 of 4,096
ggx_sample_hemisphere pdfs failed so (port 185.391, JAX 185.346, float64
185.332), and the GGX and BRDF cases passed or failed with the machine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fypraytracer_tpu.core import camera as jcamera
from fypraytracer_tpu.core import color as jcolor
from fypraytracer_tpu.core import mathutils as jm
from fypraytracer_tpu_torch.core import camera as tcamera
from fypraytracer_tpu_torch.core import color as tcolor
from fypraytracer_tpu_torch.core import mathutils as tm

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def _unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(7)
    normal = _unit(r, N)
    view = _unit(r, N)
    # keep most views in the normal's hemisphere, as shading sees them
    flip = (view * normal).sum(-1, keepdims=True) < 0
    view = np.where(flip & (r.uniform(size=(N, 1)) < 0.8), -view, view).astype(np.float32)
    metallic = r.uniform(size=N).astype(np.float32)
    metallic[: N // 4] = 0.0
    metallic[N // 4: N // 2] = 1.0
    return dict(
        normal=normal, view=view, l=_unit(r, N),
        albedo=r.uniform(size=(N, 3)).astype(np.float32),
        metallic=metallic,
        # the Cornell materials span roughness 0.15-1.0; below that the GGX D term
        # cancels (1 - ndh²(1-a²)) and a 1-ulp change of ndh moves pdfs past 1e-5
        roughness=r.uniform(0.15, 1.0, N).astype(np.float32),
        u1=r.uniform(size=N).astype(np.float32), u2=r.uniform(size=N).astype(np.float32),
        u_sel=r.uniform(size=N).astype(np.float32),
        cos=r.uniform(-0.2, 1.0, (N, 1)).astype(np.float32),
        oct=r.uniform(-1.0, 1.0, (N, 2)).astype(np.float32),
        pos=r.uniform(-2.0, 2.0, (N, 3)).astype(np.float32),
        proj_view=jcamera.Camera(position=(0.3, 1.1, 2.4), forward=(-0.1, -0.05, -1.0),
                                 width=48, height=32).proj_view,
    )


CASES = {
    "normalize": ("l",),
    "cross3": ("normal", "l"),
    "reflect": ("view", "normal"),
    "build_onb": ("normal",),
    "to_world": ("normal", "u1_", "u2_", "cos"),
    "cosine_sample_hemisphere": ("normal", "u1", "u2"),
    "cosine_hemisphere_pdf": ("cos",),
    "ggx_sample_hemisphere": ("normal", "view", "roughness", "u1", "u2"),
    "ggx_hemisphere_pdf": ("normal", "view", "l", "roughness"),
    "fresnel_schlick": ("albedo", "metallic", "cos"),
    "specular_weight": ("normal", "view", "albedo", "metallic"),
    "brdf_sample_hemisphere": ("normal", "view", "albedo", "metallic", "roughness", "u_sel", "u1", "u2"),
    "brdf_hemisphere_pdf": ("normal", "view", "l", "albedo", "metallic", "roughness"),
    "cook_torrance_brdf": ("normal", "view", "l", "albedo", "metallic", "roughness"),
    "uniform_sample_hemisphere": ("normal", "u1", "u2"),
    "encode_octahedral": ("l",),
    "decode_octahedral": ("oct",),
    "world_to_ndc": ("proj_view", "pos"),
    "ndc_to_uv": ("oct",),
}


def _arg(inputs, name):
    if name.endswith("_"):                 # (N, 1) column of a per-lane scalar
        return inputs[name[:-1]][:, None]
    return inputs[name]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("fn", sorted(CASES))
def test_mathutils_matches_jax(inputs, fn):
    args = [_arg(inputs, a) for a in CASES[fn]]
    args64 = [np.asarray(a, np.float64) for a in args]
    # 1. the formula, float64 on both sides
    got64 = _as_tuple(getattr(tm, fn)(*[torch.as_tensor(a) for a in args64]))
    ref64 = _as_tuple(getattr(jm, fn)(*args64))
    assert len(got64) == len(ref64)
    for g, r in zip(got64, ref64):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-10, atol=1e-12)
    # 2. float32 accuracy against float64, over the whole array
    want = _as_tuple(getattr(jm, fn)(*[jnp.asarray(a) for a in args]))
    got = _as_tuple(getattr(tm, fn)(*[torch.as_tensor(a) for a in args]))
    assert len(got) == len(want) == len(ref64)
    for g, w, r in zip(got, want, ref64):
        assert g.dtype == torch.float32
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        err_g, err_w = np.abs(g - r), np.abs(w - r)
        tol = ATOL + RTOL * np.abs(r)
        assert err_g.max() <= 4.0 * err_w.max() + ATOL, (err_g.max(), err_w.max())
        assert np.quantile(err_g, 0.999) <= 4.0 * np.quantile(err_w, 0.999) + 1e-12
        assert np.mean(err_g / tol) <= 1.75 * np.mean(err_w / tol) + 1e-6, \
            (np.mean(err_g / tol), np.mean(err_w / tol))
        close = (err_g <= tol) | (np.abs(g - w) <= ATOL + RTOL * np.abs(w))
        assert close.mean() >= min(0.99, (err_w <= tol).mean()), close.mean()


def test_uniform_hemisphere_pdf_matches_jax():
    assert tm.uniform_hemisphere_pdf() == jm.uniform_hemisphere_pdf()


def test_dot3_order_and_shape():
    r = np.random.default_rng(3)
    a, b = (torch.as_tensor(r.normal(size=(64, 5, 3)).astype(np.float32)) for _ in range(2))
    p = a * b
    want = (p[..., 0] + p[..., 1]) + p[..., 2]
    assert torch.equal(tm.dot3(a, b, keepdims=False), want)
    assert tm.dot3(a, b).shape == (64, 5, 1)


@pytest.mark.parametrize("size", [(48, 32), (17, 9)])
def test_generate_rays_matches_jax(size):
    w, h = size
    cam = jcamera.Camera(position=(0.3, 1.1, 2.4), forward=(-0.1, -0.05, -1.0), vfov_deg=50.0,
                         width=w, height=h)
    jo, jd = jcamera.generate_rays(jnp.asarray(cam.inv_projection), jnp.asarray(cam.inv_view), w, h, xp=jnp)
    to, td = tcamera.generate_rays(cam.inv_projection, cam.inv_view, w, h)
    assert td.shape == (w * h, 3) and to.shape == (w * h, 3)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
    # the port's Camera is the same host class
    tcam = tcamera.Camera(position=(0.3, 1.1, 2.4), forward=(-0.1, -0.05, -1.0), vfov_deg=50.0,
                          width=w, height=h)
    np.testing.assert_array_equal(tcam.inv_view, cam.inv_view)
    np.testing.assert_array_equal(tcam.inv_projection, cam.inv_projection)


def test_color_matches_jax():
    r = np.random.default_rng(11)
    hdr = r.uniform(0.0, 20.0, (32, 32, 3)).astype(np.float32)
    hdr[0, 0, 0], hdr[1, 1, 1], hdr[2, 2, 2] = np.nan, np.inf, -np.inf
    for frames in (1.0, 7.0):
        want = np.asarray(jcolor.finalize_pixels(jnp.asarray(hdr), jnp.float32(frames)))
        got = tcolor.finalize_pixels(torch.as_tensor(hdr), frames)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        assert got[0, 0, 0] == 0.0 and got[1, 1, 1] == 0.0
    rgb = tcolor.finalize_pixels(torch.as_tensor(hdr), 3.0)
    packed = tcolor.pack_abgr(rgb)
    np.testing.assert_array_equal(packed.numpy().astype(np.uint32),
                                  np.asarray(jcolor.pack_abgr(jnp.asarray(rgb.numpy()))))
    np.testing.assert_allclose(tcolor.unpack_abgr(packed).numpy(),
                               np.asarray(jcolor.unpack_abgr(jnp.asarray(packed.numpy().astype(np.uint32)))))
    np.testing.assert_array_equal(tcolor.to_uint8_rgb(rgb).numpy(),
                                  np.asarray(jcolor.to_uint8_rgb(jnp.asarray(rgb.numpy()))))
