"""The textured Cornell box of tests/test_textured_megakernel.py:16-26 on
both packages' builders.

``port_textured(w, h, big)`` builds it with the port's builder (no JAX, so
``tests/test_torch_cuda.py`` uses it on the card); ``jax_textured(w, h,
big)`` with the JAX package's, from the same recipe
(``fypraytracer_tpu_torch/scene/procedural.py::texture_quads``: the 64²
checker on a floor quad, and with ``big`` > 0 a seeded ``big``² noise
texture on a quad before the back wall whose UVs wrap and go negative).
Both compile the same triangles, materials and atlas, so the port's scene
may also be made from the JAX one with ``scene_from_arrays``.
"""

from fypraytracer_tpu_torch.scene import procedural as tproc

SEED = 2026
SPHERES = (6, 10)


def port_textured(width=32, height=32, big=0):
    """(host Scene, Camera) of the port."""
    builder, cam = tproc.textured_cornell_box(width, height, big=big, seed=SEED, sphere_res=SPHERES)
    return builder.compile(), cam


def jax_textured(width=32, height=32, big=0):
    """(Scene, Camera) of the JAX package, the same scene."""
    import fypraytracer_tpu.scene.procedural as jproc

    builder, cam = jproc.cornell_box(width=width, height=height, sphere_res=SPHERES)
    tproc.texture_quads(builder, big, SEED)
    return builder.compile(native=False), cam
