"""fypraytracer_tpu_torch — the path tracer on PyTorch and CUDA.

A port of ``fypraytracer_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  The layout mirrors the JAX package module for module, so each
module's counterpart is found by path; the JAX package stays the
reference every port module is tested against at matched seeds.

What this package covers: the nine sampling techniques on untextured and
textured scenes, and training, through these entry points:

  * ``render.renderer.Renderer`` — the wavefront renderer for techniques
    0-8; on CUDA tensors its closest-hit trace is the hand-written kernel
    ``csrc/trace.cu`` (``ops.traverse.trace_closest``), a walk of the
    scene's 4-wide BVH (``accel.wide``);
  * ``render.megakernel.MegakernelRenderer`` — N frames of techniques 0-6
    per pixel in one hand-written kernel, ``csrc/megakernel.cu``, which
    walks the same 4-wide BVH;
  * ``render.megakernel_restir.MegakernelReSTIRDI`` and
    ``render.megakernel_restir_gi.MegakernelReSTIRGI`` — ReSTIR DI and GI
    as hand-written kernels a frame, ``csrc/restir_di.cu`` and
    ``csrc/restir_gi.cu``;
  * ``render.megakernel_diff.DiffRenderer`` — the loss of one cosine frame
    and its albedo gradient in one kernel, ``csrc/megakernel_diff.cu``;
  * ``parallel.shard.make_train_step`` — a training step by torch autograd
    through the wavefront integrators;
  * ``app.cli`` (``render``, ``benchmark``, ``train``) and
    ``app.interactive`` — the JAX package's command line and live-edit
    session on these entry points, with scene files (``scene.sceneio``),
    OBJ meshes, scene edits (``scene.manager``), the C++ structure
    builders (``accel.native``) and checkpoints (``utils.checkpoint``).

A material with an albedo map reads the scene's atlas
(``ops.texture``); K2, K3, K5 and K6 are built a second time with that
fetch, which a textured scene launches.  ``DiffRenderer`` refuses
textured scenes (its JAX kernel has no textured path).  On CPU tensors the
entry points run their plain PyTorch versions; on CUDA tensors they launch
the kernels or raise, and each call reads the walks' stack-overflow flag
(``ops.traverse.OverflowWatch``).  The package imports ``torch``
and ``numpy`` only: the host builders (BVH, light tree, scene compiler)
are NumPy copies, so it imports on a machine without JAX.
"""

__version__ = "0.1.0"

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique  # noqa: F401
