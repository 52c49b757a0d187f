#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``fypraytracer_tpu_torch`` — and nothing of the JAX package — through
its main paths: the Cornell box under NEE+MIS (2 bounces, 1 spp), every other
technique 0-8, the 200,712-triangle stress scene under NEE, ReSTIR DI and
ReSTIR GI, textured albedo, training (inverse rendering of the Cornell
albedos), the multi-device layer and the app layer (the CLI and the
interactive session), in phases:

  1. environment: the card's name and power limit, torch and CUDA versions;
     TF32 is switched off for matmuls and cuDNN;
  2. build: the five kernel sources compiled from ``csrc/`` with nvcc, one
     nvcc per source, started together, with K8 again without its
     gradient's atomics (``-DFYP_DIFF_NO_ATOMICS``, for phase 5c), K2
     again with its section clocks (``-DFYP_K2_CLOCKS``, for phase 4b),
     K5-K7 with theirs (``-DFYP_GI_CLOCKS``, K7's with its block spans and
     walk counters, for phase 5b), K3, K4 and K8 with theirs and their block
     spans (``-DFYP_DI_CLOCKS``, ``-DFYP_DIFF_CLOCKS``, for phases 5 and
     5c); ptxas's
     registers and spills of every kernel, the untextured and the textured
     instantiations and K8's bounce counts by name; every K2 instantiation's
     registers, spills (none allowed) and resident blocks a multiprocessor
     with Cornell's and the stress scene's stacks (``k2_build``), the
     same of every K5 and K6 instantiation (``gi_build``), no spill in
     any K3, K4, K7 or K8 instantiation, and K3 at 64 registers or fewer
     (two blocks of 512 a multiprocessor);
  3. K1 ``trace_closest`` against its plain PyTorch walk on the card, as the
     wrapper picks its lanes: on the 256² camera's 65,536 rays and 65,536
     random rays (a quad a ray) and on the 1920x1088 camera's rays (one
     thread a ray); then both its walks of the wide BVH (``lanes=4``,
     ``lanes=1``) against the plain walk (``trace_rays``), bit for bit, and
     timed in turns (quad, one thread, one thread, quad) on 65,536 camera
     rays, 65,536 random rays and the 512² and 1920x1088 cameras' rays,
     with the node and leaf visits a ray of both plain walks;
  3b. the wide segment test that K5 walks (``trace_segments``) against its
     plain twin ``segment_visible_wide`` and the threaded ``segment_visible``,
     bit for bit, on 65,536 segments ending at, within, past and short of
     their rays' closest hits, on Cornell and the stress scene, timed;
  4. K2 ``megakernel`` against its plain version under the parity gates of
     tests/test_render_parity.py:111-114: every technique 0-6 at the main
     path's shape (Cornell 256², 8 frames, 2 bounces, 1 spp) and NEE on the
     stress scene at 128², 8 frames; then at 64², 4 frames, NEE with 1
     bounce and with 2 spp, the other samplers, and light sampling at 4 spp
     without spheres and sky (the DI unbiasedness check's settings);
  4b. K2 timed in turns through its wrapper with 1, 2 and 4 threads a
     pixel (``megakernel(..., lanes=)``): under NEE at Cornell 256² (1, 2,
     8 and 64 frames), 512² (8 frames), 1920x1088 (1, 2 and 8 frames) and
     stress 128² (8 frames); every other sampler with 1 and 4 threads a
     pixel at Cornell 256², 8 frames; with each kernel's resident blocks a
     multiprocessor (the CUDA runtime's occupancy) and the pixels that
     differ from the first kernel's (more than one thread a pixel adds
     the frames in another order); the walks' stack-overflow flag must
     stay clear; then where K2 NEE's time goes (``k2_attribution``: each
     section's share of its threads' cycles, by the clocked build, at
     Cornell 256² over 64 frames, stress 128² and Cornell 1920x1088 over
     8, and the clocks' cost in turns);
  5. K3 ``restir_di_k3`` (the wide walk; each tile one block, or split over
     a cluster of blocks of 128 where the tiles are too few to fill the
     card) and K4 ``restir_di_k4`` (the wide walk, blocks of 128) each
     against its plain version on the same inputs, and the frame loop of
     both against ``restir_di_megakernel_plain``: 128², 8 frames on the
     stress scene, and 64², 4 + 4 frames on Cornell with a camera move in
     between; K3 (both launches) and K4 against their plain versions on
     Cornell 256² with the rough sphere emissive (578 emitters, more than
     K3's p-hat table holds: ``many_emitter_di``); then K3's and K4's
     device time a launch at Cornell 256²,
     stress 128² and Cornell 1920x1088, K3 as the wrapper picks its launch
     and both launches in turns (split, one block, one block, split), each
     beside its resident blocks and clusters (the CUDA runtime's
     occupancy; the registers and spills are phase 2's); then where K3's
     and K4's time goes (``di_attribution``: each section's share of their
     threads' cycles and the share of the launch after its median block
     has ended, by the clocked build, at the same three shapes, K3 also
     split where the wrapper picks one block a tile, and the clocks' cost
     in turns);
  5b. K5 ``restir_gi_mono`` (per-neighbour visibility and ``final_vis``), K6
     ``restir_gi_k1`` (both with the wide walks, tiles launched as K3's) and
     K7 ``restir_gi_k2`` (the wide walks, blocks of 128) each against its
     plain version on the same inputs
     (Cornell 256², one frame after two of history); the K5 frame loop
     against ``restir_gi_megakernel_plain`` at Cornell 256², 8 frames, and
     stress 128², 4 frames; K5 ``final_vis`` and the K6+K7 loop at Cornell
     64², 4 + 4 frames with a camera move; then K5 (both modes), K6 and K7
     timed at the shapes of phase 5 with their occupancy, K5's and K6's two
     launches also at 32-128 tiles (``BETWEEN``); then where K5's and K6's time goes
     (``gi_attribution``: each section's share of the threads' cycles by
     the clocked build at the three shapes, and the clocks' cost in turns)
     and K7's (``k7_attribution``: its section shares, its launch's tail,
     and its visibility walks: walking lanes a round, rounds a warp over
     its longest list);
  5c. K8 ``diff_megakernel`` (the fused loss and albedo gradient) against its
     plain version ``diff_plain`` on the same inputs (Cornell 256², 2 bounces,
     frame 3, a seeded target; the loss within 1e-5 relative, d_tri and d_mat
     within 1e-4 of their largest entry), its d_mat against torch autograd of
     the port's cosine wavefront on the card (K1 traces; 1e-4, 1e-3), and one
     launch per ``DiffRenderer.loss_and_grad``; where its time goes
     (``k8_attribution``, at Cornell 256², stress 128² and Cornell
     1920x1088 with 2 bounces and at 256² with 4: each section's share of
     its threads' cycles and the share of the launch after its median
     block has ended, by the clocked build, the clocks' cost in turns, and
     at 256² with 2 bounces the kept kernel against the one without its
     gradient's atomics, in turns); and its device ms a launch at the same
     four cases;
  5d. textured: on the textured Cornell box at 256² (the 64² checker and a
     seeded 1024² page, which the kernels' primary level box-filters to
     256²), K2's textured instantiation under NEE, cosine and light
     sampling (8 frames) against ``megakernel_plain`` under the parity gates,
     with its difference from the native-mip-0 wavefront printed (the
     documented deviation, no gate); K3's textured instantiation alone
     against its plain version and the K3+K4 frame loop; K5 (both modes)
     and K6 textured, one frame after two of history, and the K5, K5
     ``final_vis`` and K6+K7 frame loops; textured ReSTIR DI's mean within
     5% of light sampling's at 64²;
  6. the main paths, each with the kernels' launch counters reset just before
     and read just after: Cornell at 256² through ``Renderer`` and
     ``MegakernelRenderer`` under NEE, 8 frames, scored against
     ``benchmarks/goldens/cornell_nee.png`` (PSNR >= 35 dB, mean8 >= 3);
     ``MegakernelRenderer`` for every other technique 0-5 at 256²; the stress
     scene at 128², 8 frames, through ``MegakernelRenderer`` (NEE) and
     ``MegakernelReSTIRDI``, scored against ``stress_nee.png`` and
     ``stress_di.png``; and ReSTIR DI's image mean over 64 frames against the
     light-sampling megakernel's over 256 frames (within 5%); Cornell at 256²,
     8 frames, through ``MegakernelReSTIRGI`` (mono per-neighbour, mono
     ``final_vis``, ``mono=False``) and the wavefront ``Renderer`` under
     ReSTIR GI; and GI's unbiasedness at 64² without spheres: mono and
     ``mono=False`` against the K2 BRDF path tracer at 4 spp (mean within 6%,
     quadrants within 15%), ``final_vis`` against per-neighbour visibility
     with spheres (5%, 12%), tests/test_megakernel_restir.py:158-286; the
     textured Cornell box at 256², 8 frames, through ``MegakernelRenderer``
     (NEE, cosine, light), ``MegakernelReSTIRDI`` and ``MegakernelReSTIRGI``
     (mono, ``final_vis``, ``mono=False``);
  6b. training at Cornell 256², each entry point with the counters reset just
     before and read just after: the JAX CLI's ``_train_fast`` loop through
     ``DiffRenderer`` (targets: the cosine wavefront's frames 1-3, as in
     tests/test_diff_megakernel.py:93; albedo perturbed by a seeded normal
     of 0.25, clipped to [0.05, 0.95]; 9 steps at lr 3.0; the albedo error
     must fall below 0.6 of its start, the loss fall, and K8 launch 9
     times), and 5 SGD steps of ``make_train_step``
     under NEE (the albedo, lr 30) in which the loss falls and K1 launches;
  6c. the multi-device layer (``parallel/``) on the one card: K2's pixel
     slabs (2, 3 and 7, the last ragged) against its one launch, bit for
     bit: NEE with 1 and 4 lanes at Cornell 1920x1088, NEE on the stress
     scene and the textured Cornell box at 256², every other sampler at
     256²; every sharded path (``sharded_megakernel_render``,
     ``sharded_render``, the sharded DI and GI wavefronts, the NEE, DI and GI
     train steps) at world size 1 under NCCL against its single-device entry
     point, bit for bit, with the counters reset before each path and read
     after; the same paths at world size 2 as two processes that share the
     card under gloo (every collective staged through host memory: NCCL
     refuses two ranks on one device) against world size 1; and timings:
     the fast path against ``MegakernelRenderer.render_many(64)`` in turns,
     the halo exchange's ms a frame (world 2, gloo, host-staged) and the
     NEE train step's ``all_reduce`` ms a step (world 1, NCCL);
  6d. the app layer, driven in process (``app/cli.py::main`` with ``--device
     cuda``, ``app/interactive.py::InteractiveSession``), each call with the
     counters reset just before and read just after: ``render --impl
     megakernel --frames 8`` at Cornell 256² (K2 NEE; the saved PNG scored
     against cornell_nee.png), ``benchmark`` of the nine techniques at 64
     frames against 256 frames of NEE at 4 spp (every row on the megakernel
     path; every K2 sampler, K3, K4 and K5 launched, by ``launch_log``),
     then ``--gi-fast`` (K5's final_vis instantiation); ``train --impl
     megakernel`` (9 steps, K8, the loss falls) and ``train`` (2 NEE
     wavefront steps, K1); a ReSTIR GI render checkpointed every 16 frames,
     stopped after 16 and resumed to 32, against an uninterrupted 32 (the
     accumulation, state and stage bit for bit); an interactive script
     (K1; a material edit and a sphere added); and the stress scene built
     by the C++ and the NumPy builders (host seconds; each NEE image
     against stress_nee.png);
  7. timing with CUDA events: the median of 5 reps after a warm-up, of
     ``render_many(64)`` for the K1 wavefront and the K2 megakernel (every
     technique) at 256², NEE also at 1920x1088, ``MegakernelReSTIRDI`` and
     ``MegakernelReSTIRGI`` (mono in both visibility modes) at 256² and
     1920x1088, GI ``mono=False`` at 256², the stress paths at 128², and of
     ``render_many(8)`` for the plain PyTorch wavefront (NEE) and the K1
     wavefront under ReSTIR DI and GI at 256²; K2 NEE, ``MegakernelReSTIRDI``
     and ``MegakernelReSTIRGI`` on the textured Cornell box at 256² and
     1920x1088; the stack-overflow watch's cost (``MegakernelRenderer`` NEE
     at 256² with and without it, in turns); for the NEE K1 and K2 paths and
     the ReSTIR paths on Cornell, the card's busy time per frame from
     torch.profiler and the idle share it implies.  The profiler's first
     step is a warm-up it discards; the kept step is "not measured" (null)
     unless its trace holds every launch of the port's kernels that the
     wrappers counted in it.  Training: ``DiffRenderer.step`` (median of 5
     reps of 10 steps), K8 per launch against its plain version, and
     ``make_train_step`` under NEE and cosine (median of 5 reps of 2 steps),
     each with the card's busy time and idle share.

Every kernel's ``ms`` is its own time on the card: torch.profiler's self
device time of its launches over at least 20 launches at the parity shape
(5-10 in the walk comparisons of phases 3 and 4b), over their number;
``wrapper_ms`` is the older measure, CUDA events around one call of the
wrapper, which adds the wrapper's host work when the queue is idle.
Every kernel's summary carries ``bound_ms``: the larger of its operations
over the card's float32 rate and its bytes over its memory rate.  The
operations are those of its BVH walks, counted in the plain version's run
on the same inputs (``trace_rays(..., counts=...)``: box tests and
Möller–Trumbore tests, NODE_FLOPS and TRI_FLOPS each; the plain time is
taken with the counting on, one reduction a leaf step); shading arithmetic
is not counted, so the bound is low.  The bytes are what the kernel reads,
once, and what it writes, once: the scene tables it reads, the camera,
the rows of the state and stage it reads (a ReSTIR GI state row at the
pixels that shade, since only they read it) and its outputs; a textured
instantiation adds its texel reads, 4 texels of 12 bytes a fetch times the
fetches its plain version counts (at most the texture tables once).

``--ab`` times K2 (``K2_AB``: NEE at Cornell 256², stress 128² and
1920x1088, every other sampler at 256²), K3-K8 and the entry points of
other checkouts against this one in turns (e.g. the commit before a
change), with K2 NEE's ``k2_attribution`` in each tree whose K2 has the
section clocks, K5's and K6's ``gi_attribution`` in each tree whose
restir_gi.cu has them and K7's ``k7_attribution`` where its K7 has them,
compares their ReSTIR outputs bit for bit (``restir_bits``) and holds K8's
loss and gradient to phase 5c's gates.

Each phase prints one JSON line; any failure exits non-zero.  The line before
the last is the kernels' summary, the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --quick    # phases 1-6d: build, check, main paths
    python3 chip_smoke.py --ab DIR [DIR ...]  # untextured entry points, K2 and
                                     # K3-K8 a launch: each DIR's package against
                                     # this one's, in turns (ab_turn)
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(REPO, "benchmarks", "goldens")
SKY = (0.05, 0.06, 0.08)
PSNR_FLOOR = 35.0   # benchmarks/tpu_smoke.py:34
MEAN_FLOOR = 3.0    # benchmarks/tpu_smoke.py:36

CARD: dict = {}

# H100 SXM, dense, at 700 W (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float operations of one box test and of one Möller–Trumbore test as
# csrc/traverse.cuh writes them (6 subtractions and 6 products, 10 min/max,
# 3 compares; 2 edge differences, 2 crosses, 3 dots, 1 division, 3 products,
# the difference o - p0 and 6 compares/sums)
NODE_FLOPS = 25
TRI_FLOPS = 59


def emit(phase: str, **row) -> None:
    print(json.dumps({"phase": phase, **CARD, **row}), flush=True)


def gpu_ms(fn, reps: int) -> list[float]:
    """Device milliseconds of ``fn()`` per rep, by CUDA events."""
    import torch

    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def parity(got, ref) -> dict:
    """The gates of tests/test_render_parity.py:111-114."""
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    row = dict(median_abs=float(np.median(diff)),
               frac_px_over_1e3=float((diff.reshape(-1, 3).max(-1) > 1e-3).mean()),
               mean_rel=float(abs(got.mean() - ref.mean()) / ref.mean()),
               max_abs=float(diff.max()))
    row["ok"] = bool(row["median_abs"] < 1e-5 and row["frac_px_over_1e3"] < 0.01
                     and row["mean_rel"] < 0.01)
    return row


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def scene_bytes(scene, surfaces=True, lights=False, wide=False, positions=False) -> int:
    """Bytes of the scene tables a kernel reads: the BVH and the triangles it
    walks, which for the threaded BVH are the positions and vertex ids and
    for the wide BVH (``wide``) its node and triangle records alone; the
    positions beside the wide records only where ``positions`` (K2's light
    samples); with ``surfaces`` the vertex ids, normals, material ids and
    materials; with ``lights`` the light tree."""
    import dataclasses

    g, m, b = scene.geometry, scene.materials, scene.bvh
    if wide:
        ts = [scene.wide.nodes, scene.wide.tris] + ([g.positions] if positions else [])
    else:
        ts = [g.positions, g.tri_v, b.lo, b.hi, b.miss, b.first, b.prim_idx]
    if surfaces:
        ts += ([g.tri_v] if wide else []) + [g.normals, g.tri_mat, m.albedo, m.roughness, m.metallic,
                                             m.emission_color, m.emission_power]
    if lights:
        lt = scene.light_tree
        ts += [t for t in (getattr(lt, f.name) for f in dataclasses.fields(lt)) if hasattr(t, "numel")]
    return nbytes(*ts)


def bound(walks: dict, n_bytes: int) -> dict:
    """The least time of the work: the BVH walks' operations over the
    float32 rate against the bytes over the memory rate."""
    flops = walks["nodes"] * NODE_FLOPS + walks["tris"] * TRI_FLOPS
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=n_bytes, library_ms=None)


@contextlib.contextmanager
def count_walks():
    """Count the node visits and triangle tests of every plain BVH walk
    inside the block: the port's plain modules' ``trace_rays`` is swapped
    for one that passes a ``counts`` dict.  Yields the dict, whose values
    are ints once the block has ended."""
    from unittest import mock

    from fypraytracer_tpu_torch.ops import traverse
    from fypraytracer_tpu_torch.render import megakernel, megakernel_diff, megakernel_restir, megakernel_restir_gi

    counts = {"nodes": 0, "tris": 0}
    walk = functools.partial(traverse.trace_rays, counts=counts)
    with contextlib.ExitStack() as stack:
        for mod in (traverse, megakernel, megakernel_restir, megakernel_restir_gi, megakernel_diff):
            stack.enter_context(mock.patch.object(mod, "trace_rays", walk))
        yield counts
    counts["tris"] = int(counts["tris"])
    if counts["nodes"] == 0:
        raise AssertionError("count_walks: the block ran no plain walk")


def settings_for(technique: str, **kw):
    """The main path's settings (2 bounces, 1 spp, the goldens' sky) for a
    technique named as in ``SamplingTechnique``."""
    from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique

    kw = dict(dict(bounces=2, samples=1, sky_color=SKY), **kw)
    return RenderSettings(technique=SamplingTechnique[technique], **kw)


def port_wrappers() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches."""
    from fypraytracer_tpu_torch.ops.traverse import trace_closest, trace_segments
    from fypraytracer_tpu_torch.render import megakernel_restir as mr
    from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg
    from fypraytracer_tpu_torch.render.megakernel import megakernel
    from fypraytracer_tpu_torch.render.megakernel_diff import diff_megakernel

    return dict(trace_closest=trace_closest, megakernel=megakernel, restir_di_k3=mr.restir_di_k3,
                restir_di_k4=mr.restir_di_k4, restir_gi_mono=mg.restir_gi_mono,
                restir_gi_k1=mg.restir_gi_k1, restir_gi_k2=mg.restir_gi_k2, diff_megakernel=diff_megakernel,
                trace_segments=trace_segments)


def reset_launches() -> None:
    for w in port_wrappers().values():
        w.launches = 0


def launch_counts() -> dict:
    return {name: w.launches for name, w in port_wrappers().items()}


# K2's entries: the kernel's name in the summary for each technique
K2_NAMES = {"BRUTE_FORCE": "megakernel[brute]", "UNIFORM": "megakernel[uniform]",
            "COSINE": "megakernel[cosine]", "GGX": "megakernel[ggx]", "BRDF": "megakernel[brdf]",
            "LIGHT_SOURCE": "megakernel[light]", "NEE_MIS": "megakernel[nee]"}


@functools.lru_cache(maxsize=None)
def stress_scene(width: int, height: int):
    """The stress scene on the card, triangles in the JAX megakernels' Morton
    order (the numbering its goldens were rendered with), and its camera;
    built once per size."""
    from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
    from fypraytracer_tpu_torch.scene.procedural import stress

    t0 = time.perf_counter()
    builder, cam = stress(width, height)
    scene = builder.compile()
    build_s = time.perf_counter() - t0
    scene = morton_permuted_scene(scene)[0].to("cuda")
    emit("stress_scene", triangles=int(scene.geometry.tri_v.shape[0]),
         numpy_build_seconds=build_s, emissive=int(scene.emissive_tris.shape[0]), **wide_sizes(scene))
    return scene, cam


def wide_sizes(scene) -> dict:
    """The sizes of a scene's binary and wide BVHs."""
    w = scene.wide
    return dict(binary_nodes=int(scene.bvh.lo.shape[0]), wide_nodes=int(w.nodes.shape[0]),
                leaf_slots=int(w.tris.shape[0]), wide_bytes=nbytes(w.nodes, w.tris), wide_depth=w.depth,
                stack_need=w.stack_need)


def score(avg, golden_name: str, expect_shape) -> dict:
    """Finite, of the expected shape, and PSNR/mean8 against a golden."""
    import torch

    from fypraytracer_tpu_torch.core.color import finalize_pixels, to_uint8_rgb

    finite = bool(torch.isfinite(avg).all())
    row = score_rgb8(to_uint8_rgb(finalize_pixels(avg, 1.0)).cpu().numpy(), golden_name, expect_shape)
    row.update(finite=finite, ok=bool(row["ok"] and finite))
    return row


def score_rgb8(rgb8, golden_name: str, expect_shape) -> dict:
    """An 8-bit image (a render's saved PNG): of the expected shape, mean8,
    and PSNR against a golden."""
    from fypraytracer_tpu_torch.utils import metrics
    from fypraytracer_tpu_torch.utils.image import load_png

    row = dict(shape=list(rgb8.shape), mean8=float(rgb8.mean()))
    ok = tuple(rgb8.shape) == tuple(expect_shape) and row["mean8"] >= MEAN_FLOOR
    if golden_name:
        golden = load_png(os.path.join(GOLDENS, golden_name))
        row.update(golden=golden_name, psnr=metrics.psnr(metrics.mse_8bit(rgb8, golden)))
        ok = ok and row["psnr"] >= PSNR_FLOOR
    row["ok"] = bool(ok)
    return row


def phase_env() -> None:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    print(line or "nvidia-smi: no card reported", flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script needs a CUDA card")
    name, _, power = line.partition(",")
    CARD.update(gpu=name.strip(), power_limit=power.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    emit("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())


def phase_build() -> None:
    from fypraytracer_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    names = ("trace", "megakernel", "restir_di", "restir_gi", "megakernel_diff")
    # K8 without its gradient's atomics (k8_attribution), K2 with its section
    # clocks (k2_attribution), K5-K6 with theirs (gi_attribution), K8 and K4
    # with theirs and their block spans (k8_attribution, di_attribution),
    # built beside the others, each by a process of its own: the flags are
    # the build's global state
    variants = {(lib, flag): subprocess.Popen(
        [sys.executable, "-c", "from fypraytracer_tpu_torch.ops import kernels; "
         f"kernels.EXTRA_FLAGS['{lib}'] = kernels.EXTRA_FLAGS.get('{lib}', []) + ['{flag}']; "
         f"kernels.build('{lib}')"], cwd=REPO)
        for lib, flag in (("megakernel_diff", K8_NO_ATOMICS), ("megakernel", K2_CLOCKS), ("restir_gi", GI_CLOCKS),
                          ("megakernel_diff", DIFF_CLOCKS), ("restir_di", DI_CLOCKS))}
    try:
        with ThreadPoolExecutor(len(names)) as pool:
            list(pool.map(kernels.build, names))      # raises if any build failed
    finally:
        variant_rc = {key: proc.wait(timeout=900) for key, proc in variants.items()}
    for (lib, flag), rc in variant_rc.items():
        if rc != 0:
            raise RuntimeError(f"the build of {lib} with {flag} failed")
    secs = time.perf_counter() - t0
    ptxas = {}
    for name, info in kernels.build_info.items():
        for ln in info["log"].splitlines():
            if any(k in ln for k in ("registers", "spill", "Function properties")):
                print(f"[ptxas {name}] {ln.strip()}", flush=True)
        ptxas.update(ptxas_report(info["log"]))
    for kernel, row in ptxas.items():
        print(f"[ptxas] {kernel}: {row}", flush=True)
    emit("build", seconds=secs, libs={k: os.path.basename(v["path"]) for k, v in kernels.build_info.items()},
         ptxas=ptxas)
    k2_build(ptxas)
    gi_build(ptxas)
    spilled = {k: v for k, v in ptxas.items() if k.startswith(("k3_candidates", "k4_shade", "gi_stage2", "diff_kernel"))
               and (v.get("spill_stores", 1) or v.get("spill_loads", 1))}
    if spilled:
        raise AssertionError(f"K3, K4, K7 or K8 instantiations spill (or report no spill line): {spilled}")
    # K3's tile as one block of 512 holds two blocks a multiprocessor only
    # at 64 registers or fewer (65,536 / 1,024)
    wide = {k: v["registers"] for k, v in ptxas.items() if k.startswith("k3_candidates") and v["registers"] > 64}
    if wide:
        raise AssertionError(f"K3 instantiations above 64 registers: {wide}")


def k2_build(ptxas: dict) -> None:
    """Every instantiation of K2 (each sampler, untextured and textured):
    its registers and spill bytes from phase 2's ptxas report and its
    resident blocks a multiprocessor with the stacks of Cornell and of the
    stress scene (``fyp_megakernel_occupancy``); raises if one spills."""
    depths = tile_stacks()
    rows = {}
    for sampler in _SAMPLER_NAMES.values():
        for textured in (False, True):
            name = f"frames_kernel[{sampler}{',textured' if textured else ''}]"
            rows[name] = dict(ptxas.get(name, {}), blocks_per_sm={
                k: k2_occupancy(sampler, 1, textured, d) for k, d in depths.items()}, stack_depth=depths)
    emit("k2_build", instantiations=rows)
    spilled = {k: v for k, v in rows.items() if v.get("spill_stores", 1) or v.get("spill_loads", 1)}
    if spilled:
        raise AssertionError(f"K2 instantiations spill (or report no spill line): {spilled}")


def tile_stacks() -> dict:
    """The stack entries of Cornell's and of the stress scene's wide BVH."""
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    return {"cornell": cornell_box(256, 256)[0].compile().wide.stack_need,
            "stress": stress_scene(128, 128)[0].wide.stack_need}


def gi_blocks_per_sm() -> dict:
    """Every K5 and K6 instantiation's resident blocks a multiprocessor, by
    the CUDA runtime, with Cornell's and the stress scene's stacks, named as
    ``ptxas_report`` names them: the split tile's blocks of 128 (``split``)
    and the tile as one block of 512 (``block512``)."""
    depths = tile_stacks()
    out = {}
    for kernel, base in (("k5", "gi_mono"), ("k5 final_vis", "gi_mono"), ("k6", "gi_stage1")):
        for textured in (False, True):
            for split in (True, False):
                tags = (["final_vis"] if kernel.endswith("final_vis") else []) + (["textured"] if textured else []) \
                    + ["split" if split else "block512"]
                out[f"{base}[{','.join(tags)}]"] = {
                    k: tile_occupancy(kernel.split()[0], 512, d, split, textured, kernel.endswith("final_vis"))
                    ["blocks_per_sm"] for k, d in depths.items()}
    return out


def gi_build(ptxas: dict) -> None:
    """Every instantiation of K5 and K6 (final_vis, textured, a tile split
    over blocks of 128 or one block of 512): registers and spill bytes from
    phase 2's ptxas report, resident blocks and warps a multiprocessor with
    the stacks of Cornell and of the stress scene; raises if one spills."""
    depths = tile_stacks()
    rows = {}
    for name, blocks in gi_blocks_per_sm().items():
        warps = (128 if name.endswith("split]") else 512) // 32
        rows[name] = dict(ptxas.get(name, {}), blocks_per_sm=blocks,
                          warps_per_sm={k: warps * v for k, v in blocks.items()}, stack_depth=depths)
    emit("gi_build", instantiations=rows)
    spilled = {k: v for k, v in rows.items() if v.get("spill_stores", 1) or v.get("spill_loads", 1)}
    if spilled:
        raise AssertionError(f"K5 or K6 instantiations spill (or report no spill line): {spilled}")


# the template arguments of a kernel in its mangled name: frames_kernel<5, true>
# is ...frames_kernelILi5ELb1EE...
_SAMPLER_NAMES = {"0": "uniform", "1": "cosine", "2": "ggx", "3": "brdf", "4": "light", "5": "nee"}


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel in an nvcc -Xptxas -v log, by a
    readable name: K2's instantiations as frames_kernel[nee] and
    frames_kernel[nee,textured], K3, K5 and K6 with [textured]."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    named = {}
    for mangled, row in out.items():
        if "registers" not in row:
            continue                                     # a device function's frame, not a kernel
        base = next((k for k in ("frames_kernel", "k3_candidates", "k4_shade", "gi_mono", "gi_stage1", "gi_stage2",
                                 "diff_kernel", "trace_lane_kernel", "trace_closest_kernel", "segment_kernel")
                     if k in mangled), mangled)
        args = re.findall(r"L([ib])(\d+)E", mangled[mangled.find(base) + len(base):])
        last_bool = max((i for i, (kind, _) in enumerate(args) if kind == "b"), default=-1)
        tags = []
        for i, (kind, v) in enumerate(args):
            if base.startswith("frames") and kind == "i":
                tags.append(_SAMPLER_NAMES.get(v, v))
            elif base == "diff_kernel":                      # K8's bounce count
                tags.append(f"bounces={v}")
            elif kind == "i":                                # K3's and K5's block: a split tile's, or a tile's
                tags.append("split" if v == "128" else f"block{v}")
            elif kind == "b" and v == "1":                   # the last bool is textured, gi_mono's first final_vis
                tags.append("textured" if i == last_bool else "final_vis")
        named[base + (f"[{','.join(tags)}]" if tags else "")] = row
    return named


def in_turns(variants: dict, order, calls: int, launches=None) -> dict:
    """The kernel's own device time per launch (``kernel_ms``) of each
    variant, measured in the given order (old, new, new, old) within one
    run; returns {variant: [ms, ...]} in that order."""
    times: dict = {k: [] for k in variants}
    for k in order:
        times[k].append(kernel_ms(variants[k], calls, launches))
    return times


def k1_parity(scene, o, d) -> dict:
    """K1 (``trace_closest``, its lanes as the wrapper picks them) against
    ``trace_rays`` on the same rays: the share of equal ids and the largest
    |Δt| where both hit."""
    import torch

    from fypraytracer_tpu_torch.ops import traverse

    k = traverse.trace_closest(scene, o, d)
    p = traverse.trace_rays(scene.bvh, scene.geometry, o, d)
    torch.cuda.synchronize()
    same = (k["tri"] == p["tri"]).float().mean().item()
    both = (k["tri"] >= 0) & (p["tri"] >= 0)
    dt = (k["t"][both] - p["t"][both]).abs().max().item() if bool(both.any()) else 0.0
    return dict(rays=int(o.shape[0]), lanes=traverse.k1_lanes(o.shape[0], o.device), ids_equal=same, max_abs_dt=dt,
                hit_frac=both.float().mean().item(), ok=same >= 0.9999 and dt <= 1e-5)


def phase_k1(summary: dict) -> None:
    import numpy as np
    import torch

    from fypraytracer_tpu_torch.core.camera import generate_rays
    from fypraytracer_tpu_torch.ops import traverse
    from fypraytracer_tpu_torch.ops.traverse import check_overflow, trace_closest, trace_rays, trace_rays_wide
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    builder, cam = cornell_box(256, 256)
    scene = builder.compile().to("cuda")
    emit("cornell_scene", triangles=int(scene.geometry.tri_v.shape[0]), **wide_sizes(scene))
    o_cam, d_cam = generate_rays(cam.inv_projection, cam.inv_view, 256, 256, device="cuda")
    rng = np.random.default_rng(1234)
    o_rnd = torch.as_tensor(rng.uniform([-0.99, 0.01, -0.99], [0.99, 1.99, 0.99], (65536, 3)).astype(np.float32),
                            device="cuda")
    d_rnd = torch.as_tensor(rng.normal(size=(65536, 3)).astype(np.float32), device="cuda")
    o_hd, d_hd = generate_rays(cam.inv_projection, cam.inv_view, 1920, 1088, device="cuda")
    o_512, d_512 = generate_rays(cam.inv_projection, cam.inv_view, 512, 512, device="cuda")

    # K1 against its plain walk at the main path's batch, the 256² camera's
    # 65,536 rays (the quad kernel), on 65,536 random rays (the quad kernel)
    # and on the 1920x1088 camera's rays (the one-thread kernel)
    checks = {"camera 256x256": k1_parity(scene, o_cam, d_cam), "random 65536": k1_parity(scene, o_rnd, d_rnd),
              "camera 1920x1088": k1_parity(scene, o_hd, d_hd)}
    for name, row in checks.items():
        emit("k1_vs_plain", batch=name, **row)
    if not all(row["ok"] for row in checks.values()):
        raise AssertionError(f"K1 disagrees with its plain version: {checks}")

    # per-call times at the main path's batch: the kernel's own device
    # time, and CUDA events around one wrapper call (its host work included)
    ms = kernel_ms(lambda: trace_closest(scene, o_cam, d_cam))
    wrapper_ms = statistics.median(gpu_ms(lambda: trace_closest(scene, o_cam, d_cam), 20))
    plain_ms = statistics.median(gpu_ms(lambda: trace_rays(scene.bvh, scene.geometry, o_cam, d_cam), 3))
    walks = {"nodes": 0, "tris": 0}
    trace_rays(scene.bvh, scene.geometry, o_cam, d_cam, counts=walks)
    walks["tris"] = int(walks["tris"])
    # rays in, (tri, t, u, v) out
    io = nbytes(o_cam, d_cam) + 16 * o_cam.shape[0]
    main = checks["camera 256x256"]
    summary["trace_closest"] = dict(max_abs_err=main["max_abs_dt"], ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                    ids_equal=main["ids_equal"], lanes=main["lanes"],
                                    parity_shape="65,536 camera rays (Cornell 256x256)",
                                    other_batches={k: dict(ids_equal=v["ids_equal"], max_abs_dt=v["max_abs_dt"],
                                                           lanes=v["lanes"]) for k, v in checks.items()
                                                   if k != "camera 256x256"},
                                    **bound(walks, scene_bytes(scene, surfaces=False, wide=True) + io))
    emit("k1_timing", rays=int(o_cam.shape[0]), lanes=main["lanes"], ms_per_call=ms, wrapper_ms_per_call=wrapper_ms,
         plain_ms_per_call=plain_ms)

    # the wrapper's two walks of the wide BVH (a quad a ray, one thread a
    # ray) against the plain walk of the threaded BVH, bit for bit, and
    # against each other in turns, on 65,536 camera rays, 65,536 random rays
    # and the 512² and 1920x1088 cameras' rays
    walks = {"quad": lambda ro, rd: trace_closest(scene, ro, rd, lanes=4),
             "lane": lambda ro, rd: trace_closest(scene, ro, rd, lanes=1)}
    for name, (ro, rd) in {"camera 256x256": (o_cam, d_cam), "random 65536": (o_rnd, d_rnd),
                           "camera 512x512": (o_512, d_512), "camera 1920x1088": (o_hd, d_hd)}.items():
        hits = {k: fn(ro, rd) for k, fn in walks.items()}
        counts = {"nodes": 0, "tris": 0}
        wide_counts: dict = {}
        plain = trace_rays(scene.bvh, scene.geometry, ro, rd, counts=counts)
        trace_rays_wide(scene.wide, ro, rd, counts=wide_counts)
        differ = {k: sum(int((hits[k][f].view(torch.int32) != plain[f].view(torch.int32)).sum())
                         for f in hits[k]) for k in walks}
        n = ro.shape[0]
        times = in_turns({k: functools.partial(fn, ro, rd) for k, fn in walks.items()},
                         ("quad", "lane", "lane", "quad"), 20)
        row = dict(rays=n, differing_values_vs_plain=differ, **{f"{k}_ms": v for k, v in times.items()},
                   lane_over_quad=statistics.median(times["lane"]) / statistics.median(times["quad"]),
                   binary_nodes_per_ray=counts["nodes"] / n, binary_tris_per_ray=int(counts["tris"]) / n,
                   wide_nodes_per_ray=wide_counts.get("nodes", 0) / n,
                   wide_leaves_per_ray=wide_counts.get("leaves", 0) / n, ok=not any(differ.values()))
        emit("k1_walks", batch=name, default_lanes=traverse.k1_lanes(n, ro.device), **row)
        if name == "camera 256x256":
            summary["trace_closest"].update({f"{k}_ms": statistics.median(v) for k, v in times.items()})
        if any(differ.values()):
            raise AssertionError(f"K1's wide walks and the plain walk differ on {name}: {differ}")
    check_overflow(scene)


def phase_segment() -> None:
    """The wide segment test that K5 walks (``trace_segments``,
    ``csrc/trace.cu::fyp_segment_visible``) against its plain twin
    ``segment_visible_wide`` and the threaded ``segment_visible``, bit for
    bit: 65,536 rays from seeded points in the box, each segment ending at,
    within or past its ray's closest hit, or half way to it, on Cornell
    and on the stress scene; its device time beside the plain walks'."""
    import numpy as np
    import torch

    from fypraytracer_tpu_torch.ops.traverse import (check_overflow, segment_visible, segment_visible_wide,
                                                     trace_rays, trace_segments)
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    builder, _ = cornell_box(256, 256)
    scenes = {"cornell": builder.compile().to("cuda"), "stress": stress_scene(128, 128)[0]}
    rng = np.random.default_rng(99)
    n = 65536
    o = torch.as_tensor(rng.uniform([-0.99, 0.01, -0.99], [0.99, 1.99, 0.99], (n, 3)).astype(np.float32),
                        device="cuda")
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32), device="cuda"),
                                      dim=1).contiguous()
    scale = torch.as_tensor(rng.choice([1.0, 1.0005, 0.9995, 1.002, 0.998, 0.5], n).astype(np.float32),
                            device="cuda")
    for name, scene in scenes.items():
        t = trace_rays(scene.bvh, scene.geometry, o, d)["t"]
        dist = (torch.where(t > 0, t, 1.0) * scale).contiguous()
        got = trace_segments(scene, o, d, dist)
        wide = segment_visible_wide(scene.wide, o, d, dist)
        threaded = segment_visible(scene.bvh, scene.geometry, o, d, dist)
        row = dict(scene=name, segments=n, visible_frac=got.float().mean().item(),
                   differ_vs_plain_wide=int((got != wide).sum()), differ_vs_plain_threaded=int((got != threaded).sum()),
                   ms=kernel_ms(lambda: trace_segments(scene, o, d, dist)),
                   plain_wide_ms=statistics.median(gpu_ms(lambda: segment_visible_wide(scene.wide, o, d, dist), 3)),
                   plain_threaded_ms=statistics.median(gpu_ms(
                       lambda: segment_visible(scene.bvh, scene.geometry, o, d, dist), 3)))
        row["ok"] = row["differ_vs_plain_wide"] == 0 and row["differ_vs_plain_threaded"] == 0
        emit("segment_vs_plain", **row)
        if not row["ok"]:
            raise AssertionError(f"the wide segment test disagrees with its plain versions on {name}")
        check_overflow(scene)


def tile_occupancy(kernel: str, C: int, depth: int, clustered: bool, textured: bool = False,
                   final_vis: bool = False) -> dict:
    """The blocks of K3 (``kernel`` "k3"), K5 ("k5") or K6 ("k6") that one
    multiprocessor holds at once and the clusters the card holds at once,
    by the CUDA runtime, for tiles of ``C`` pixels split over a cluster or
    not and stacks of ``depth`` entries, with the launch's block and
    cluster sizes."""
    import ctypes

    from fypraytracer_tpu_torch.ops import kernels
    from fypraytracer_tpu_torch.render.restir_common import tile_launch

    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    if kernel == "k3":
        fn = kernels.load("restir_di", "fyp_restir_di_k3_occupancy", [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
        rc = fn(int(textured), C, int(clustered), depth, ctypes.byref(blocks), ctypes.byref(clusters))
    else:
        # csrc/restir_gi.cu's kernel selector: K5, K5 final_vis, K6
        which = 2 if kernel == "k6" else int(final_vis)
        fn = kernels.load("restir_gi", "fyp_restir_gi_occupancy", [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
        rc = fn(which, int(textured), C, int(clustered), depth, ctypes.byref(blocks), ctypes.byref(clusters))
    kernels.check(rc, f"{kernel} occupancy")
    lay = tile_launch(C, clustered)
    return dict(threads_per_block=lay["threads"], blocks_per_cluster=lay["cluster"], blocks_per_sm=blocks.value,
                clusters_on_card=clusters.value)


def k2_occupancy(sampler: str, lanes: int, textured: bool, depth: int) -> int:
    """The blocks of K2's kernel for a sampler (by name) and lane count,
    untextured or textured, that one multiprocessor holds at once with
    stacks of ``depth`` entries, by the CUDA runtime
    (``fyp_megakernel_occupancy``)."""
    import ctypes

    from fypraytracer_tpu_torch.ops import kernels
    from fypraytracer_tpu_torch.render import megakernel as mk

    fn = kernels.load("megakernel", "fyp_megakernel_occupancy", [ctypes.c_int] * 4 + [ctypes.c_void_p])
    blocks = ctypes.c_int(0)
    kernels.check(fn(mk._SAMPLER_ID[sampler], lanes, int(textured), max(depth, 1), ctypes.byref(blocks)),
                  "fyp_megakernel_occupancy")
    return blocks.value


def k2_blocks_per_sm(scene, settings, lanes, textured=False) -> int:
    """``k2_occupancy`` of the settings' sampler with the scene's stacks."""
    from fypraytracer_tpu_torch.render import megakernel as mk

    return k2_occupancy(mk._sampler(settings), lanes, textured, scene.wide.stack_need)


def phase_k2_walks(summary: dict) -> None:
    """K2 in turns through its wrapper with 1, 2 and 4 threads a pixel
    (``megakernel(..., lanes=)``): under NEE at Cornell 256² (1, 2, 8 and
    64 frames), 512² (8 frames), 1920x1088 (1, 2 and 8 frames) and the
    stress scene at 128² (8 frames); the other samplers with 1 and 4
    threads a pixel at Cornell 256², 8 frames.  Reports the lanes
    ``k2_lanes`` picks, each kernel's resident blocks a multiprocessor, the
    pixels that differ from the first kernel's image and the largest
    relative difference; then ``k2_attribution``."""
    import torch

    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render import megakernel as mk
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    def variant(name, scene, cam, frames, st):
        return lambda: mk.megakernel(scene, cam, 1, frames, st, lanes=int(name[-1]))

    nee = ("lanes1", "lanes2", "lanes4")
    cases = [("NEE_MIS", "cornell", 256, 256, f, 10 if f <= 8 else 5, nee) for f in (1, 2, 8, 64)]
    cases += [("NEE_MIS", "cornell", 512, 512, 8, 10, nee)]
    cases += [("NEE_MIS", "cornell", 1920, 1088, f, 5, nee) for f in (1, 2, 8)]
    cases += [("NEE_MIS", "stress", 128, 128, 8, 10, nee)]
    cases += [(tech, "cornell", 256, 256, 8, 10, ("lanes1", "lanes4")) for tech in K2_NAMES if tech != "NEE_MIS"]
    for tech, scene_name, w, h, frames, calls, names in cases:
        st = settings_for(tech)
        if scene_name == "stress":
            scene, cam = stress_scene(w, h)
        else:
            builder, cam = cornell_box(w, h)
            scene = builder.compile().to("cuda")
        runs = {k: variant(k, scene, cam, frames, st) for k in names}
        imgs = {k: run() for k, run in runs.items()}
        torch.cuda.synchronize()
        first = imgs[names[0]]
        differ = {k: int((imgs[k] != first).any(dim=1).sum()) for k in names[1:]}
        max_rel = max(((imgs[k] - first).abs() / first.abs().clamp_min(1e-6)).max().item() for k in names[1:])
        times = in_turns(runs, names + names[::-1], calls)
        emit("k2_walks", technique=tech, scene=scene_name, size=f"{w}x{h}", frames=frames,
             default_lanes=mk.k2_lanes(frames),
             blocks_per_sm={k: k2_blocks_per_sm(scene, st, int(k[-1])) for k in names},
             differing_pixels_vs_first=differ, max_rel_diff_vs_first=max_rel,
             **{f"{k}_ms": v for k, v in times.items()},
             speedup_vs_first={k: statistics.median(times[names[0]]) / statistics.median(times[k])
                               for k in names[1:]})
        if (scene_name, w, frames) == ("cornell", 256, 8):
            summary[K2_NAMES[tech]].update({f"{k}_ms": statistics.median(v) for k, v in times.items()},
                                           differing_pixels_between_lanes=differ)
        check_overflow(scene)
    summary["megakernel[nee]"]["section_shares"] = {k: v["shares"] for k, v in k2_attribution().items()}


def k2_attribution() -> dict:
    """Where K2 NEE's time goes: the kernel built with its section clocks
    (``-DFYP_K2_CLOCKS``; phase 2 builds it) at each of
    ``K2_ATTRIBUTION``, one launch, the lanes ``k2_lanes`` picks.  Each
    section's share of the threads' summed cycles (the walks by ray kind,
    the light sample and, for the rest, surface fetch, shading and
    scatter), and what the clocks cost: the kept kernel's device ms
    against the clocked one's, in turns (kept, clocked, clocked, kept).
    One line a shape; returns {shape: row}."""
    import ctypes
    from unittest import mock

    import torch

    from fypraytracer_tpu_torch.ops import kernels
    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render import megakernel as mk
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    kept = list(kernels.EXTRA_FLAGS.get("megakernel", []))
    clocked = kept + [K2_CLOCKS]
    st = settings_for("NEE_MIS")
    out = {}
    for name, w, h, frames, calls in K2_ATTRIBUTION:
        if name == "stress":
            scene, cam = stress_scene(w, h)
        else:
            builder, cam = cornell_box(w, h)
            scene = builder.compile().to("cuda")

        def run(flags):
            with mock.patch.dict(kernels.EXTRA_FLAGS, {"megakernel": flags}):
                mk.megakernel(scene, cam, 1, frames, st)

        sums = torch.zeros(len(K2_SECTIONS), dtype=torch.int64, device="cuda")
        with mock.patch.dict(kernels.EXTRA_FLAGS, {"megakernel": clocked}):
            read = kernels.load("megakernel", "fyp_megakernel_clocks", [ctypes.c_void_p, ctypes.c_void_p])
            stream = kernels.stream_ptr(sums.device)
            kernels.check(read(kernels.ptr(sums), stream), "fyp_megakernel_clocks")     # clears the sums
            run(clocked)
            kernels.check(read(kernels.ptr(sums), stream), "fyp_megakernel_clocks")
        cycles = dict(zip(K2_SECTIONS, sums.tolist()))
        shares = {k: v / cycles["total"] for k, v in cycles.items() if k != "total"}
        shares["surface_shading_scatter"] = 1.0 - sum(shares.values())
        turns = in_turns({"kept": functools.partial(run, kept), "clocked": functools.partial(run, clocked)},
                         ("kept", "clocked", "clocked", "kept"), calls, launches=lambda: mk.megakernel.launches)
        key = f"{name} {w}x{h} {frames} frames"
        out[key] = dict(lanes=mk.k2_lanes(frames), shares=shares, cycles=cycles,
                        ms={k: statistics.median(v) for k, v in turns.items()}, turns_ms=turns)
        emit("k2_attribution", shape=key, **out[key])
        check_overflow(scene)
    return out


def phase_k2(summary: dict) -> None:
    from fypraytracer_tpu_torch.core.camera import generate_rays
    from fypraytracer_tpu_torch.ops.traverse import trace_rays
    from fypraytracer_tpu_torch.render.megakernel import k2_lanes, megakernel, megakernel_plain
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    def cornell(size, with_spheres=True):
        builder, cam = cornell_box(size, size, with_spheres=with_spheres)
        return builder.compile().to("cuda"), cam

    scenes = {"cornell": cornell, "cornell_no_spheres": lambda size: cornell(size, False),
              "stress": lambda size: stress_scene(size, size)}

    def check(tech, size, frames, scene_name="cornell", timed=True, **kw):
        """K2 against its plain version; per-launch times of both (the
        kernel's device time only when ``timed``)."""
        st = settings_for(tech, **kw)
        scene, cam = scenes[scene_name](size)
        megakernel(scene, cam, 1, frames, st)                 # warm-up
        out = {}
        wrapper_ms = statistics.median(gpu_ms(lambda: out.update(got=megakernel(scene, cam, 1, frames, st)), 5))
        ms = kernel_ms(lambda: megakernel(scene, cam, 1, frames, st)) if timed else None
        with count_walks() as walks:
            plain_ms = statistics.median(gpu_ms(lambda: out.update(ref=megakernel_plain(scene, cam, 1, frames, st)), 1))
        row = parity(out["got"].cpu().numpy(), out["ref"].cpu().numpy())
        emit("k2_vs_plain", technique=tech, scene=scene_name, size=f"{size}x{size}", frames=frames,
             bounces=st.bounces, samples=st.samples, ms_per_launch=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
             **row)
        if not row["ok"]:
            raise AssertionError(f"K2 disagrees with its plain version: {tech} on {scene_name} at {size}², {kw}")
        # K2 walks the primary rays once a launch, the plain version once a frame
        o, d = generate_rays(cam.inv_projection, cam.inv_view, size, size, device="cuda")
        prim = {"nodes": 0, "tris": 0}
        trace_rays(scene.bvh, scene.geometry, o, d, counts=prim)
        walks = {k: walks[k] - (frames - 1) * int(prim[k]) for k in walks}
        io = scene_bytes(scene, lights=tech in ("NEE_MIS", "LIGHT_SOURCE"), wide=True,
                         positions=tech in ("NEE_MIS", "LIGHT_SOURCE")) + 2 * 16 * 4 + size * size * 12
        return dict(max_abs_err=row["max_abs"], ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                    lanes=k2_lanes(frames), median_abs_err=row["median_abs"],
                    frac_px_over_1e3=row["frac_px_over_1e3"], parity_shape=f"{scene_name} {size}x{size}x{frames}f",
                    **bound(walks, io))

    # every technique at the main path's shape, Cornell 256² and 8 frames
    # (the summary's rows); NEE also on the stress scene at 128², 8 frames,
    # as the main path drives it
    for tech, name in K2_NAMES.items():
        summary[name] = check(tech, 256, 8)
    check("NEE_MIS", 128, 8, "stress")
    # more branches at 64², 4 frames: NEE at one bounce (light sampling
    # without MIS) and two samples a pixel; the other samplers at the size of
    # the CPU tests; light sampling as the DI unbiasedness check drives it
    for bounces, samples in ((2, 1), (1, 1), (2, 2)):
        check("NEE_MIS", 64, 4, timed=False, bounces=bounces, samples=samples)
    for tech in ("UNIFORM", "COSINE", "GGX", "BRDF", "LIGHT_SOURCE"):
        check(tech, 64, 4, timed=False)
    check("LIGHT_SOURCE", 64, 4, "cornell_no_spheres", timed=False, samples=4, sky_color=(0.0, 0.0, 0.0))


def phase_restir(summary: dict) -> None:
    import torch

    from fypraytracer_tpu_torch.render import megakernel_restir as mr
    from fypraytracer_tpu_torch.render.restir_common import camera_matrices
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    st = settings_for("RESTIR_DI")
    scene, cam = stress_scene(128, 128)
    em = mr.prepare_emissive_table(scene)
    B = cam.width * cam.height
    # the camera and proj @ view on the card, as the frame loop passes them
    ppv = torch.as_tensor(cam.proj_view, device="cuda")
    k3 = functools.partial(mr.restir_di_k3, cam=camera_matrices(cam, "cuda"))
    k4 = functools.partial(mr.restir_di_k4, cam=camera_matrices(cam, "cuda"))

    # each kernel against its plain version on the same inputs, after two
    # frames of history
    state = torch.zeros((mr.ST_ROWS, B), device="cuda")
    mr.restir_di_megakernel_plain(scene, em, cam, state, 1, 2, st, ppv, ppv)
    out = {}
    k3(scene, em, cam, 3, st, state, ppv)                              # warm-up
    k3_wrapper_ms = statistics.median(gpu_ms(lambda: out.update(stage=k3(scene, em, cam, 3, st, state, ppv)), 5))
    k3_ms = kernel_ms(lambda: k3(scene, em, cam, 3, st, state, ppv))
    with count_walks() as k3_walks:
        k3_plain_ms = statistics.median(gpu_ms(
            lambda: out.update(ref=mr.restir_di_k3_plain(scene, em, cam, 3, st, state, ppv)), 1))
    d = (out["stage"] - out["ref"]).abs()
    k3_off = ((d > 1e-3 * torch.clamp_min(out["ref"].abs(), 1.0)).any(0)).float().mean().item()
    k3_row = dict(max_abs_err=d.max().item(), frac_px_over_1e3=k3_off, ok=k3_off < 0.01)
    emit("k3_vs_plain", size="128x128", scene="stress", ms_per_launch=k3_ms, wrapper_ms=k3_wrapper_ms,
         plain_ms=k3_plain_ms, **k3_row)

    acc_k, acc_p = (torch.zeros((B, 3), device="cuda") for _ in range(2))
    st_k, st_p = state.clone(), state.clone()
    k4(scene, em, cam, 3, st, out["ref"], st_k, acc_k)
    mr.restir_di_k4_plain(scene, em, cam, 3, st, out["ref"], st_p, acc_p)
    k4_row = parity(acc_k.cpu().numpy(), acc_p.cpu().numpy())
    k4_row["state_frac_px_over_1e3"] = ((st_k - st_p).abs() > 1e-3 * torch.clamp_min(st_p.abs(), 1.0)).any(0).float().mean().item()
    k4_row["ok"] = bool(k4_row["ok"] and k4_row["state_frac_px_over_1e3"] < 0.01)
    scratch = torch.zeros((B, 3), device="cuda")
    k4_wrapper_ms = statistics.median(gpu_ms(lambda: k4(scene, em, cam, 3, st, out["ref"], st_k, scratch), 5))
    k4_ms = kernel_ms(lambda: k4(scene, em, cam, 3, st, out["ref"], st_k, scratch))
    with count_walks() as k4_walks:
        k4_plain_ms = statistics.median(gpu_ms(
            lambda: mr.restir_di_k4_plain(scene, em, cam, 3, st, out["ref"], st_p, scratch), 1))
    emit("k4_vs_plain", size="128x128", scene="stress", ms_per_launch=k4_ms, wrapper_ms=k4_wrapper_ms,
         plain_ms=k4_plain_ms, **k4_row)
    em_bytes = nbytes(em.p0, em.e1, em.e2, em.area, em.normal, em.emission, em.centroid, em.tri)
    # K3 reads the camera, the previous proj @ view and 6 of the 9 state rows
    # (ST_NRM, ST_RM, ST_RIDX, ST_RW) and writes the stage; K4 reads the
    # camera and every stage row, writes the state and adds to the image
    k3_io = scene_bytes(scene, wide=True) + em_bytes + 3 * 16 * 4 + 6 * B * 4 + nbytes(out["stage"])
    k4_io = scene_bytes(scene, surfaces=False, wide=True) + em_bytes + 2 * 16 * 4 + nbytes(out["stage"]) \
        + nbytes(state) + 2 * B * 12
    summary["restir_di_k3"] = dict(max_abs_err=k3_row["max_abs_err"], ms=k3_ms, wrapper_ms=k3_wrapper_ms,
                                   plain_ms=k3_plain_ms,
                                   frac_px_over_1e3=k3_off, parity_shape="128x128 stress, 1 frame",
                                   **bound(k3_walks, k3_io))
    summary["restir_di_k4"] = dict(max_abs_err=k4_row["max_abs"], ms=k4_ms, wrapper_ms=k4_wrapper_ms,
                                   plain_ms=k4_plain_ms,
                                   median_abs_err=k4_row["median_abs"],
                                   frac_px_over_1e3=k4_row["frac_px_over_1e3"], parity_shape="128x128 stress, 1 frame",
                                   **bound(k4_walks, k4_io))
    if not (k3_row["ok"] and k4_row["ok"]):
        raise AssertionError("K3 or K4 disagrees with its plain version")

    # the frame loop: 8 frames on the stress scene; 4 + 4 frames on Cornell
    # with a camera move in between (the tile-mean reprojection)
    def frames(fn, scn, table, camera, moves):
        state = torch.zeros((mr.ST_ROWS, camera.width * camera.height), device="cuda")
        total, f0, ppv0 = 0.0, 1, camera.proj_view
        for n, pos in moves:
            if pos is not None:
                camera.move_to(pos)
            total = total + fn(scn, table, camera, state, f0, n, st, ppv0, camera.proj_view)
            f0, ppv0 = f0 + n, camera.proj_view
        return total.cpu().numpy()

    builder, _ = cornell_box(64, 64)
    cornell = builder.compile().to("cuda")
    cases = [("stress", "128x128", scene, em, lambda: cam, [(8, None)]),
             ("cornell", "64x64", cornell, mr.prepare_emissive_table(cornell),
              lambda: cornell_box(64, 64)[1],
              [(4, None), (4, (0.15, 1.0, 2.6))])]
    for name, size, scn, table, make_cam, moves in cases:
        got = frames(mr.restir_di_megakernel, scn, table, make_cam(), moves)
        ref = frames(mr.restir_di_megakernel_plain, scn, table, make_cam(), moves)
        row = parity(got, ref)
        emit("k3k4_frames_vs_plain", scene=name, size=size, frames=[n for n, _ in moves],
             moved=len(moves) > 1, **row)
        if not row["ok"]:
            raise AssertionError(f"K3+K4 disagree with restir_di_megakernel_plain on {name}")
    many_emitter_di(st)
    summary["restir_di_k3"].update(by_shape("k3", st))
    summary["restir_di_k4"].update(by_shape("k4", st))
    di_attribution()


def many_emitter_di(st) -> None:
    """K3 (one block a tile and split over clusters) and K4 against their
    plain versions on the same inputs, frame 3 after two frames of history,
    on Cornell at 256² with the rough sphere's material made emissive
    through ``SceneManager.set_material``: 578 emitters, more than K3's
    p-hat table holds, so K3 evaluates p-hat a candidate.  Raises unless
    each meets phase 5's gates."""
    from unittest import mock

    import torch

    from fypraytracer_tpu_torch.render import megakernel_restir as mr
    from fypraytracer_tpu_torch.render import restir_common as rc
    from fypraytracer_tpu_torch.scene.manager import SceneManager
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    builder, cam = cornell_box(256, 256)
    SceneManager(builder).set_material(4, emission_color=(1.0, 0.8, 0.6), emission_power=3.0)
    scene = builder.compile().to("cuda")
    em = mr.prepare_emissive_table(scene)
    B = cam.width * cam.height
    ppv = torch.as_tensor(cam.proj_view, device="cuda")
    state = torch.zeros((mr.ST_ROWS, B), device="cuda")
    mr.restir_di_megakernel_plain(scene, em, cam, state, 1, 2, st, ppv, ppv)
    ref = mr.restir_di_k3_plain(scene, em, cam, 3, st, state, ppv)
    rows = {}
    for split in (False, True):
        with mock.patch.object(rc, "tile_clustered", lambda *_: split):
            got = mr.restir_di_k3(scene, em, cam, 3, st, state, ppv)
        d = (got - ref).abs()
        off = ((d > 1e-3 * torch.clamp_min(ref.abs(), 1.0)).any(0)).float().mean().item()
        rows["k3_split" if split else "k3_one_block"] = dict(max_abs_err=d.max().item(), frac_px_over_1e3=off,
                                                              ok=off < 0.01)
    acc_k, acc_p = (torch.zeros((B, 3), device="cuda") for _ in range(2))
    st_k, st_p = state.clone(), state.clone()
    mr.restir_di_k4(scene, em, cam, 3, st, ref, st_k, acc_k)
    mr.restir_di_k4_plain(scene, em, cam, 3, st, ref, st_p, acc_p)
    k4 = parity(acc_k.cpu().numpy(), acc_p.cpu().numpy())
    k4["state_frac_px_over_1e3"] = ((st_k - st_p).abs() > 1e-3 * torch.clamp_min(st_p.abs(), 1.0)).any(0) \
        .float().mean().item()
    k4["ok"] = bool(k4["ok"] and k4["state_frac_px_over_1e3"] < 0.01)
    rows["k4"] = k4
    emit("di_many_emitters", size="256x256", scene="cornell, rough sphere emissive", emitters=em.n, **rows)
    if not all(r["ok"] for r in rows.values()):
        raise AssertionError("K3 or K4 disagrees with its plain version with many emitters")


# the shapes at which K3-K6 are timed: few tiles, a deep tree, many tiles
SHAPES = (("cornell", 256, 256), ("stress", 128, 128), ("cornell", 1920, 1088))
# frames of 32 to 128 tiles of 512, on both scenes, at which only the two
# launches of K3, K5 and K6 are timed in turns: where
# restir_common.tile_clustered's threshold should sit
BETWEEN = (("cornell", 128, 128), ("cornell", 160, 160), ("cornell", 192, 192), ("cornell", 224, 224),
           ("stress", 160, 160), ("stress", 192, 192), ("stress", 224, 224), ("stress", 256, 256))


def tile_scene(name: str, w: int, h: int):
    """The scene and camera at which K3-K7 are timed: Cornell at w x h in
    Morton order, or the stress scene's one tree with its camera at w x h."""
    from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
    from fypraytracer_tpu_torch.scene.procedural import cornell_box, stress

    if name == "stress":
        scene, cam = stress_scene(128, 128)
        return scene, (stress(w, h)[1] if (w, h) != (128, 128) else cam)
    builder, cam = cornell_box(w, h)
    return morton_permuted_scene(builder.compile())[0].to("cuda"), cam


def by_shape(kernel: str, st, textured: bool = False, design_shapes: tuple = SHAPES + BETWEEN) -> dict:
    """K3 (``kernel`` "k3"), K4 ("k4"), K5 in both visibility modes ("k5"),
    K6 ("k6") or K7 ("k7") a launch at each of ``SHAPES`` (frame 3, after
    two frames of the kernels' own loop): the device time of the launch the
    wrapper picks (``ms_by_shape``) and, where the tree has
    ``tile_clustered`` (not for K4 and K7, which have one launch), of both
    launches in turns at each of ``design_shapes`` (split, one block a tile,
    one block, split: ``designs_by_shape``; each forced by standing in for
    ``tile_clustered``) with each one's occupancy by the runtime and the
    pick; one line a shape.  It uses nothing else
    that the port's ReSTIR modules lacked before, so that ``--ab`` can time
    an older checkout too."""
    from unittest import mock

    import torch

    from fypraytracer_tpu_torch.ops.traverse import check_overflow, stack_depth
    from fypraytracer_tpu_torch.render import megakernel_restir as mr
    from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg
    from fypraytracer_tpu_torch.render import restir_common as rc

    t0 = time.perf_counter()
    if not hasattr(rc, "tile_clustered") or kernel in ("k4", "k7"):
        design_shapes = ()
    out: dict = {"ms_by_shape": {}, "designs_by_shape": {}, "occupancy_by_shape": {}, "picked_by_shape": {}}
    for name, w, h in SHAPES + tuple(s for s in design_shapes if s not in SHAPES):
        timed = (name, w, h) in SHAPES
        designs = (name, w, h) in design_shapes
        scene, cam = tile_scene(name, w, h)
        shape = f"{name} {w}x{h}"
        B, C, depth = w * h, rc.pick_ray_lanes(w * h), stack_depth(scene.wide)
        ppv = torch.as_tensor(cam.proj_view, device="cuda")
        cam_t = rc.camera_matrices(cam, "cuda")
        if kernel in ("k3", "k4"):
            em = mr.prepare_emissive_table(scene)
            state = torch.zeros((mr.ST_ROWS, B), device="cuda")
            mr.restir_di_megakernel(scene, em, cam, state, 1, 2, st, ppv, ppv)
            if kernel == "k3":
                runs = {shape: lambda: mr.restir_di_k3(scene, em, cam, 3, st, state, ppv, cam=cam_t)}
                count = lambda: mr.restir_di_k3.launches                              # noqa: E731
            else:
                stage = mr.restir_di_k3(scene, em, cam, 3, st, state, ppv, cam=cam_t)
                acc, st_out = torch.zeros((B, 3), device="cuda"), torch.empty_like(state)
                runs = {shape: lambda: mr.restir_di_k4(scene, em, cam, 3, st, stage, st_out, acc, cam=cam_t)}
                count = lambda: mr.restir_di_k4.launches                              # noqa: E731
        else:
            z = (torch.zeros((mg.GT_ROWS, B), device="cuda"), torch.zeros((mg.GS_ROWS, B), device="cuda"))
            _, state, stage = mg.restir_gi_megakernel(scene, cam, *z, 1, 2, st, ppv, ppv, mono=kernel == "k5")
            outs = (torch.zeros((B, 3), device="cuda"), torch.empty_like(state), torch.empty_like(stage))
            if kernel == "k5":
                runs = {f"{shape}{' final_vis' if fv else ''}":
                        functools.partial(lambda fv: mg.restir_gi_mono(scene, cam, 3, st, state, stage, ppv, *outs,
                                                                       final_vis=fv, cam=cam_t), fv)
                        for fv in (False, True)}
                count = lambda: mg.restir_gi_mono.launches                            # noqa: E731
            elif kernel == "k6":
                runs = {shape: lambda: mg.restir_gi_k1(scene, cam, 3, st, state, ppv, outs[2], cam=cam_t)}
                count = lambda: mg.restir_gi_k1.launches                              # noqa: E731
            else:
                stage = mg.restir_gi_k1(scene, cam, 3, st, state, ppv, cam=cam_t)
                runs = {shape: lambda: mg.restir_gi_k2(scene, cam, 3, st, stage, outs[1], outs[0], cam=cam_t)}
                count = lambda: mg.restir_gi_k2.launches                              # noqa: E731
        for key, run in runs.items():
            if timed:
                out["ms_by_shape"][key] = kernel_ms(run, launches=count)
            if designs:
                def forced(split, run=run):
                    with mock.patch.object(rc, "tile_clustered", lambda *_: split):
                        run()

                turns = in_turns({d: functools.partial(forced, d == "split") for d in ("split", "one_block")},
                                 ("split", "one_block", "one_block", "split"), 20, launches=count)
                out["designs_by_shape"][key] = {d: statistics.median(v) for d, v in turns.items()}
                out["picked_by_shape"][key] = "split" if rc.pick_tile_launch(scene, B, cam_t.device)["clustered"] \
                    else "one_block"
                out["occupancy_by_shape"][key] = {
                    d: tile_occupancy(kernel, C, depth, d == "split", textured, key.endswith("final_vis"))
                    for d in ("split", "one_block")}
        torch.cuda.synchronize()
        check_overflow(scene)
        emit("tile_kernel_by_shape", kernel=kernel, shape=shape, tiles=B // C, tile_pixels=C, stack_depth=depth,
             **{k: {key: v for key, v in d.items() if key.startswith(shape)} for k, d in out.items()})
    emit("tile_kernel_by_shape_seconds", kernel=kernel, designs=bool(design_shapes), seconds=time.perf_counter() - t0)
    return out


def phase_restir_gi(summary: dict) -> None:
    import torch

    from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg
    from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
    from fypraytracer_tpu_torch.render.restir_common import camera_matrices
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    st = settings_for("RESTIR_GI")

    def cornell(size):
        builder, cam = cornell_box(size, size)
        return morton_permuted_scene(builder.compile())[0].to("cuda"), cam

    def zeros(n_pix):
        return (torch.zeros((mg.GT_ROWS, n_pix), device="cuda"), torch.zeros((mg.GS_ROWS, n_pix), device="cuda"))

    def off(got, ref):
        """Share of pixels with an element off by more than 1e-3 relative."""
        return ((got - ref).abs() > 1e-3 * torch.clamp_min(ref.abs(), 1.0)).any(0).float().mean().item()

    # each kernel against its plain version on the same inputs: Cornell 256²,
    # frame 3 after two frames of history; the camera and proj @ view on the
    # card, as the frame loop passes them
    scene, cam = cornell(256)
    B = cam.width * cam.height
    ppv = torch.as_tensor(cam.proj_view, device="cuda")
    cam_t = camera_matrices(cam, "cuda")
    _, state, stage = mg.restir_gi_megakernel_plain(scene, cam, *zeros(B), 1, 2, st, ppv, ppv)
    ref_stage = mg.restir_gi_k1_plain(scene, cam, 3, st, state, ppv)

    def acc():
        return torch.zeros((B, 3), device="cuda")

    def k1(fn):
        return (fn(scene, cam, 3, st, state, ppv),)

    def k2(fn):
        a, s_ = acc(), torch.empty_like(state)
        fn(scene, cam, 3, st, ref_stage, s_, a)
        return s_, a.T

    def mono(final_vis):
        def run(fn):
            a, s_, g_ = acc(), torch.empty_like(state), torch.empty_like(stage)
            fn(scene, cam, 3, st, state, stage, ppv, a, s_, g_, final_vis=final_vis)
            return s_, g_, a.T
        return run

    # bytes read besides the outputs (csrc/restir_gi.cu): K5 and K6 read the
    # camera, proj @ view, the wide BVH's records and the surfaces, and 15 of
    # the 16 state rows (not GT_WSUM) only at pixels that shade; K5 reads 19
    # of the 33 rows of the previous stage at neighbour pixels (GS_T, GS_NRM,
    # GS_SHADE, GS_M, GS_SP, GS_SN, GS_RAD, GS_POS, GS_W); K7 reads every
    # stage row, the camera and the wide BVH's records only; K5 and K7 add
    # to the image (read it too)
    n_shade = int((ref_stage[mg.GS_SHADE] > 0.5).sum())
    state_rows = 15 * n_shade * 4
    k6_in = scene_bytes(scene, wide=True) + 3 * 16 * 4 + state_rows
    k5_in = k6_in + 19 * B * 4 + B * 12
    cases = [("restir_gi_k1", k1, functools.partial(mg.restir_gi_k1, cam=cam_t), mg.restir_gi_k1_plain, k6_in),
             ("restir_gi_k2", k2, functools.partial(mg.restir_gi_k2, cam=cam_t), mg.restir_gi_k2_plain,
              scene_bytes(scene, surfaces=False, wide=True) + 2 * 16 * 4 + nbytes(ref_stage) + B * 12),
             ("restir_gi_mono", mono(False), functools.partial(mg.restir_gi_mono, cam=cam_t),
              mg.restir_gi_mono_plain, k5_in),
             ("restir_gi_mono[final_vis]", mono(True), functools.partial(mg.restir_gi_mono, cam=cam_t),
              mg.restir_gi_mono_plain, k5_in)]
    for name, run, kernel, plain, in_bytes in cases:
        run(kernel)                                          # warm-up
        out = {}
        # 10 launches a rep, back to back, so that the host's work for one
        # launch overlaps the card's for the one before
        wrapper_ms = statistics.median(gpu_ms(lambda: [out.update(got=run(kernel)) for _ in range(10)], 5)) / 10
        ms = kernel_ms(lambda: run(kernel))
        with count_walks() as walks:
            plain_ms = statistics.median(gpu_ms(lambda: out.update(ref=run(plain)), 1))
        frac = max(off(a, b) for a, b in zip(out["got"], out["ref"]))
        err = max((a - b).abs().max().item() for a, b in zip(out["got"], out["ref"]))
        summary[name] = dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, frac_px_over_1e3=frac,
                             parity_shape="cornell 256x256, frame 3 after 2 of history",
                             **bound(walks, in_bytes + nbytes(*out["ref"])))
        emit("gi_kernel_vs_plain", kernel=name, size="256x256", ms_per_launch=ms, wrapper_ms=wrapper_ms,
             plain_ms=plain_ms, frac_px_over_1e3=frac, max_abs_err=err, bitwise=err == 0.0,
             shading_pixels=n_shade, ok=frac < 0.01)
        if not frac < 0.01:
            raise AssertionError(f"{name} disagrees with its plain version")

    # the frame loops: K5 at the main path's shape and on the stress scene;
    # K5 final_vis and K6+K7 at 64² with a camera move in between
    def frames(fn, scn, make_cam, moves, mode):
        camera = make_cam()
        n_pix = camera.width * camera.height
        state, stage = zeros(n_pix)
        total, f0, ppv0 = 0.0, 1, camera.proj_view
        for n, pos in moves:
            if pos is not None:
                camera.move_to(pos)
            out, state, stage = fn(scn, camera, state, stage, f0, n, st, ppv0, camera.proj_view, **mode)
            total = total + out
            f0, ppv0 = f0 + n, camera.proj_view
        return total.cpu().numpy()

    small, _ = cornell(64)
    stress, stress_cam = stress_scene(128, 128)
    move = [(4, None), (4, (0.15, 1.0, 2.6))]
    loops = [("cornell", "256x256", scene, lambda: cornell_box(256, 256)[1], [(8, None)], dict(mono=True)),
             ("stress", "128x128", stress, lambda: stress_cam, [(4, None)], dict(mono=True)),
             ("cornell", "64x64", small, lambda: cornell_box(64, 64)[1], move, dict(mono=True, final_vis=True)),
             ("cornell", "64x64", small, lambda: cornell_box(64, 64)[1], move, dict(mono=False))]
    for name, size, scn, make_cam, moves, mode in loops:
        got = frames(mg.restir_gi_megakernel, scn, make_cam, moves, mode)
        ref = frames(mg.restir_gi_megakernel_plain, scn, make_cam, moves, mode)
        row = parity(got, ref)
        emit("gi_frames_vs_plain", scene=name, size=size, frames=[n for n, _ in moves], moved=len(moves) > 1,
             mode=mode, **row)
        if not row["ok"]:
            raise AssertionError(f"the GI frame loop {mode} disagrees with its plain version on {name} {size}")
    k5_parting()
    shapes = by_shape("k5", st)
    for fv, row in ((False, "restir_gi_mono"), (True, "restir_gi_mono[final_vis]")):
        summary[row].update({k: {s_: v for s_, v in d.items() if s_.endswith(" final_vis") == fv}
                             for k, d in shapes.items()})
    summary["restir_gi_k1"].update(by_shape("k6", st))
    summary["restir_gi_k2"].update(by_shape("k7", st))
    attribution = gi_attribution()
    for row, kernel in (("restir_gi_mono", "k5"), ("restir_gi_mono[final_vis]", "k5 final_vis"),
                        ("restir_gi_k1", "k6")):
        summary[row]["section_shares"] = {k: v["shares"] for k, v in attribution.items() if v["kernel"] == kernel}
    summary["restir_gi_k2"]["section_shares"] = {k: v["shares"] for k, v in k7_attribution().items()}


def gi_attribution() -> dict:
    """Where K5's (both modes) and K6's time goes: csrc/restir_gi.cu built
    with its section clocks (``-DFYP_GI_CLOCKS``; phase 2 builds it), one
    launch at frame 3, after two frames of the kernels' own loop, at each
    of ``SHAPES``.  Each section's share of the threads' summed cycles
    (``GI_SECTIONS``; the rest is the camera ray, surface fetch, scatter
    and shading), and what the clocks cost: the kept kernel's device ms
    against the clocked one's, in turns (kept, clocked, clocked, kept).
    One line a kernel and shape; returns {"<kernel> <shape>": row}.  It
    uses only what the ReSTIR GI module had before, so that ``--ab`` runs
    it in an older checkout whose restir_gi.cu has the clocks."""
    import ctypes
    from unittest import mock

    import torch

    from fypraytracer_tpu_torch.ops import kernels
    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg
    from fypraytracer_tpu_torch.render.restir_common import camera_matrices

    kept = list(kernels.EXTRA_FLAGS.get("restir_gi", []))
    clocked = kept + [GI_CLOCKS]
    st = settings_for("RESTIR_GI")
    out = {}
    for name, w, h in SHAPES:
        scene, cam = tile_scene(name, w, h)
        B = w * h
        ppv = torch.as_tensor(cam.proj_view, device="cuda")
        cam_t = camera_matrices(cam, "cuda")
        for kernel in ("k5", "k5 final_vis", "k6"):
            z = (torch.zeros((mg.GT_ROWS, B), device="cuda"), torch.zeros((mg.GS_ROWS, B), device="cuda"))
            _, state, stage = mg.restir_gi_megakernel(scene, cam, *z, 1, 2, st, ppv, ppv, mono=kernel != "k6")
            outs = (torch.zeros((B, 3), device="cuda"), torch.empty_like(state), torch.empty_like(stage))

            def run(flags, kernel=kernel, state=state, stage=stage, outs=outs):
                with mock.patch.dict(kernels.EXTRA_FLAGS, {"restir_gi": flags}):
                    if kernel == "k6":
                        mg.restir_gi_k1(scene, cam, 3, st, state, ppv, outs[2], cam=cam_t)
                    else:
                        mg.restir_gi_mono(scene, cam, 3, st, state, stage, ppv, *outs,
                                          final_vis=kernel.endswith("final_vis"), cam=cam_t)

            sums = torch.zeros(len(GI_SECTIONS), dtype=torch.int64, device="cuda")
            with mock.patch.dict(kernels.EXTRA_FLAGS, {"restir_gi": clocked}):
                read = kernels.load("restir_gi", "fyp_restir_gi_clocks", [ctypes.c_void_p, ctypes.c_void_p])
                stream = kernels.stream_ptr(sums.device)
                kernels.check(read(kernels.ptr(sums), stream), "fyp_restir_gi_clocks")     # clears the sums
                run(clocked)
                kernels.check(read(kernels.ptr(sums), stream), "fyp_restir_gi_clocks")
            cycles = dict(zip(GI_SECTIONS, sums.tolist()))
            shares = {k: v / cycles["total"] for k, v in cycles.items() if k != "total"}
            shares["surface_scatter_shading"] = 1.0 - sum(shares.values())
            wrapper = mg.restir_gi_k1 if kernel == "k6" else mg.restir_gi_mono
            calls = 5 if B > 256 * 256 else 10
            turns = in_turns({"kept": functools.partial(run, kept), "clocked": functools.partial(run, clocked)},
                             ("kept", "clocked", "clocked", "kept"), calls, launches=lambda: wrapper.launches)
            key = f"{kernel} {name} {w}x{h}"
            out[key] = dict(kernel=kernel, shape=f"{name} {w}x{h}", shares=shares, cycles=cycles,
                            ms={k: statistics.median(v) for k, v in turns.items()}, turns_ms=turns)
            emit("gi_attribution", **out[key])
        check_overflow(scene)
    return out


DIFF_SIZE = 256
# K8 built with its gradient's atomics compiled out (csrc/megakernel_diff.cu)
K8_NO_ATOMICS = "-DFYP_DIFF_NO_ATOMICS"
# K2 built with its section clocks (csrc/megakernel.cu::Clocks), and the
# sections in the order of its Section enum
K2_CLOCKS = "-DFYP_K2_CLOCKS"
K2_SECTIONS = ("total", "walk_primary", "walk_shadow", "walk_bounce", "light")
# k2_attribution's launches: NEE at (scene, width, height, frames, calls)
K2_ATTRIBUTION = (("cornell", 256, 256, 64, 10), ("stress", 128, 128, 8, 10), ("cornell", 1920, 1088, 8, 5))
# K5 and K6 built with their section clocks (csrc/restir_gi.cu::Clocks), and
# the sections in the order of its Section enum
GI_CLOCKS = "-DFYP_GI_CLOCKS"
GI_SECTIONS = ("total", "primary", "path_walks", "tile_sum", "temporal", "spatial_reads", "vis_walks", "stores")
# K8 and K4 built with their section clocks and block spans (csrc/clocks.cuh;
# csrc/megakernel_diff.cu::Clocks, csrc/restir_di.cu::Clocks), and the
# sections in the order of their Section enums
DIFF_CLOCKS = "-DFYP_DIFF_CLOCKS"
DIFF_SECTIONS = ("total", "camera", "walk_camera", "walk_1", "walk_2", "walk_3", "walk_4", "surface", "scatter",
                 "loss_sum", "reverse_scan", "atomics")
DI_CLOCKS = "-DFYP_DI_CLOCKS"
DI_SECTIONS = ("total", "stage_reads", "neighbour_reads", "p_hat", "emitter", "shadow_walk", "writes")
# K3's, also built with -DFYP_DI_CLOCKS (csrc/restir_di.cu::K3Section)
K3_SECTIONS = ("total", "primary_walk", "surface", "candidates", "reproject", "tile_sum", "temporal", "writes")
# K7's, built with -DFYP_GI_CLOCKS (csrc/restir_gi.cu::K7Section), and its
# visibility-walk counters after them
K7_SECTIONS = ("total", "own_reads", "neighbour_tests", "jacobian", "vis_walks", "shade", "writes")
K7_COUNTERS = ("walk_lanes", "walk_rounds", "longest_lists")
# k8_attribution's launches: (scene, width, height, bounces, launches a turn)
K8_ATTRIBUTION = (("cornell", 256, 256, 2, 20), ("stress", 128, 128, 2, 20), ("cornell", 1920, 1088, 2, 10),
                  ("cornell", 256, 256, 4, 20))


def ulps(a, b):
    """Units in the last place between float32 tensors of one shape (as
    ordered integers: the distance across zero counts too)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (ordered(a) - ordered(b)).abs()


def k5_parting() -> None:
    """Where K5 and its plain version part, one frame after two of
    history, the camera static: the stage's rows by field (K5's stage is
    K6's bit for bit), the state's and the image's, each with the pixels
    that differ and the largest distance in ulps, on the stress scene at
    32² and on Cornell at 40x16 and 80x48 (the camera-ray cases of ROADMAP
    queue 3).  A diagnostic, no gate."""
    import copy

    import torch

    from fypraytracer_tpu_torch.core.camera import Camera
    from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg
    from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    st = settings_for("RESTIR_GI", spatial_neighbors=3, spatial_radius=8)
    rows = {"pos": (mg.GS_POS, 3), "nrm": (mg.GS_NRM, 3), "alb": (mg.GS_ALB, 3), "rough": (mg.GS_ROUGH, 1),
            "metal": (mg.GS_METAL, 1), "t": (mg.GS_T, 1), "shade": (mg.GS_SHADE, 1), "emit": (mg.GS_EMIT, 3),
            "hit": (mg.GS_HIT, 1), "sky": (mg.GS_SKY, 3), "sample_point": (mg.GS_SP, 3),
            "sample_normal": (mg.GS_SN, 3), "sample_radiance": (mg.GS_RAD, 3), "p_hat": (mg.GS_PHAT, 1),
            "w": (mg.GS_W, 1), "m": (mg.GS_M, 1), "wsum": (mg.GS_WSUM, 1)}
    scene_s, cam_s = stress_scene(128, 128)
    cam_s = copy.deepcopy(cam_s)
    cam_s.resize(32, 32)
    cases = [("stress 32x32", scene_s, cam_s)]
    for w, h in ((40, 16), (80, 48)):
        builder, _ = cornell_box(w, h, sphere_res=(6, 10))
        cases.append((f"cornell {w}x{h}", morton_permuted_scene(builder.compile())[0].to("cuda"),
                      Camera(position=(0.0, 1.0, 2.6), forward=(0, 0, -1), width=w, height=h)))
    for label, scene, cam in cases:
        B = cam.width * cam.height
        z = (torch.zeros((mg.GT_ROWS, B), device="cuda"), torch.zeros((mg.GS_ROWS, B), device="cuda"))
        _, state, stage = mg.restir_gi_megakernel_plain(scene, cam, *z, 1, 2, st, cam.proj_view, cam.proj_view)
        outs = []
        for fn in (mg.restir_gi_mono, mg.restir_gi_mono_plain):
            acc, s_, g_ = torch.zeros((B, 3), device="cuda"), torch.empty_like(state), torch.empty_like(stage)
            fn(scene, cam, 3, st, state, stage, cam.proj_view, acc, s_, g_)
            outs.append((acc, s_, g_))
        torch.cuda.synchronize()
        (acc_k, st_k, sg_k), (acc_p, st_p, sg_p) = outs

        def differ(a, b):
            d = ulps(a, b)
            return dict(pixels=int((d > 0).reshape(-1, B).any(0).sum()), max_ulps=int(d.max()))

        stage_rows = {k: differ(sg_k[r:r + n], sg_p[r:r + n]) for k, (r, n) in rows.items()}
        emit("k5_parting", case=label, frame=3, stage={k: v for k, v in stage_rows.items() if v["pixels"]},
             state=differ(st_k, st_p), image=differ(acc_k.T, acc_p.T), ok=True)

    # the device library's powf(x, 5), cosf, sinf and sqrtf (restir_gi.cu's
    # build) against PyTorch's x ** 5.0, cos, sin and sqrt on the card, on
    # the shading code's arguments: 1 - cos in [0, 1] and angles in [0, 2π)
    from fypraytracer_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.rand(1 << 20, generator=gen, device="cuda")
    phi = x * (2.0 * math.pi)
    for label, arg, row, plain in (("powf(x, 5) vs x ** 5.0", x, 0, lambda v: v ** 5.0),
                                   ("cosf vs torch.cos", phi, 1, torch.cos), ("sinf vs torch.sin", phi, 2, torch.sin),
                                   ("sqrtf vs torch.sqrt", x, 3, torch.sqrt)):
        d = ulps(kernels.math_ops("restir_gi", arg.contiguous())[row], plain(arg))
        emit("k5_parting", case=f"device library {label}", values=arg.numel(), differ=int((d > 0).sum()),
             max_ulps=int(d.max()), ok=True)


def diff_inputs(size: int = DIFF_SIZE):
    """Cornell at ``size``² on the card, its camera tensor, and a target
    made from a seed (uniform in [0, 0.5))."""
    import numpy as np
    import torch

    from fypraytracer_tpu_torch.render.restir_common import camera_matrices
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    builder, cam = cornell_box(size, size)
    scene = builder.compile().to("cuda")
    tgt = np.random.default_rng(2026).uniform(0.0, 0.5, (size * size, 3)).astype(np.float32)
    return scene, cam, camera_matrices(cam, "cuda"), torch.as_tensor(tgt, device="cuda")


def phase_diff(summary: dict) -> None:
    import dataclasses

    import torch

    from fypraytracer_tpu_torch.core.camera import generate_rays
    from fypraytracer_tpu_torch.ops.traverse import pick_tracer
    from fypraytracer_tpu_torch.render import megakernel_diff as md
    from fypraytracer_tpu_torch.render.integrators import radiance_hemisphere
    from fypraytracer_tpu_torch.scene.types import with_materials

    scene, cam, cam_t, tgt = diff_inputs()
    B = cam.width * cam.height
    alb = scene.materials.albedo
    tri_mat = scene.geometry.tri_mat.long()

    def d_mat(d_tri):
        return torch.zeros_like(alb).index_add_(0, tri_mat, d_tri)

    def rel(got, ref):
        return (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)

    # K8 against its plain version on the same inputs
    def run():
        return md.diff_megakernel(scene, cam, alb, tgt, 3, 2, SKY, cam=cam_t)

    run()                                                    # warm-up
    out = {}
    # 10 launches a rep, back to back, so that the host's work for one launch
    # overlaps the card's for the one before
    wrapper_ms = statistics.median(gpu_ms(lambda: [out.update(got=run()) for _ in range(10)], 5)) / 10
    ms = kernel_ms(run)
    with count_walks() as walks:
        plain_ms = statistics.median(gpu_ms(lambda: out.update(ref=md.diff_plain(scene, cam, alb, tgt, 3, 2, SKY)), 1))
    (loss, d_tri), (ref_loss, ref_tri) = out["got"], out["ref"]
    row = dict(loss=loss.item(), plain_loss=ref_loss.item(),
               loss_rel_err=abs(loss.item() - ref_loss.item()) / ref_loss.item(),
               d_tri_rel_err=rel(d_tri, ref_tri), d_mat_rel_err=rel(d_mat(d_tri), d_mat(ref_tri)),
               max_abs_err=(d_tri - ref_tri).abs().max().item())
    row["ok"] = bool(row["loss_rel_err"] <= 1e-5 and row["d_tri_rel_err"] <= 1e-4 and row["d_mat_rel_err"] <= 1e-4)
    emit("k8_vs_plain", size=f"{DIFF_SIZE}x{DIFF_SIZE}", bounces=2, frame=3, ms_per_launch=ms, wrapper_ms=wrapper_ms,
         plain_ms=plain_ms, **row)
    if not row["ok"]:
        raise AssertionError("K8 disagrees with its plain version")

    # K8's d_mat against torch autograd of the port's cosine wavefront (K1
    # traces), under the JAX test's gates (tests/test_diff_megakernel.py:64-66)
    a = alb.clone().requires_grad_(True)
    sc = with_materials(scene, dataclasses.replace(scene.materials, albedo=a))
    o, d = generate_rays(cam.inv_projection, cam.inv_view, cam.width, cam.height, device="cuda")
    hdr = radiance_hemisphere(sc, pick_tracer(sc), o, d, torch.arange(B, device="cuda"), 3,
                              settings_for("COSINE"), "cosine")
    ref = ((hdr - tgt) ** 2).sum() / (3 * B)
    ref.backward()
    auto = dict(loss_rel_err=abs(loss.item() - ref.item()) / ref.item(), d_mat_rel_err=rel(d_mat(d_tri), a.grad))
    auto["ok"] = bool(auto["loss_rel_err"] < 1e-4 and auto["d_mat_rel_err"] < 1e-3)

    # one launch per loss_and_grad
    dr = md.DiffRenderer(scene, cam, bounces=2, sky_color=SKY, device="cuda")
    before = md.diff_megakernel.launches
    dr.loss_and_grad(alb, tgt, 3)
    torch.cuda.synchronize()
    auto["launches_per_loss_and_grad"] = md.diff_megakernel.launches - before
    auto["ok"] = bool(auto["ok"] and auto["launches_per_loss_and_grad"] == 1)
    emit("k8_vs_autograd", size=f"{DIFF_SIZE}x{DIFF_SIZE}", **auto)
    if not auto["ok"]:
        raise AssertionError("K8 disagrees with autograd of the cosine wavefront, or launched other than once")

    # bytes: the scene tables it reads (the wide BVH's records), the camera,
    # the target, d_tri, the loss
    io = scene_bytes(scene, wide=True) + 2 * 16 * 4 + nbytes(tgt) + nbytes(d_tri) + 4
    summary["diff_megakernel"] = dict(max_abs_err=row["max_abs_err"], ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                      loss_rel_err=row["loss_rel_err"], d_tri_rel_err=row["d_tri_rel_err"],
                                      d_mat_rel_err=row["d_mat_rel_err"],
                                      parity_shape=f"cornell {DIFF_SIZE}x{DIFF_SIZE}, 2 bounces, frame 3",
                                      atomics_share=k8_attribution()["atomics_share"],
                                      **k8_by_shape(), **bound(walks, io))
    summary["diff_megakernel"].pop("outputs")


def k8_by_shape(outputs: bool = False) -> dict:
    """K8's device ms a launch (``kernel_ms``; frame 3, a target uniform in
    [0, 0.5) from a seed) at each of ``SHAPES`` with 2 bounces and at
    Cornell 256² with 4 (``ms_by_shape``), one line a shape; with
    ``outputs`` also its loss and d_tri at Cornell 256², for ``ab``'s
    gates.  It uses nothing that K8's module lacked before its move to the
    wide BVH, so that ``--ab`` can time an older checkout too."""
    import numpy as np
    import torch

    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render import megakernel_diff as md
    from fypraytracer_tpu_torch.render.restir_common import camera_matrices
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    out: dict = {"ms_by_shape": {}, "outputs": {}}
    for (name, w, h), bounces in [(shape, 2) for shape in SHAPES] + [(("cornell", 256, 256), 4)]:
        if name == "stress":
            scene, cam = stress_scene(w, h)
        else:
            builder, cam = cornell_box(w, h)
            scene = builder.compile().to("cuda")
        tgt = torch.as_tensor(np.random.default_rng(2026).uniform(0.0, 0.5, (w * h, 3)).astype(np.float32),
                              device="cuda")
        cam_t, alb = camera_matrices(cam, "cuda"), scene.materials.albedo
        key = f"{name} {w}x{h} bounces={bounces}"
        loss, d_tri = md.diff_megakernel(scene, cam, alb, tgt, 3, bounces, SKY, cam=cam_t)
        if outputs and (name, w) == ("cornell", 256):
            out["outputs"][key] = dict(loss=loss.item(), d_tri=d_tri.flatten().tolist())
        out["ms_by_shape"][key] = kernel_ms(lambda: md.diff_megakernel(scene, cam, alb, tgt, 3, bounces, SKY,
                                                                       cam=cam_t),
                                            launches=lambda: md.diff_megakernel.launches)
        torch.cuda.synchronize()
        check_overflow(scene)
        emit("k8_by_shape", shape=key, ms=out["ms_by_shape"][key])
    return out


def block_spans(spans, n_blocks: int) -> dict:
    """A launch's span from its blocks' starts and ends on the card's clock
    (``spans``: (2, n) int64 nanoseconds from a clocked build's reader):
    the launch in µs from the first start to the last end, the last start,
    the median and the longest block in µs, and the tail: the share of the
    launch that runs after the median block has ended (for a launch of one
    wave; with many waves the median block ends near the launch's middle
    whatever its tail)."""
    start, end = spans[0, :n_blocks], spans[1, :n_blocks]
    if bool((start < 0).any()) or bool((end <= 0).any()):
        raise AssertionError("a block of the clocked launch recorded no span")
    t0 = start.min()
    start, end = (start - t0).double() / 1e3, (end - t0).double() / 1e3
    launch = end.max().item()
    return dict(blocks=n_blocks, launch_us=launch, last_start_us=start.max().item(), median_end_us=end.median().item(),
                median_block_us=(end - start).median().item(), longest_block_us=(end - start).max().item(),
                tail_share=(launch - end.median().item()) / launch)


def clocked(lib: str, reader, flag: str, sections: tuple, run, n_blocks: int, calls: int, launches,
            others: dict | None = None, counters: tuple = ()) -> dict:
    """One call of ``run(flags)`` with ``lib`` built with its section clocks
    (``flag``; phase 2 builds it), read through the C entry that
    ``reader()`` loads: the cycles of each section summed over the threads,
    each section's share of the total (the rest under ``rest``), the
    kernel's ``counters`` (the sums after its sections, by name) and the
    blocks' spans (``block_spans``); then what the clocks cost: the kept
    build's device ms against the clocked one's over ``calls`` launches, in
    turns (kept, clocked, clocked, kept; ``others``, {name: extra flags},
    are builds timed between them)."""
    from unittest import mock

    import torch

    from fypraytracer_tpu_torch.ops import kernels

    flags = list(kernels.EXTRA_FLAGS.get(lib, [])) + [flag]
    sums = torch.zeros(len(sections) + len(counters), dtype=torch.int64, device="cuda")
    spans = torch.zeros((2, n_blocks), dtype=torch.int64, device="cuda")
    with mock.patch.dict(kernels.EXTRA_FLAGS, {lib: flags}):
        read = reader()
        stream = kernels.stream_ptr(sums.device)
        kernels.check(read(kernels.ptr(sums), kernels.ptr(spans), n_blocks, stream), f"{lib} clocks")   # clears them
        run(flags)
        kernels.check(read(kernels.ptr(sums), kernels.ptr(spans), n_blocks, stream), f"{lib} clocks")
    cycles = dict(zip(sections, sums.tolist()))
    counts = dict(zip(counters, sums.tolist()[len(sections):]))
    shares = {k: v / cycles["total"] for k, v in cycles.items() if k != "total"}
    shares["rest"] = 1.0 - sum(shares.values())
    kept = flags[:-1]
    sides = {"kept": kept, "clocked": flags, **{k: kept + v for k, v in (others or {}).items()}}
    order = ["kept", "clocked", *list(others or {}), *list(others or {})[::-1], "clocked", "kept"]
    turns = in_turns({k: functools.partial(run, v) for k, v in sides.items()}, order, calls, launches=launches)
    return dict(shares=shares, cycles=cycles, **({"counters": counts} if counters else {}),
                spans=block_spans(spans, n_blocks), ms={k: statistics.median(v) for k, v in turns.items()},
                turns_ms=turns)


def k8_attribution() -> dict:
    """Where K8's time goes, at each of ``K8_ATTRIBUTION`` (frame 3, a
    seeded target): the kernel built with its section clocks and block
    spans (``-DFYP_DIFF_CLOCKS``; phase 2 builds it), one launch: each
    section's share of the threads' summed cycles (``DIFF_SECTIONS``; the
    rest is the set-up, the keys and the contributions) and the share of
    the launch after its median block has ended (``block_spans``); and what
    the clocks cost, the kept kernel's device ms against the clocked one's
    in turns (kept, clocked, clocked, kept).  At Cornell 256² with 2
    bounces also the kept kernel against the same source built with
    ``-DFYP_DIFF_NO_ATOMICS`` (the gradient's atomics compiled out, the
    sums kept live), in turns; the atomics' share is 1 − without / kept.
    One line a case; returns {case: row} and the atomics' share."""
    import ctypes
    from unittest import mock

    import numpy as np
    import torch

    from fypraytracer_tpu_torch.ops import kernels
    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render import megakernel_diff as md
    from fypraytracer_tpu_torch.render.restir_common import camera_matrices
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    out: dict = {}
    for name, w, h, bounces, calls in K8_ATTRIBUTION:
        if name == "stress":
            scene, cam = stress_scene(w, h)
        else:
            builder, cam = cornell_box(w, h)
            scene = builder.compile().to("cuda")
        tgt = torch.as_tensor(np.random.default_rng(2026).uniform(0.0, 0.5, (w * h, 3)).astype(np.float32),
                              device="cuda")
        cam_t, alb = camera_matrices(cam, "cuda"), scene.materials.albedo

        def run(flags, scene=scene, cam=cam, alb=alb, tgt=tgt, cam_t=cam_t, bounces=bounces):
            with mock.patch.dict(kernels.EXTRA_FLAGS, {"megakernel_diff": flags}):
                md.diff_megakernel(scene, cam, alb, tgt, 3, bounces, SKY, cam=cam_t)

        # K8's blocks: four warps, each a tile of 8 x 4 pixels
        row = clocked("megakernel_diff", lambda: kernels.load("megakernel_diff", "fyp_diff_clocks", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]), DIFF_CLOCKS, DIFF_SECTIONS, run,
            ((w + 7) // 8 * ((h + 3) // 4) + 3) // 4, calls, lambda: md.diff_megakernel.launches,
            {"without_atomics": [K8_NO_ATOMICS]} if (name, w, bounces) == ("cornell", 256, 2) else None)
        if "without_atomics" in row["ms"]:
            out["atomics_share"] = 1.0 - row["ms"]["without_atomics"] / row["ms"]["kept"]
        key = f"{name} {w}x{h} bounces={bounces}"
        out[key] = row
        emit("k8_attribution", case=key, **row)
        check_overflow(scene)
    return out


def di_attribution() -> dict:
    """Where K3's and K4's time goes, at each of ``SHAPES`` (frame 3, after
    two frames of the DI loop): the kernels built with their section clocks
    and block spans (``-DFYP_DI_CLOCKS``; phase 2 builds it), one launch:
    each section's share of the threads' summed cycles (``K3_SECTIONS``,
    the rest the camera ray and the keys; ``DI_SECTIONS``, the rest the
    camera ray, the keys, the reservoir updates and the final sum) and the
    share of the launch after its median block has ended (``block_spans``);
    and what the clocks cost, the kept kernel's device ms against the
    clocked one's in turns (kept, clocked, clocked, kept).  K3 in the launch
    the wrapper picks and, where it picks one block a tile, split over
    clusters too.  One line a kernel, shape and launch; returns
    {"<kernel> <shape> [<launch>]": row}."""
    import ctypes
    from unittest import mock

    import torch

    from fypraytracer_tpu_torch.ops import kernels
    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render import megakernel_restir as mr
    from fypraytracer_tpu_torch.render import restir_common as rc
    from fypraytracer_tpu_torch.render.restir_common import TILE_BLOCK, camera_matrices

    st = settings_for("RESTIR_DI")
    out = {}
    for name, w, h in SHAPES:
        scene, cam = tile_scene(name, w, h)
        B = w * h
        ppv = torch.as_tensor(cam.proj_view, device="cuda")
        cam_t = camera_matrices(cam, "cuda")
        em = mr.prepare_emissive_table(scene)
        state = torch.zeros((mr.ST_ROWS, B), device="cuda")
        mr.restir_di_megakernel(scene, em, cam, state, 1, 2, st, ppv, ppv)
        calls = 10 if B > 256 * 256 else 20
        lay = rc.pick_tile_launch(scene, B, cam_t.device)
        for launch in ["picked"] + ([] if lay["clustered"] else ["split"]):
            split = launch == "split" or lay["clustered"]

            def k3(flags, split=split, scene=scene, em=em, cam=cam, state=state, ppv=ppv, cam_t=cam_t):
                with mock.patch.dict(kernels.EXTRA_FLAGS, {"restir_di": flags}), \
                        mock.patch.object(rc, "tile_clustered", lambda *_: split):
                    mr.restir_di_k3(scene, em, cam, 3, st, state, ppv, cam=cam_t)

            row = clocked("restir_di", lambda: kernels.load("restir_di", "fyp_restir_di_k3_clocks", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]), DI_CLOCKS, K3_SECTIONS, k3,
                          B // (TILE_BLOCK if split else rc.pick_ray_lanes(B)), calls,
                          lambda: mr.restir_di_k3.launches)
            key = f"k3 {name} {w}x{h} {launch}"
            out[key] = dict(row, launch=launch, split=split)
            emit("di_attribution", kernel="k3", shape=f"{name} {w}x{h}", launch=launch, split=split, **row)
        stage = mr.restir_di_k3(scene, em, cam, 3, st, state, ppv, cam=cam_t)
        acc, st_out = torch.zeros((B, 3), device="cuda"), torch.empty_like(state)

        def k4(flags, scene=scene, em=em, cam=cam, stage=stage, st_out=st_out, acc=acc, cam_t=cam_t):
            with mock.patch.dict(kernels.EXTRA_FLAGS, {"restir_di": flags}):
                mr.restir_di_k4(scene, em, cam, 3, st, stage, st_out, acc, cam=cam_t)

        row = clocked("restir_di", lambda: kernels.load("restir_di", "fyp_restir_di_clocks", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]), DI_CLOCKS, DI_SECTIONS, k4,
            B // TILE_BLOCK, calls, lambda: mr.restir_di_k4.launches)
        key = f"k4 {name} {w}x{h}"
        out[key] = row
        emit("di_attribution", kernel="k4", shape=f"{name} {w}x{h}", **row)
        check_overflow(scene)
    return out


def k7_attribution() -> dict:
    """Where K7's time goes, at each of ``SHAPES`` (frame 3, its stage from
    K6 after two frames of the ``mono=False`` loop): the kernel built with
    its section clocks, block spans and visibility-walk counters
    (``-DFYP_GI_CLOCKS``; phase 2 builds it), one launch: each section's
    share of the threads' summed cycles (``K7_SECTIONS``; the rest is the
    keys and the camera ray), the share of the launch after its median
    block has ended, and the walks: the lanes that walk a walk round (a
    round: a neighbour that some lane of the warp walks) and the rounds a
    warp against the most walks any one lane needs (a warp walking each
    lane's own list needs only the latter); and what the clocks cost, in
    turns (kept, clocked, clocked, kept).  One line a shape; returns
    {shape: row}."""
    import ctypes
    from unittest import mock

    import torch

    from fypraytracer_tpu_torch.ops import kernels
    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg
    from fypraytracer_tpu_torch.render.restir_common import TILE_BLOCK, camera_matrices

    st = settings_for("RESTIR_GI")
    out = {}
    for name, w, h in SHAPES:
        scene, cam = tile_scene(name, w, h)
        B = w * h
        ppv = torch.as_tensor(cam.proj_view, device="cuda")
        cam_t = camera_matrices(cam, "cuda")
        z = (torch.zeros((mg.GT_ROWS, B), device="cuda"), torch.zeros((mg.GS_ROWS, B), device="cuda"))
        _, state, _ = mg.restir_gi_megakernel(scene, cam, *z, 1, 2, st, ppv, ppv, mono=False)
        stage = mg.restir_gi_k1(scene, cam, 3, st, state, ppv, cam=cam_t)
        acc, st_out = torch.zeros((B, 3), device="cuda"), torch.empty_like(state)

        def k7(flags, scene=scene, cam=cam, stage=stage, st_out=st_out, acc=acc, cam_t=cam_t):
            with mock.patch.dict(kernels.EXTRA_FLAGS, {"restir_gi": flags}):
                mg.restir_gi_k2(scene, cam, 3, st, stage, st_out, acc, cam=cam_t)

        row = clocked("restir_gi", lambda: kernels.load("restir_gi", "fyp_restir_gi_k7_clocks", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]), GI_CLOCKS, K7_SECTIONS, k7,
            B // TILE_BLOCK, 10 if B > 256 * 256 else 20, lambda: mg.restir_gi_k2.launches, counters=K7_COUNTERS)
        c = row["counters"]
        row["walks"] = dict(lanes_a_round=c["walk_lanes"] / max(c["walk_rounds"], 1),
                            rounds_over_longest_list=c["walk_rounds"] / max(c["longest_lists"], 1),
                            walks_a_pixel=c["walk_lanes"] / B)
        key = f"{name} {w}x{h}"
        out[key] = row
        emit("k7_attribution", shape=key, **row)
        check_overflow(scene)
    return out


# the textured phase's seeded page: larger than the kernels' 256² primary
# level, which box-filters it (ops/texture.py::kernel_atlas)
TEX_BIG = 1024
TEX_SEED = 2026
# each textured kernel's row in the summary, and the JAX kernel and fetch it replaces
TEX_ROWS = {"NEE_MIS": "megakernel[nee,textured]", "COSINE": "megakernel[cosine,textured]",
            "LIGHT_SOURCE": "megakernel[light,textured]"}


@functools.lru_cache(maxsize=None)
def textured_host(width: int, height: int):
    """The textured Cornell box (the 64² checker and a seeded 1024² page) as
    host arrays, triangles in Morton order, and its camera; built once per
    size."""
    from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
    from fypraytracer_tpu_torch.scene.procedural import textured_cornell_box

    builder, cam = textured_cornell_box(width, height, big=TEX_BIG, seed=TEX_SEED)
    return morton_permuted_scene(builder.compile())[0], cam


@functools.lru_cache(maxsize=None)
def textured_scene(width: int, height: int):
    """``textured_host`` on the card."""
    host, cam = textured_host(width, height)
    return host.to("cuda"), cam


@contextlib.contextmanager
def count_fetches():
    """Count the textured albedo fetches of every plain render inside the
    block: the lanes of ``sample_bilinear`` calls whose texture id is >= 0.
    Yields a dict whose "fetches" is an int once the block has ended."""
    from unittest import mock

    from fypraytracer_tpu_torch.render import integrators

    counts = {"fetches": 0}
    sample = integrators.sample_bilinear

    def counted(atlas, tex_id, u, v, bounce=False):
        counts["fetches"] += (tex_id >= 0).sum()
        return sample(atlas, tex_id, u, v, bounce=bounce)

    with mock.patch.object(integrators, "sample_bilinear", counted):
        yield counts
    counts["fetches"] = int(counts["fetches"])


def tex_bytes(tex, fetches: int) -> int:
    """The texel reads of ``fetches`` bilinear fetches (4 texels of 12 bytes
    each), at most the texture tables read once."""
    return min(48 * fetches, nbytes(tex.prim, tex.bounce) * 3 // 4)


def phase_textured(summary: dict) -> None:
    """The textured instantiations of K2, K3, K5 and K6 against their plain
    versions on the textured Cornell box at 256² (a seeded 1024² page
    box-filtered to the kernels' 256² primary level, and the 64² checker)."""
    import torch

    from fypraytracer_tpu_torch.ops.traverse import trace_rays
    from fypraytracer_tpu_torch.render import megakernel_restir as mr
    from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg
    from fypraytracer_tpu_torch.render.megakernel import (MegakernelRenderer, megakernel, megakernel_plain,
                                                         morton_permuted_scene)
    from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
    from fypraytracer_tpu_torch.render.renderer import frame_hdr
    from fypraytracer_tpu_torch.render.restir_common import camera_matrices, camera_rays
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    scene, cam = textured_scene(256, 256)
    size, B = 256, 256 * 256
    tex = scene.tex
    if tex is None:
        raise AssertionError("the textured scene has no texture tables")
    amap = scene.materials.albedo_map
    o, d = camera_rays(cam, "cuda")
    prim = trace_rays(scene.bvh, scene.geometry, o, d)["tri"]
    prim_tex = int(((prim >= 0) & (amap[scene.geometry.tri_mat[prim.clamp_min(0).long()].long()] >= 0)).sum())
    emit("textured_scene", atlas=list(scene.textures.pages.shape), bounce_level=list(scene.textures.bounce_pages.shape),
         kernel_levels=[list(tex.prim.shape), list(tex.bounce.shape)], textured_primary_pixels=prim_tex,
         triangles=int(scene.geometry.tri_v.shape[0]))

    # K2: NEE, cosine and light at the main path's shape, 8 frames
    for tech, name in TEX_ROWS.items():
        st = settings_for(tech)
        frames = 8
        megakernel(scene, cam, 1, frames, st)                   # warm-up
        out = {}
        wrapper_ms = statistics.median(gpu_ms(lambda: out.update(got=megakernel(scene, cam, 1, frames, st)), 5))
        ms = kernel_ms(lambda: megakernel(scene, cam, 1, frames, st))
        with count_walks() as walks, count_fetches() as fetches:
            plain_ms = statistics.median(gpu_ms(lambda: out.update(ref=megakernel_plain(scene, cam, 1, frames, st)), 1))
        row = parity(out["got"].cpu().numpy(), out["ref"].cpu().numpy())
        # the documented deviation: the kernel's 256² level against the
        # wavefront's native 1024² mip 0 (K1 traces), no gate
        native = sum(frame_hdr(scene, cam, 1 + f, st).reshape(-1, 3) for f in range(frames))
        dev = parity(out["got"].cpu().numpy(), native.cpu().numpy())
        emit("textured_k2_vs_plain", technique=tech, size=f"{size}x{size}", frames=frames, ms_per_launch=ms,
             wrapper_ms=wrapper_ms, plain_ms=plain_ms, fetches=fetches["fetches"], **row)
        emit("textured_k2_vs_native_mip0_wavefront", technique=tech, frames=frames,
             **{k: v for k, v in dev.items() if k != "ok"})
        if not row["ok"]:
            raise AssertionError(f"textured K2 disagrees with its plain version: {tech}")
        # K2 walks and fetches at the primary hit once a launch, the plain version once a frame
        pw = {"nodes": 0, "tris": 0}
        trace_rays(scene.bvh, scene.geometry, o, d, counts=pw)
        walks = {k: walks[k] - (frames - 1) * int(pw[k]) for k in walks}
        n_fetch = fetches["fetches"] - (frames - 1) * prim_tex
        io = scene_bytes(scene, lights=tech in ("NEE_MIS", "LIGHT_SOURCE"), wide=True,
                         positions=tech in ("NEE_MIS", "LIGHT_SOURCE")) + nbytes(scene.geometry.uvs, amap) \
            + 2 * 16 * 4 + B * 12 + tex_bytes(tex, n_fetch)
        summary[name] = dict(max_abs_err=row["max_abs"], ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                             median_abs_err=row["median_abs"], frac_px_over_1e3=row["frac_px_over_1e3"],
                             untextured_ms=summary[K2_NAMES[tech]]["ms"],
                             fetches=n_fetch, parity_shape=f"textured cornell {size}x{size}x{frames}f",
                             vs_native_mip0=dict(median_abs=dev["median_abs"], frac_px_over_1e3=dev["frac_px_over_1e3"],
                                                 mean_rel=dev["mean_rel"]),
                             **bound(walks, io))

    # K3 alone against its plain version after two frames of history, and
    # the K3+K4 frame loop (4 frames)
    st = settings_for("RESTIR_DI")
    em = mr.prepare_emissive_table(scene)
    ppv = torch.as_tensor(cam.proj_view, device="cuda")
    cam_t = camera_matrices(cam, "cuda")
    k3 = functools.partial(mr.restir_di_k3, cam=cam_t)
    state = torch.zeros((mr.ST_ROWS, B), device="cuda")
    mr.restir_di_megakernel_plain(scene, em, cam, state, 1, 2, st, ppv, ppv)
    out = {}
    k3(scene, em, cam, 3, st, state, ppv)                        # warm-up
    wrapper_ms = statistics.median(gpu_ms(lambda: out.update(stage=k3(scene, em, cam, 3, st, state, ppv)), 5))
    ms = kernel_ms(lambda: k3(scene, em, cam, 3, st, state, ppv))
    with count_walks() as walks, count_fetches() as fetches:
        plain_ms = statistics.median(gpu_ms(
            lambda: out.update(ref=mr.restir_di_k3_plain(scene, em, cam, 3, st, state, ppv)), 1))
    dd = (out["stage"] - out["ref"]).abs()
    off = ((dd > 1e-3 * torch.clamp_min(out["ref"].abs(), 1.0)).any(0)).float().mean().item()
    alb = slice(mr.S_ALB, mr.S_ALB + 3)
    alb_err = dd[alb].max().item()
    emit("textured_k3_vs_plain", size=f"{size}x{size}", ms_per_launch=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
         frac_px_over_1e3=off, max_abs_err=dd.max().item(), albedo_rows_max_abs_err=alb_err,
         fetches=fetches["fetches"], ok=off < 0.01)
    if not off < 0.01:
        raise AssertionError("textured K3 disagrees with its plain version")
    em_bytes = nbytes(em.p0, em.e1, em.e2, em.area, em.normal, em.emission, em.centroid, em.tri)
    io = scene_bytes(scene, wide=True) + nbytes(scene.geometry.uvs, amap) + em_bytes + 3 * 16 * 4 + 6 * B * 4 \
        + nbytes(out["stage"]) + tex_bytes(tex, fetches["fetches"])
    # the untextured K3 at the same shape (Cornell 256², frame 3 after 2 of
    # history), beside it
    plain_host, _ = cornell_box(size, size)
    flat = morton_permuted_scene(plain_host.compile())[0].to("cuda")
    flat_em = mr.prepare_emissive_table(flat)
    flat_state = torch.zeros((mr.ST_ROWS, B), device="cuda")
    mr.restir_di_megakernel_plain(flat, flat_em, cam, flat_state, 1, 2, st, ppv, ppv)
    k3(flat, flat_em, cam, 3, st, flat_state, ppv)              # warm-up
    untextured_ms = kernel_ms(lambda: k3(flat, flat_em, cam, 3, st, flat_state, ppv))
    emit("textured_k3_beside_untextured", size=f"{size}x{size}", textured_ms=ms, untextured_ms=untextured_ms)
    summary["restir_di_k3[textured]"] = dict(max_abs_err=dd.max().item(), ms=ms, wrapper_ms=wrapper_ms,
                                             plain_ms=plain_ms, frac_px_over_1e3=off, fetches=fetches["fetches"],
                                             untextured_ms=untextured_ms,
                                             parity_shape=f"textured cornell {size}x{size}, frame 3 after 2 of history",
                                             **bound(walks, io))
    loops = []
    for fn in (mr.restir_di_megakernel, mr.restir_di_megakernel_plain):
        stt = torch.zeros((mr.ST_ROWS, B), device="cuda")
        loops.append(fn(scene, em, cam, stt, 1, 4, st, cam.proj_view, cam.proj_view).cpu().numpy())
    row = parity(*loops)
    emit("textured_k3k4_frames_vs_plain", size=f"{size}x{size}", frames=4, **row)
    if not row["ok"]:
        raise AssertionError("the textured K3+K4 frame loop disagrees with its plain version")

    # K5 (both modes) and K6 against their plain versions, one frame after two
    # of history on the same inputs; then the K5 and K6+K7 frame loops
    gst = settings_for("RESTIR_GI")
    z = (torch.zeros((mg.GT_ROWS, B), device="cuda"), torch.zeros((mg.GS_ROWS, B), device="cuda"))
    _, gstate, gstage = mg.restir_gi_megakernel_plain(scene, cam, *z, 1, 2, gst, ppv, ppv)

    def gi_off(got, ref):
        return ((got - ref).abs() > 1e-3 * torch.clamp_min(ref.abs(), 1.0)).any(0).float().mean().item()

    def k1(fn):
        return (fn(scene, cam, 3, gst, gstate, ppv),)

    def mono(final_vis):
        def run(fn):
            a, s_, g_ = torch.zeros((B, 3), device="cuda"), torch.empty_like(gstate), torch.empty_like(gstage)
            fn(scene, cam, 3, gst, gstate, gstage, ppv, a, s_, g_, final_vis=final_vis)
            return s_, g_, a.T
        return run

    n_shade = int((gstage[mg.GS_SHADE] > 0.5).sum())
    k1_in = scene_bytes(scene, wide=True) + nbytes(scene.geometry.uvs, amap) + 3 * 16 * 4 + 15 * n_shade * 4
    k5_in = k1_in + 19 * B * 4 + B * 12
    # (row, the untextured kernel's row at the same shape, ...)
    cases = [("restir_gi_k1[textured]", "restir_gi_k1", k1, functools.partial(mg.restir_gi_k1, cam=cam_t),
              mg.restir_gi_k1_plain, k1_in),
             ("restir_gi_mono[textured]", "restir_gi_mono", mono(False),
              functools.partial(mg.restir_gi_mono, cam=cam_t), mg.restir_gi_mono_plain, k5_in),
             ("restir_gi_mono[final_vis,textured]", "restir_gi_mono[final_vis]", mono(True),
              functools.partial(mg.restir_gi_mono, cam=cam_t), mg.restir_gi_mono_plain, k5_in)]
    for name, flat_name, run, kernel, plain, in_bytes in cases:
        run(kernel)                                              # warm-up
        out = {}
        wrapper_ms = statistics.median(gpu_ms(lambda: [out.update(got=run(kernel)) for _ in range(10)], 5)) / 10
        ms = kernel_ms(lambda: run(kernel))
        with count_walks() as walks, count_fetches() as fetches:
            plain_ms = statistics.median(gpu_ms(lambda: out.update(ref=run(plain)), 1))
        frac = max(gi_off(a, b) for a, b in zip(out["got"], out["ref"]))
        err = max((a - b).abs().max().item() for a, b in zip(out["got"], out["ref"]))
        summary[name] = dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, frac_px_over_1e3=frac,
                             fetches=fetches["fetches"], untextured_ms=summary[flat_name]["ms"],
                             parity_shape=f"textured cornell {size}x{size}, frame 3 after 2 of history",
                             **bound(walks, in_bytes + nbytes(*out["ref"]) + tex_bytes(tex, fetches["fetches"])))
        emit("textured_gi_kernel_vs_plain", kernel=name, size=f"{size}x{size}", ms_per_launch=ms,
             wrapper_ms=wrapper_ms, plain_ms=plain_ms, frac_px_over_1e3=frac, max_abs_err=err, bitwise=err == 0.0,
             fetches=fetches["fetches"], ok=frac < 0.01)
        if not frac < 0.01:
            raise AssertionError(f"{name} disagrees with its plain version")
    for mode in (dict(mono=True), dict(mono=True, final_vis=True), dict(mono=False)):
        loops = []
        for fn in (mg.restir_gi_megakernel, mg.restir_gi_megakernel_plain):
            zz = (torch.zeros((mg.GT_ROWS, B), device="cuda"), torch.zeros((mg.GS_ROWS, B), device="cuda"))
            loops.append(fn(scene, cam, *zz, 1, 4, gst, cam.proj_view, cam.proj_view, **mode)[0].cpu().numpy())
        row = parity(*loops)
        emit("textured_gi_frames_vs_plain", size=f"{size}x{size}", frames=4, mode=mode, **row)
        if not row["ok"]:
            raise AssertionError(f"the textured GI frame loop {mode} disagrees with its plain version")

    # textured ReSTIR DI is unbiased: its mean against light sampling's at 64²
    # (tests/test_textured_megakernel.py:54-72, the 5% bound)
    host, c64 = textured_host(64, 64)
    di = MegakernelReSTIRDI(host, c64, settings_for("RESTIR_DI", light_candidates=4, spatial_neighbors=3,
                                                    spatial_radius=8, sky_color=(0.0, 0.0, 0.0)),
                            device="cuda").render_many(64)
    light = MegakernelRenderer(host, c64, settings_for("LIGHT_SOURCE", samples=4, sky_color=(0.0, 0.0, 0.0)),
                               device="cuda").render_many(256)
    rel = abs(di.mean().item() - light.mean().item()) / light.mean().item()
    ok = bool(torch.isfinite(di).all()) and rel < 0.05
    emit("textured_restir_di_unbiased", size="64x64", di_frames=64, light_frames=256, di_mean=di.mean().item(),
         light_mean=light.mean().item(), rel=rel, ok=ok)
    if not ok:
        raise AssertionError("textured ReSTIR DI's mean is off light-source sampling's by 5% or more")


def phase_main(summary: dict) -> None:
    import torch

    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer
    from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
    from fypraytracer_tpu_torch.render.megakernel_restir_gi import MegakernelReSTIRGI
    from fypraytracer_tpu_torch.render.renderer import Renderer
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    def path(name, make, golden, expect, needs):
        """Drive one entry point with the counters reset just before and read
        just after; fail unless every kernel in ``needs`` launched."""
        reset_launches()
        avg = make()
        torch.cuda.synchronize()
        launched = launch_counts()
        row = score(avg, golden, expect)
        row["ok"] = bool(row["ok"] and all(launched[k] > 0 for k in needs))
        emit("main_path", path=name, launches=launched, **row)
        if not row["ok"]:
            raise AssertionError(f"main path {name} failed its checks or did not launch {needs}")
        return launched

    # Cornell NEE at 256² through both entry points (the main path)
    def cornell(cls, tech="NEE_MIS", size=256, frames=8, **kw):
        builder, cam = cornell_box(size, size)
        return lambda: cls(builder.compile(), cam, settings_for(tech, **kw), device="cuda").render_many(frames)

    n = path("Renderer cornell NEE_MIS", cornell(Renderer), "cornell_nee.png", (256, 256, 3), ["trace_closest"])
    summary.setdefault("trace_closest", {})["launches"] = n["trace_closest"]
    n = path("MegakernelRenderer cornell NEE_MIS", cornell(MegakernelRenderer), "cornell_nee.png", (256, 256, 3),
             ["megakernel"])
    summary[K2_NAMES["NEE_MIS"]]["launches"] = n["megakernel"]
    # every other technique of K2 (no golden in the repository for them)
    for tech in ("BRUTE_FORCE", "UNIFORM", "COSINE", "GGX", "BRDF", "LIGHT_SOURCE"):
        n = path(f"MegakernelRenderer cornell {tech}", cornell(MegakernelRenderer, tech), None, (256, 256, 3),
                 ["megakernel"])
        summary[K2_NAMES[tech]]["launches"] = n["megakernel"]

    # the stress scene at 128², tpu_smoke's settings, both goldens
    scene, cam = stress_scene(128, 128)
    path("MegakernelRenderer stress NEE_MIS",
         lambda: MegakernelRenderer(scene, cam, settings_for("NEE_MIS"), device="cuda").render_many(8),
         "stress_nee.png", (128, 128, 3), ["megakernel"])
    check_overflow(scene)
    n = path("MegakernelReSTIRDI stress RESTIR_DI",
             lambda: MegakernelReSTIRDI(scene, cam, settings_for("RESTIR_DI"), device="cuda").render_many(8),
             "stress_di.png", (128, 128, 3), ["restir_di_k3", "restir_di_k4"])
    summary["restir_di_k3"]["launches"] = n["restir_di_k3"]
    summary["restir_di_k4"]["launches"] = n["restir_di_k4"]

    # ReSTIR DI is unbiased: its image mean against light-source sampling's
    # (tests/test_megakernel_restir.py:9-28 settings and 5% bound)
    builder, cam = cornell_box(64, 64, with_spheres=False)
    di = MegakernelReSTIRDI(builder.compile(), cam, settings_for(
        "RESTIR_DI", light_candidates=4, spatial_neighbors=3, spatial_radius=8, sky_color=(0.0, 0.0, 0.0)),
        device="cuda").render_many(64)
    builder, cam = cornell_box(64, 64, with_spheres=False)
    light = MegakernelRenderer(builder.compile(), cam, settings_for("LIGHT_SOURCE", samples=4, sky_color=(0.0, 0.0, 0.0)),
                               device="cuda").render_many(256)
    rel = abs(di.mean().item() - light.mean().item()) / light.mean().item()
    ok = bool(torch.isfinite(di).all()) and rel < 0.05
    emit("restir_di_unbiased", size="64x64", di_frames=64, light_frames=256, di_mean=di.mean().item(),
         light_mean=light.mean().item(), rel=rel, ok=ok)
    if not ok:
        raise AssertionError("ReSTIR DI's mean is off light-source sampling's by 5% or more")

    # ReSTIR GI at the main path's shape: the three kernel paths (no golden
    # for Cornell GI in the repository; the room's wait for its assets) and
    # the K1 wavefront; mono on the stress scene
    def gi(**mode):
        return functools.partial(MegakernelReSTIRGI, **mode)

    n = path("MegakernelReSTIRGI cornell RESTIR_GI mono", cornell(gi(), "RESTIR_GI"), None, (256, 256, 3),
             ["restir_gi_mono"])
    summary["restir_gi_mono"]["launches"] = n["restir_gi_mono"]
    n = path("MegakernelReSTIRGI cornell RESTIR_GI mono final_vis", cornell(gi(final_vis=True), "RESTIR_GI"), None,
             (256, 256, 3), ["restir_gi_mono"])
    summary["restir_gi_mono[final_vis]"]["launches"] = n["restir_gi_mono"]
    n = path("MegakernelReSTIRGI cornell RESTIR_GI mono=False", cornell(gi(mono=False), "RESTIR_GI"), None,
             (256, 256, 3), ["restir_gi_k1", "restir_gi_k2"])
    summary["restir_gi_k1"]["launches"] = n["restir_gi_k1"]
    summary["restir_gi_k2"]["launches"] = n["restir_gi_k2"]
    path("Renderer cornell RESTIR_GI", cornell(Renderer, "RESTIR_GI"), None, (256, 256, 3), ["trace_closest"])
    path("MegakernelReSTIRGI stress RESTIR_GI mono",
         lambda: MegakernelReSTIRGI(*stress_scene(128, 128), settings_for("RESTIR_GI"), device="cuda").render_many(8),
         None, (128, 128, 3), ["restir_gi_mono"])

    # ReSTIR GI is unbiased: against the BRDF path tracer at 4 spp, image mean
    # and quadrants (tests/test_megakernel_restir.py:158-257), and final_vis
    # against per-neighbour visibility with spheres (:260-286)
    def gi_avg(spheres, **mode):
        builder, cam = cornell_box(64, 64, with_spheres=spheres)
        return MegakernelReSTIRGI(builder.compile(), cam, settings_for(
            "RESTIR_GI", spatial_neighbors=3, spatial_radius=8, sky_color=(0.0, 0.0, 0.0)), device="cuda",
            **mode).render_many(256)

    def close(a, b, mean_tol, quad_tol):
        a, b = a.cpu().double(), b.cpu().double()
        quads = [abs(a[ys, xs].mean() - b[ys, xs].mean()).item() / max(b[ys, xs].mean().item(), 1e-9)
                 for ys in (slice(0, 32), slice(32, 64)) for xs in (slice(0, 32), slice(32, 64))]
        rel = abs(a.mean() - b.mean()).item() / b.mean().item()
        return dict(a_mean=a.mean().item(), b_mean=b.mean().item(), rel=rel, quadrant_rel=quads,
                    ok=bool(torch.isfinite(a).all()) and rel < mean_tol and max(quads) < quad_tol)

    builder, cam = cornell_box(64, 64, with_spheres=False)
    brdf = MegakernelRenderer(builder.compile(), cam, settings_for("BRDF", samples=4, sky_color=(0.0, 0.0, 0.0)),
                              device="cuda").render_many(256)
    checks = [("mono vs brdf", close(gi_avg(False), brdf, 0.06, 0.15)),
              ("mono=False vs brdf", close(gi_avg(False, mono=False), brdf, 0.06, 0.15)),
              ("final_vis vs per-neighbour", close(gi_avg(True, final_vis=True), gi_avg(True), 0.05, 0.12))]
    for name, row in checks:
        emit("restir_gi_unbiased", check=name, size="64x64", frames=256, **row)
    if not all(row["ok"] for _, row in checks):
        raise AssertionError("ReSTIR GI's mean is off its reference beyond the JAX package's bounds")

    # the textured Cornell box at 256², 8 frames, through the entry points:
    # every textured instantiation launches (no golden in the repository)
    host, tcam = textured_host(256, 256)
    tex_paths = [("MegakernelRenderer", MegakernelRenderer, tech, {}, ["megakernel"], row)
                 for tech, row in TEX_ROWS.items()]
    tex_paths += [("MegakernelReSTIRDI", MegakernelReSTIRDI, "RESTIR_DI", {}, ["restir_di_k3", "restir_di_k4"],
                   "restir_di_k3[textured]"),
                  ("MegakernelReSTIRGI mono", MegakernelReSTIRGI, "RESTIR_GI", {}, ["restir_gi_mono"],
                   "restir_gi_mono[textured]"),
                  ("MegakernelReSTIRGI mono final_vis", MegakernelReSTIRGI, "RESTIR_GI", dict(final_vis=True),
                   ["restir_gi_mono"], "restir_gi_mono[final_vis,textured]"),
                  ("MegakernelReSTIRGI mono=False", MegakernelReSTIRGI, "RESTIR_GI", dict(mono=False),
                   ["restir_gi_k1", "restir_gi_k2"], "restir_gi_k1[textured]")]
    for label, cls, tech, kw, needs, row in tex_paths:
        n = path(f"{label} textured cornell {tech}",
                 lambda: cls(host, tcam, settings_for(tech), device="cuda", **kw).render_many(8), None, (256, 256, 3),
                 needs)
        summary[row]["launches"] = n[needs[0]]


def phase_train(summary: dict) -> None:
    """Training at Cornell 256² through both entry points, each with the
    launch counters reset just before and read just after."""
    import dataclasses

    import torch

    from fypraytracer_tpu_torch.core.camera import generate_rays
    from fypraytracer_tpu_torch.ops.traverse import pick_tracer
    from fypraytracer_tpu_torch.parallel.shard import make_train_step
    from fypraytracer_tpu_torch.render.integrators import radiance_hemisphere, radiance_nee_mis
    from fypraytracer_tpu_torch.render.megakernel_diff import DiffRenderer

    scene, cam, _, _ = diff_inputs()
    B = cam.width * cam.height
    o, d = generate_rays(cam.inv_projection, cam.inv_view, cam.width, cam.height, device="cuda")
    pix = torch.arange(B, device="cuda")
    cosine = settings_for("COSINE")
    # frames 1-3, not the CLI's 1-4: at 256² frame 4 holds a firefly of ~3,300
    # on the mirror sphere, whose squared error alone drives that albedo to
    # a clip bound (PERF.md, PR 4)
    tgts = {f: radiance_hemisphere(scene, pick_tracer(scene), o, d, pix, f, cosine, "cosine") for f in (1, 2, 3)}
    true_alb = scene.materials.albedo
    gen = torch.Generator(device="cuda").manual_seed(0)
    start = torch.clamp(true_alb + 0.25 * torch.randn(true_alb.shape, generator=gen, device="cuda"), 0.05, 0.95)

    # the JAX CLI's _train_fast loop (cli.py:375-417) through DiffRenderer
    dr = DiffRenderer(scene, cam, bounces=2, sky_color=SKY, device="cuda")
    reset_launches()
    alb, losses = start, []
    for i in range(9):
        f = 1 + i % 3
        alb, loss = dr.step(alb, tgts[f], f, lr=3.0)
        alb = torch.clamp(alb, 0.0, 1.0)
        losses.append(loss)
    torch.cuda.synchronize()
    launched = launch_counts()
    losses = [x.item() for x in losses]
    err0, err1 = (start - true_alb).abs().mean().item(), (alb - true_alb).abs().mean().item()
    ok = bool(err1 < 0.6 * err0 and losses[-1] < losses[0] and launched["diff_megakernel"] == 9
              and all(v == 0 for k, v in launched.items() if k != "diff_megakernel"))
    emit("main_path", path="DiffRenderer.step cornell COSINE", size=f"{cam.width}x{cam.height}", steps=9,
         launches=launched, albedo_mae_start=err0, albedo_mae_end=err1, losses=losses, ok=ok)
    if not ok:
        raise AssertionError("DiffRenderer did not recover the albedo, or K8 did not launch once a step")
    summary["diff_megakernel"]["launches"] = launched["diff_megakernel"]

    # make_train_step under NEE: SGD on the albedo against the NEE frame
    nee = settings_for("NEE_MIS")
    target = radiance_nee_mis(scene, pick_tracer(scene), o, d, pix, 1, nee)
    step = make_train_step(scene, cam.width, cam.height, nee, lr=30.0, technique="nee", device="cuda",
                           fields=("albedo",))
    params = dataclasses.replace(scene.materials, albedo=start)
    reset_launches()
    losses = []
    for _ in range(5):
        params, loss = step(params, cam.inv_projection, cam.inv_view, 1, target)
        losses.append(loss)
    torch.cuda.synchronize()
    launched = launch_counts()
    losses = [x.item() for x in losses]
    err1 = (params.albedo - true_alb).abs().mean().item()
    ok = bool(losses[-1] < losses[0] and launched["trace_closest"] > 0 and all(map(math.isfinite, losses)))
    emit("main_path", path="make_train_step cornell NEE_MIS", size=f"{cam.width}x{cam.height}", steps=5,
         launches=launched, albedo_mae_start=err0, albedo_mae_end=err1, losses=losses, ok=ok)
    if not ok:
        raise AssertionError("make_train_step's loss did not fall, or K1 did not launch")


# phase 6c: the multi-device layer (parallel/) and K2's pixel-slab entry
PAR_SIZE = 256        # Cornell's ReSTIR, cosine and NEE-training frames
PAR_HD = (1920, 1088)
PAR_HD_FRAMES = 64
PAR_DI_TRAIN = 128
PAR_SLABS = 256      # the slab checks' square frames (stress, textured, every sampler)


def slab_starts(n_pix: int, n_slabs: int) -> list:
    """Boundaries of ``n_slabs`` slabs of ceil(n_pix / n_slabs) pixels, the
    last one ragged."""
    per = -(-n_pix // n_slabs)
    return list(range(0, n_pix, per)) + [n_pix]


def k2_slabs(summary: dict) -> None:
    """K2's pixel-slab entry against its one launch, bit for bit: NEE with 1
    and 4 lanes at Cornell 1920x1088 (8 frames), NEE on the stress scene at
    256², the textured Cornell box at 256² (NEE) and every other sampler at
    Cornell 256² (8 frames), each cut into 2, 3 and 7 slabs, the last one
    ragged."""
    import copy

    import torch

    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render import megakernel as mk
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    builder, cam_hd = cornell_box(*PAR_HD)
    scene_hd = builder.compile().to("cuda")
    builder, cam_c = cornell_box(PAR_SLABS, PAR_SLABS)
    scene_c = builder.compile().to("cuda")
    scene_s, cam_s = stress_scene(128, 128)       # the scene of phase 4, its camera at 256²
    cam_s = copy.deepcopy(cam_s)
    cam_s.resize(PAR_SLABS, PAR_SLABS)
    sq = f"{PAR_SLABS}x{PAR_SLABS}"
    cases = [("NEE_MIS", "cornell {}x{}".format(*PAR_HD), scene_hd, cam_hd, 1),
             ("NEE_MIS", "cornell {}x{}".format(*PAR_HD), scene_hd, cam_hd, 4),
             ("NEE_MIS", f"stress {sq}", scene_s, cam_s, None),
             ("NEE_MIS", f"textured cornell {sq}", *textured_scene(PAR_SLABS, PAR_SLABS), None)]
    cases += [(tech, f"cornell {sq}", scene_c, cam_c, None) for tech in K2_NAMES if tech != "NEE_MIS"]
    for tech, label, scene, cam, lanes in cases:
        st = settings_for(tech)
        whole = mk.megakernel(scene, cam, 1, 8, st, lanes=lanes)
        n = cam.width * cam.height
        differ = {}
        for k in (2, 3, 7):
            starts = slab_starts(n, k)
            joined = torch.cat([mk.megakernel(scene, cam, 1, 8, st, lanes=lanes, pix0=a, n_pix=b - a)
                                for a, b in zip(starts, starts[1:])])
            differ[k] = int((joined != whole).any(-1).sum())
        torch.cuda.synchronize()
        check_overflow(scene)
        ok = all(v == 0 for v in differ.values())
        emit("parallel", case="k2 slabs vs one launch", technique=tech, scene=label, frames=8,
             lanes=lanes or mk.k2_lanes(8), slabs=[2, 3, 7], last_slab=[n - slab_starts(n, k)[-2] for k in (2, 3, 7)],
             differing_pixels=differ, ok=ok)
        if not ok:
            raise AssertionError(f"K2's slabs do not join into its one launch: {tech} on {label}")
        row = summary.get(TEX_ROWS[tech] if label.startswith("textured") else K2_NAMES[tech])
        if row is not None:
            row.setdefault("slab_entry", []).append(f"{label}, {lanes or mk.k2_lanes(8)} lanes: 2/3/7 slabs "
                                                    "bit for bit the one launch")


@contextlib.contextmanager
def timed_collectives():
    """Host milliseconds in the port's collectives inside the block, each
    call fenced by ``torch.cuda.synchronize`` before and after: yields
    {"all_gather": [ms, ...], "all_reduce": [ms, ...]}."""
    from unittest import mock

    import torch

    from fypraytracer_tpu_torch.parallel import distributed, restir_shard, shard

    times: dict = {"all_gather": [], "all_reduce": []}

    def fenced(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    gather = fenced("all_gather", distributed.all_gather_shards)
    reduce = fenced("all_reduce", distributed.all_reduce_sum)
    with contextlib.ExitStack() as stack:
        for mod in (shard, restir_shard):
            stack.enter_context(mock.patch.object(mod, "all_gather_shards", gather))
            stack.enter_context(mock.patch.object(mod, "all_reduce_sum", reduce))
        yield times


def sharded_runs(timed: bool = False) -> dict:
    """Every sharded path on this process's shard of the default process
    group, on the card, the results gathered on the host: the fast path
    (NEE at 1920x1088, 64 frames), the cosine wavefront frame and the DI
    (static and moving camera, 3 frames) and GI (2 frames) wavefronts at
    Cornell 256² (radius 30), the NEE train step at 256² (2 SGD steps of the
    albedo) and the DI train step at 128² (``steps_per_call=2``, and as two
    calls of one step), the GI train step once; each case's launches; with
    ``timed``, the ms in the collectives a frame or step."""
    import dataclasses

    import torch

    from fypraytracer_tpu_torch.parallel import restir_shard, shard
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    mesh = shard.make_pixel_mesh(device="cuda")
    out: dict = {"launches": {}, "collective_ms": {}}

    def case(name, fn):
        reset_launches()
        with timed_collectives() as times:
            result = fn()
            torch.cuda.synchronize()
        out["launches"][name] = launch_counts()
        out["collective_ms"][name] = times
        out[name] = result

    builder, cam = cornell_box(*PAR_HD)
    scene = shard.replicate_scene(builder.compile(), mesh)
    render = shard.sharded_megakernel_render(scene, mesh, *PAR_HD, settings_for("NEE_MIS"), PAR_HD_FRAMES)
    case("megakernel", lambda: shard.gather_pixels(mesh, render(cam, 1)).cpu())

    builder, cam = cornell_box(PAR_SIZE, PAR_SIZE)
    scene = shard.replicate_scene(builder.compile(), mesh)
    cosine = shard.sharded_render(scene, mesh, PAR_SIZE, PAR_SIZE, settings_for("COSINE"))
    case("render", lambda: shard.gather_pixels(mesh, cosine(cam.inv_projection, cam.inv_view, 1)).cpu())

    def restir(make, tech, frames, move):
        step, init_state = make(scene, mesh, PAR_SIZE, PAR_SIZE, settings_for(tech))
        state, acc = init_state(), None
        for f, (c, ppv) in enumerate(camera_path(cam, frames, move)):
            hdr, state = step(c.inv_projection, c.inv_view, ppv, f + 1, state)
            acc = hdr if acc is None else acc + hdr
        return shard.gather_pixels(mesh, acc).cpu()

    case("di", lambda: restir(restir_shard.make_restir_di_sharded, "RESTIR_DI", 3, False))
    case("di_move", lambda: restir(restir_shard.make_restir_di_sharded, "RESTIR_DI", 3, True))
    case("gi", lambda: restir(restir_shard.make_restir_gi_sharded, "RESTIR_GI", 2, False))

    # the NEE train step's target: the cosine frame 2 of the true albedos
    nee, start = settings_for("NEE_MIS"), dataclasses.replace(scene.materials, albedo=scene.materials.albedo * 0.8)
    target = shard.gather_pixels(mesh, shard.sharded_render(scene, mesh, PAR_SIZE, PAR_SIZE, settings_for("COSINE"))(
        cam.inv_projection, cam.inv_view, 2))

    def nee_train():
        step = shard.make_train_step(scene, PAR_SIZE, PAR_SIZE, nee, lr=30.0, fields=("albedo",), mesh=mesh)
        params, losses = start, []
        for i in range(2):
            params, loss = step(params, cam.inv_projection, cam.inv_view, i + 1, target)
            losses.append(loss)
        return dict(losses=torch.stack(losses).cpu(), albedo=params.albedo.cpu())

    case("nee_train", nee_train)

    builder, cam_t = cornell_box(PAR_DI_TRAIN, PAR_DI_TRAIN)
    scene_t = shard.replicate_scene(builder.compile(), mesh)
    st_t = settings_for("RESTIR_DI")
    ip, iv, ppv = cam_t.inv_projection, cam_t.inv_view, cam_t.prev_proj_view

    def di_train():
        render_t, init_t = restir_shard.make_restir_di_sharded(scene_t, mesh, PAR_DI_TRAIN, PAR_DI_TRAIN, st_t)
        tgt, state = render_t(ip, iv, ppv, 1, init_t())
        tgt = shard.gather_pixels(mesh, tgt)
        params = dataclasses.replace(scene_t.materials, albedo=scene_t.materials.albedo * 0.8)
        res = {}
        for k in (2, 1):
            step, _ = restir_shard.make_restir_di_train_step(scene_t, mesh, PAR_DI_TRAIN, PAR_DI_TRAIN, st_t, lr=0.5,
                                                             fields=("albedo",), steps_per_call=k, clip01=("albedo",))
            p, losses = params, []
            for _ in range(2 // k):
                p, _, loss = step(p, ip, iv, ppv, 2, state, tgt)
                losses.append(loss.reshape(-1))
            res[k] = dict(losses=torch.cat(losses).cpu(), albedo=p.albedo.cpu())
        return res

    case("di_train", di_train)

    def gi_train():
        step, init_state = restir_shard.make_restir_gi_train_step(scene_t, mesh, PAR_DI_TRAIN, PAR_DI_TRAIN,
                                                                  settings_for("RESTIR_GI"), lr=0.5,
                                                                  fields=("albedo",))
        _, _, loss = step(scene_t.materials, ip, iv, ppv, 1, init_state(),
                          torch.zeros((PAR_DI_TRAIN ** 2, 3), device="cuda"))
        return loss.cpu()

    case("gi_train", gi_train)

    if timed:
        # the DI frame's halo exchanges and the NEE step's all_reduces, 5 reps
        step, init_state = restir_shard.make_restir_di_sharded(scene, mesh, PAR_SIZE, PAR_SIZE,
                                                               settings_for("RESTIR_DI"))
        state, halo_ms = init_state(), []
        for f in range(6):
            with timed_collectives() as times:
                _, state = step(cam.inv_projection, cam.inv_view, cam.prev_proj_view, f + 1, state)
            if f:
                halo_ms.append(sum(times["all_gather"]))
        step = shard.make_train_step(scene, PAR_SIZE, PAR_SIZE, nee, lr=30.0, fields=("albedo",), mesh=mesh)
        reduce_ms = []
        for i in range(6):
            with timed_collectives() as times:
                step(start, cam.inv_projection, cam.inv_view, 1, target)
            if i:
                reduce_ms.append(sum(times["all_reduce"]))
        out["timing"] = dict(halo_ms_per_frame=halo_ms, all_reduce_ms_per_step=reduce_ms)
    return out


def camera_path(cam, frames: int, move: bool):
    """(camera, prev proj @ view) of each frame: ``cam`` static, or panning
    up 0.05 a frame (tests/test_restir_shard.py's moving camera)."""
    from fypraytracer_tpu_torch.core.camera import Camera

    if not move:
        return [(cam, cam.prev_proj_view)] * frames
    poses = [Camera(position=(0.0, 1.0 + 0.05 * f, 2.6), forward=(0.0, 0.0, -1.0), vfov_deg=45.0,
                    width=cam.width, height=cam.height) for f in range(frames)]
    return [(p, poses[max(f - 1, 0)].proj_view) for f, p in enumerate(poses)]


def parallel_rank(rank: int, world: int, tmp: str) -> None:
    """One of ``world`` processes on the one card, joined by gloo over a
    FileStore (every collective staged through host memory): runs
    ``sharded_runs`` and rank 0 saves it."""
    import torch
    import torch.distributed as dist

    from fypraytracer_tpu_torch.parallel.distributed import init_distributed

    torch.cuda.set_device(0)
    init_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", world, rank, backend="gloo")
    try:
        out = sharded_runs(timed=True)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "rank0.pt"))
        dist.barrier()              # no rank leaves the group while another still talks to it
    finally:
        dist.destroy_process_group()


def phase_parallel(summary: dict) -> None:
    """The multi-device layer on one card: K2's slabs (``k2_slabs``); every
    sharded path at world size 1 under NCCL against its single-device entry
    point, bit for bit (``MegakernelRenderer``, the wavefront ``Renderer``
    frames, ``make_train_step`` without a mesh), with the counters reset
    before each path and read after; then world size 2 as two processes
    that share the card under gloo, every collective staged through host
    memory (NCCL refuses two ranks on one device), against world size 1:
    the fast path bit for bit, DI and GI under tests/test_restir_shard.py's
    gates with the share of bit-equal pixels, the train steps' losses
    within 1 ulp and parameters within 1e-6 relative.  Timings: the fast
    path at world size 1 against ``MegakernelRenderer.render_many(64)`` in
    turns at 1920x1088 and 256² (5 reps a turn), the halo exchange's ms a
    frame at world size 2 (gloo, host-staged: no NVLink figure) and the
    ``all_reduce`` ms a step of the NEE train step at world size 1 (NCCL)."""
    import copy
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from fypraytracer_tpu_torch.config import SamplingTechnique
    from fypraytracer_tpu_torch.parallel import shard
    from fypraytracer_tpu_torch.render import restir_di
    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer
    from fypraytracer_tpu_torch.render.renderer import Renderer, frame_hdr, render_step_stateful
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    t_phase = time.perf_counter()
    k2_slabs(summary)

    # ---- world size 1, NCCL
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", world_size=1,
                                rank=0)
        try:
            one = sharded_runs(timed=True)
            timing = parallel_timing()
        finally:
            dist.destroy_process_group()

    def single(make):
        """A single-device entry point's result, with its launches."""
        reset_launches()
        ref = make()
        torch.cuda.synchronize()
        return ref, launch_counts()

    needs = dict(megakernel=["megakernel"], render=["trace_closest"], di=["trace_closest"],
                 di_move=["trace_closest"], gi=["trace_closest"], nee_train=["trace_closest"],
                 di_train=["trace_closest"], gi_train=["trace_closest"])
    b256, c256 = cornell_box(PAR_SIZE, PAR_SIZE)
    host = b256.compile()

    def megakernel_renderer():
        builder, cam = cornell_box(*PAR_HD)
        r = MegakernelRenderer(builder.compile(), cam, settings_for("NEE_MIS"), device="cuda")
        r.render_many(PAR_HD_FRAMES)
        return r.accum.cpu()

    def renderer_sum(tech, frames):
        """``Renderer``'s accumulation of ``frames`` frames: their sum."""
        r = Renderer(host, copy.deepcopy(c256), settings_for(tech), device="cuda")
        r.render_many(frames)
        return r.accum.reshape(-1, 3).cpu()

    def moving_di():
        scene = host.to("cuda")
        state, acc = restir_di.init_state(PAR_SIZE ** 2, device="cuda"), None
        for f, (c, ppv) in enumerate(camera_path(c256, 3, True)):
            hdr, state = render_step_stateful(scene, c, ppv, f + 1, settings_for("RESTIR_DI"), state)
            acc = hdr if acc is None else acc + hdr
        return acc.reshape(-1, 3).cpu()

    def nee_train_one():
        scene = host.to("cuda")
        nee = settings_for("NEE_MIS")
        target = frame_hdr(scene, c256, 2, nee.replace(technique=SamplingTechnique.COSINE)).reshape(-1, 3)
        step = shard.make_train_step(scene, PAR_SIZE, PAR_SIZE, nee, lr=30.0, fields=("albedo",), device="cuda")
        params = dataclasses.replace(scene.materials, albedo=scene.materials.albedo * 0.8)
        losses = []
        for i in range(2):
            params, loss = step(params, c256.inv_projection, c256.inv_view, i + 1, target)
            losses.append(loss)
        return dict(losses=torch.stack(losses).cpu(), albedo=params.albedo.cpu())

    checks = {"megakernel": single(megakernel_renderer), "render": single(lambda: renderer_sum("COSINE", 1)),
              "di": single(lambda: renderer_sum("RESTIR_DI", 3)), "di_move": single(moving_di),
              "gi": single(lambda: renderer_sum("RESTIR_GI", 2)), "nee_train": single(nee_train_one)}
    for name, (ref, launched_ref) in checks.items():
        got = one[name]
        if name == "nee_train":
            equal = torch.equal(got["losses"], ref["losses"]) and torch.equal(got["albedo"], ref["albedo"])
            share = None
        else:
            equal = torch.equal(got, ref.reshape(got.shape))
            share = float((got == ref.reshape(got.shape)).all(-1).float().mean())
        launched = one["launches"][name]
        ok = bool(equal and all(launched[k] > 0 for k in needs[name]))
        emit("parallel", case=f"world 1 (nccl) {name} vs single device", bit_equal=equal, bit_equal_share=share,
             launches=nonzero(launched), single_device_launches=nonzero(launched_ref), ok=ok)
        if not ok:
            raise AssertionError(f"sharded {name} at world size 1 is not the single-device result bit for bit")
    dt = one["di_train"]
    ok = bool(torch.equal(dt[2]["losses"], dt[1]["losses"]) and torch.equal(dt[2]["albedo"], dt[1]["albedo"])
              and torch.isfinite(dt[2]["losses"]).all() and bool(torch.isfinite(one["gi_train"]).all())
              and all(one["launches"][k]["trace_closest"] > 0 for k in ("di_train", "gi_train")))
    emit("parallel", case="world 1 (nccl) DI train step steps_per_call=2 vs two calls",
         losses=dt[2]["losses"].tolist(), gi_train_loss=float(one["gi_train"]), ok=ok)
    if not ok:
        raise AssertionError("the DI train step's micro-steps differ from its per-step loop")
    emit("parallel", case="world 1 (nccl) all_reduce of the NEE train step", backend="nccl",
         all_reduce_ms_per_step=one["timing"]["all_reduce_ms_per_step"],
         median=statistics.median(one["timing"]["all_reduce_ms_per_step"]), ok=True)
    emit("parallel", case="sharded_megakernel_render (world 1, nccl) vs MegakernelRenderer.render_many(64)",
         backend="nccl", **timing, ok=True)

    # ---- world size 2: two processes on the one card, gloo through the host
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(parallel_rank, args=(2, tmp), nprocs=2, start_method="spawn", join=True)
        two = torch.load(os.path.join(tmp, "rank0.pt"))
        spawn_s = time.perf_counter() - t0
    rows = []
    for name in ("megakernel", "render", "di", "di_move", "gi"):
        got, ref = two[name], one[name]
        share = float((got == ref).all(-1).float().mean())
        row = parity(got.numpy(), ref.numpy()) if name in ("di", "di_move", "gi") else {}
        if name in ("di", "di_move", "gi"):
            # tests/test_restir_shard.py:173-178
            diff = np.abs(got.numpy().astype(np.float64) - ref.numpy())
            ok = bool(np.median(diff) < 1e-6 and (diff.max(-1) > 1e-3).mean() < 0.03
                      and abs(got.mean() - ref.mean()) / ref.mean() < (0.01 if name != "gi" else 0.02))
        else:
            ok = torch.equal(got, ref)
        rows.append(ok)
        emit("parallel", case=f"world 2 (gloo, host-staged) {name} vs world 1", bit_equal_share=share,
             launches=nonzero(two["launches"][name]), **{k: v for k, v in row.items() if k != "ok"}, ok=ok)
    for name in ("nee_train",):
        got, ref = two[name], one[name]
        ulp = np.abs(got["losses"].numpy() - ref["losses"].numpy()) / np.spacing(np.abs(ref["losses"].numpy()))
        rel = float(((got["albedo"] - ref["albedo"]).abs() / ref["albedo"].abs().clamp_min(1e-12)).max())
        ok = bool(ulp.max() <= 1.0 and rel <= 1e-6)
        rows.append(ok)
        emit("parallel", case=f"world 2 (gloo, host-staged) {name} vs world 1", loss_ulps=ulp.tolist(),
             albedo_max_rel=rel, ok=ok)
    for k in (2, 1):
        got, ref = two["di_train"][k], one["di_train"][k]
        ulp = np.abs(got["losses"].numpy() - ref["losses"].numpy()) / np.spacing(np.abs(ref["losses"].numpy()))
        rel = float(((got["albedo"] - ref["albedo"]).abs() / ref["albedo"].abs().clamp_min(1e-12)).max())
        ok = bool(ulp.max() <= 1.0 and rel <= 1e-6)
        rows.append(ok)
        emit("parallel", case=f"world 2 (gloo, host-staged) di_train steps_per_call={k} vs world 1",
             loss_ulps=ulp.tolist(), albedo_max_rel=rel, ok=ok)
    halo = two["timing"]["halo_ms_per_frame"]
    emit("parallel", case=f"world 2 halo exchange of a DI frame at {PAR_SIZE}x{PAR_SIZE}",
         backend="gloo, staged through host memory",
         halo_ms_per_frame=halo, median=statistics.median(halo), spawn_and_run_seconds=spawn_s,
         note="two processes on one card: no NVLink figure", ok=True)
    emit("parallel", case="phase", seconds=time.perf_counter() - t_phase, ok=all(rows))
    if not all(rows):
        raise AssertionError("world size 2 disagrees with world size 1")


# phase 6d: the app layer (app/cli.py, app/interactive.py, scene/, utils/)
APP_SIZE = 256
APP_TECHNIQUES = ("brute", "uniform", "cosine", "ggx", "brdf", "light", "nee", "restir-di", "restir-gi")
# the K2 sampler each technique launches (csrc/megakernel.cu's Sampler; brute
# force is uniform at 1 sample) and K5's instantiation ids
_K2_SAMPLER = {"uniform": 0, "cosine": 1, "ggx": 2, "brdf": 3, "light": 4, "nee": 5}


@contextlib.contextmanager
def launch_log():
    """Record, for every launch inside the block, K2's sampler and
    technique and K5-K7's kernel id, by wrapping the modules' private
    ``_launch`` helpers (the wrappers' counts are theirs, untouched)."""
    from fypraytracer_tpu_torch.render import megakernel as mk
    from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg

    log = {"k2": [], "gi": []}
    k2, gi = mk._launch, mg._launch

    def k2_logged(prep, *rest):
        log["k2"].append((int(prep.settings.technique), prep.sampler))
        return k2(prep, *rest)

    def gi_logged(which, *rest):
        log["gi"].append(which)
        return gi(which, *rest)

    mk._launch, mg._launch = k2_logged, gi_logged
    try:
        yield log
    finally:
        mk._launch, mg._launch = k2, gi


def run_cli(argv) -> list:
    """``cli.main(argv + ["--device", "cuda"])`` in this process; returns
    its JSON lines (each also printed)."""
    import io

    from fypraytracer_tpu_torch.app import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([*argv, "--device", "cuda"])
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.strip()]
    for line in lines:
        print(json.dumps({"cli": argv[0], **line}), flush=True)
    return lines


def phase_app() -> None:
    """The app layer driven in process, each call with the kernels' launch
    counters reset just before and read just after: `cli render` (K2 NEE,
    the image scored against cornell_nee.png), `cli benchmark` of the nine
    techniques at equal frames against 256 frames of NEE (every row on the
    megakernel path; every K2 sampler, K3, K4 and K5 launched; then
    `--gi-fast`: K5's final_vis instantiation), `cli train` through K8 and
    through the K1 wavefront, a checkpointed ReSTIR GI render stopped and
    resumed against an uninterrupted one (bit for bit), an interactive
    script (K1, edits through SceneManager), and the stress scene built by
    the native and the NumPy builders (host seconds; NEE images scored
    against stress_nee.png)."""
    import io
    import tempfile

    import torch

    from fypraytracer_tpu_torch.app.interactive import InteractiveSession
    from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg
    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer, morton_permuted_scene
    from fypraytracer_tpu_torch.scene.sceneio import builtin_scene
    from fypraytracer_tpu_torch.utils.image import load_png

    t_phase = time.perf_counter()
    size = ["--width", str(APP_SIZE), "--height", str(APP_SIZE)]
    failures = []

    def check(case, ok, **row):
        emit("app", case=case, **row, ok=bool(ok))
        if not ok:
            failures.append(case)

    def called(argv):
        """The CLI's JSON lines, the launches counted and the launch log."""
        reset_launches()
        with launch_log() as log:
            lines = run_cli(argv)
            torch.cuda.synchronize()
        return lines, nonzero(launch_counts()), log

    with tempfile.TemporaryDirectory() as tmp:
        # render: K2 NEE, the saved image against the golden
        out = os.path.join(tmp, "render")
        lines, launched, log = called(["render", "--scene", "cornell", "--technique", "nee", "--impl", "megakernel",
                                       "--frames", "8", *size, "-o", out])
        png = [f for f in os.listdir(out) if f.endswith(".png")][0]
        row = score_rgb8(load_png(os.path.join(out, png)), "cornell_nee.png", (APP_SIZE, APP_SIZE, 3))
        res = lines[-1]
        check("render cornell nee megakernel 8 frames", row["ok"] and res["impl"] == "megakernel"
              and res["frames"] == 8 and (6, _K2_SAMPLER["nee"]) in log["k2"], launches=launched, result=res,
              **{k: v for k, v in row.items() if k != "ok"})

        # benchmark: the nine techniques, equal frames, against 256 frames of NEE
        out = os.path.join(tmp, "bench")
        lines, launched, log = called(["benchmark", "--scene", "cornell", *size, "--techniques",
                                       ",".join(APP_TECHNIQUES), "--frames", "64", "--golden-frames", "256",
                                       "-o", out])
        rows = [r for r in lines if "technique" in r]
        samplers = {s for _, s in log["k2"]}
        techs = {t for t, _ in log["k2"]}
        ok = ([r["technique"] for r in rows] == list(APP_TECHNIQUES) and all(r["impl"] == "megakernel" for r in rows)
              and samplers == set(_K2_SAMPLER.values()) and techs == set(range(7))
              and all(launched.get(k, 0) > 0 for k in ("restir_di_k3", "restir_di_k4", "restir_gi_mono"))
              and set(log["gi"]) == {mg._K5} and all(math.isfinite(r["psnr"]) for r in rows))
        check("benchmark cornell nine techniques, 64 frames vs 256 of NEE", ok, rows=rows, launches=launched,
              k2_samplers=sorted(samplers), gi_kernels=sorted(set(log["gi"])))
        lines, launched, log = called(["benchmark", "--scene", "cornell", *size, "--techniques", "restir-gi",
                                       "--gi-fast", "--frames", "64", "--golden-frames", "256"])
        rows = [r for r in lines if "technique" in r]
        check("benchmark cornell restir-gi --gi-fast", rows[0]["impl"] == "megakernel"
              and set(log["gi"]) == {mg._K5_FINAL_VIS} and launched.get("restir_gi_mono", 0) > 0,
              rows=rows, launches=launched)

        # train: K8 (9 steps), then the K1 wavefront's NEE step (2 steps)
        lines, launched, _ = called(["train", "--scene", "cornell", *size, "--impl", "megakernel", "--steps", "9"])
        losses = [r["loss"] for r in lines if "loss" in r]
        check("train --impl megakernel 9 steps", len(losses) == 9 and losses[-1] < losses[0]
              and launched.get("diff_megakernel") == 9, losses=losses, result=lines[-1], launches=launched)
        lines, launched, _ = called(["train", "--scene", "cornell", *size, "--steps", "2"])
        losses = [r["loss"] for r in lines if "loss" in r]
        # a NEE frame against the cosine target: frame noise dominates a
        # step's loss, so two steps are held to finite values, not a fall
        check("train (NEE wavefront) 2 steps", len(losses) == 2 and all(map(math.isfinite, losses))
              and launched.get("trace_closest", 0) > 0, losses=losses, result=lines[-1], launches=launched)

        # a checkpointed ReSTIR GI render: 32 frames in checkpoints of 16,
        # stopped after the first and resumed, against an uninterrupted run
        base = ["render", "--scene", "cornell", "--technique", "restir-gi", *size, "--checkpoint-every", "16"]
        whole, part = os.path.join(tmp, "ck_whole"), os.path.join(tmp, "ck_part")
        lines_w, launched_w, _ = called([*base, "--frames", "32", "--checkpoint-dir", whole,
                                         "-o", os.path.join(tmp, "ckw")])
        called([*base, "--frames", "16", "--checkpoint-dir", part, "-o", os.path.join(tmp, "ckp1")])
        lines_p, launched_p, _ = called([*base, "--frames", "32", "--checkpoint-dir", part,
                                         "-o", os.path.join(tmp, "ckp2")])
        a, b = (torch.load(os.path.join(d, "state.pt"), weights_only=True) for d in (whole, part))
        equal = {k: bool(torch.equal(a[k], b[k])) for k in ("accum", "mk_state", "mk_stage", "frame_index")}
        check("render restir-gi checkpointed 16 + 16 resumed vs 32 uninterrupted", all(equal.values())
              and lines_p[1]["resumed"] and lines_p[1]["frames_done"] == 16 and lines_p[-1]["frames"] == 32
              and launched_w.get("restir_gi_mono") == 32 and launched_p.get("restir_gi_mono") == 16,
              bit_equal=equal, launches_uninterrupted=launched_w, launches_resumed=launched_p,
              impl=lines_p[-1]["impl"])

        # an interactive script: K1 traces, an edit of each kind, no refusal
        builder, cam = builtin_scene("cornell", APP_SIZE, APP_SIZE)
        out = io.StringIO()
        sess = InteractiveSession(builder, cam, out=out, device="cuda")
        reset_launches()
        sess.run(["step 4", "mat 3 albedo 0.2 0.9 0.2", "step 4", "add-sphere 0 0.3 0 0.3 0.2", "step 2",
                  f"save {os.path.join(tmp, 'session.png')}", "info", "quit"])
        torch.cuda.synchronize()
        launched = nonzero(launch_counts())
        rec = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
        steps = [r for r in rec if "frame_ms" in r]
        check("interactive script cornell NEE", not any("error" in r for r in rec) and len(steps) == 3
              and all(r["finite"] for r in steps) and os.path.exists(os.path.join(tmp, "session.png"))
              and launched.get("trace_closest", 0) > 0 and rec[-1]["scene_version"] == 2,
              records=rec, launches=launched)

    # the stress scene: the native and the NumPy builders, host seconds, and
    # each scene's NEE megakernel image against the golden (Morton order)
    for native in (True, False):
        builder, cam = builtin_scene("stress", 128, 128)
        t0 = time.perf_counter()
        host = builder.compile(native=native)
        build_s = time.perf_counter() - t0
        scene = morton_permuted_scene(host)[0]
        reset_launches()
        avg = MegakernelRenderer(scene, cam, settings_for("NEE_MIS"), device="cuda").render_many(8)
        torch.cuda.synchronize()
        launched = nonzero(launch_counts())
        row = score(avg, "stress_nee.png", (128, 128, 3))
        want = "native" if native else "numpy"
        check(f"stress build native={native}", row["ok"] and launched.get("megakernel") == 1
              and builder.last_builders == dict(bvh=want, light_tree=want),
              builders=builder.last_builders, host_build_seconds=build_s, launches=launched,
              **{k: v for k, v in row.items() if k != "ok"})
    emit("app", case="phase", seconds=time.perf_counter() - t_phase, failures=failures, ok=not failures)
    if failures:
        raise AssertionError(f"the app phase failed: {failures}")


def nonzero(launched: dict) -> dict:
    return {k: v for k, v in launched.items() if v}


def parallel_timing() -> dict:
    """``sharded_megakernel_render`` at world size 1 against
    ``MegakernelRenderer.render_many(64)``, in turns (renderer, sharded,
    sharded, renderer; 5 reps a turn, CUDA events), at 1920x1088 and 256²."""
    from fypraytracer_tpu_torch.parallel import shard
    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    out = {}
    for w, h in (PAR_HD, (PAR_SIZE, PAR_SIZE)):
        builder, cam = cornell_box(w, h)
        mesh = shard.make_pixel_mesh(device="cuda")
        scene = shard.replicate_scene(builder.compile(), mesh)
        st = settings_for("NEE_MIS")
        r = MegakernelRenderer(scene, cam, st, device="cuda")
        render = shard.sharded_megakernel_render(scene, mesh, w, h, st, PAR_HD_FRAMES)
        runs = {"MegakernelRenderer": lambda: r.render_many(PAR_HD_FRAMES), "sharded": lambda: render(cam, 1)}
        for fn in runs.values():
            fn()
        times: dict = {k: [] for k in runs}
        for k in ("MegakernelRenderer", "sharded", "sharded", "MegakernelRenderer"):
            times[k] += gpu_ms(runs[k], 5)
        out[f"{w}x{h}"] = {k: dict(ms=v, median=statistics.median(v)) for k, v in times.items()}
    return out


# the __global__ names of csrc/*.cu, to count the port's kernels in a trace
# (and K2's threaded walk, frames_threaded_kernel, which an older checkout
# still has under --ab)
PORT_KERNELS = ("trace_closest_kernel", "frames_kernel", "k3_candidates", "k4_shade", "gi_mono", "gi_stage1",
                "gi_stage2", "diff_kernel", "trace_lane_kernel", "segment_kernel", "frames_threaded_kernel")


def device_busy(fn, launches) -> dict:
    """The card's time in kernels during ``fn()`` by torch.profiler: its
    milliseconds, the number of kernels, the three that took most time, and
    how many launches of the port's kernels the trace holds beside how many
    the wrappers counted (``launches()``: their total).  The profiler runs
    ``fn`` twice and keeps the second step; the first is its warm-up, and
    50 ms of idle host before and after each step keep the kernels off the
    edges of the trace's window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    kept: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: kept.update(events=p.events())) as prof:
        for _ in range(2):
            time.sleep(0.05)
            before = launches()
            fn()
            torch.cuda.synchronize()
            launched = launches() - before
            time.sleep(0.05)
            prof.step()
    if "events" not in kept:
        raise RuntimeError("torch.profiler handed over no trace")
    # the card's events, less the profiler's own span of the step on the
    # card's timeline ("ProfilerStep*"), which is no kernel
    kernels = [e for e in kept["events"] if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.self_device_time_total / 1000.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    port = [e for e in kernels if any(k in e.name for k in PORT_KERNELS)]
    return dict(busy_ms=sum(by_name.values()), n_kernels=len(kernels),
                top=[[name[:60], ms] for name, ms in top], traced=len(port), launched=launched,
                port_ms=sum(e.self_device_time_total for e in port) / 1000.0)


def kernel_ms(fn, calls: int = 20, launches=None) -> float:
    """The kernel's own time on the card per launch: torch.profiler's self
    device time of the port's kernel launches during ``calls`` calls of
    ``fn`` (after the profiler's warm-up step), over their number.  Raises
    unless the trace holds every launch the wrappers counted (``launches()``,
    by default every wrapper's count), and at least ``calls``."""
    launches = launches or (lambda: sum(launch_counts().values()))
    # the profiler has been seen to drop launches from a trace (12 of 20, and
    # once all 5 of 5 long ones): the mean over the traced launches still
    # reads the kernel's time, and a trace with fewer than half is taken again
    for attempt in range(3):
        prof = device_busy(lambda: [fn() for _ in range(calls)], launches)
        if prof["traced"] != prof["launched"]:
            print(f"kernel_ms: the trace holds {prof['traced']} of the {prof['launched']} launches the wrappers "
                  f"counted (attempt {attempt + 1})", flush=True)
        if max(calls // 2, 1) <= prof["traced"] <= prof["launched"]:
            return prof["port_ms"] / prof["traced"]
    raise AssertionError(f"kernel_ms: the trace holds {prof['traced']} of the port's launches, "
                         f"the wrappers counted {prof['launched']} in {calls} calls")


def phase_timing() -> None:
    import torch

    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer, megakernel_plain
    from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
    from fypraytracer_tpu_torch.render.megakernel_restir_gi import MegakernelReSTIRGI
    from fypraytracer_tpu_torch.render.renderer import Renderer
    from fypraytracer_tpu_torch.scene.procedural import cornell_box
    from fypraytracer_tpu_torch.utils import metrics

    def plain_wavefront(scene, cam, settings, device):
        """The wavefront frames with every trace the plain PyTorch walk."""
        scene = scene.to(device)
        return lambda n: megakernel_plain(scene, cam, 1, n, settings)

    def render_many(cls, **kw):
        return lambda scene, cam, settings, device: cls(scene, cam, settings, device=device, **kw).render_many

    def rays(tech, w, h, st, final_vis=False):
        """Rays a frame as bench.py counts them (primary + bounce + shadow);
        ReSTIR GI adds its visibility rays."""
        if tech == "RESTIR_GI":
            return metrics.rays_per_frame(w, h, 1, st.bounces,
                                          visibility_rays=1 if final_vis else st.spatial_neighbors)
        if tech == "NEE_MIS":
            return metrics.rays_per_frame(w, h, st.samples, st.bounces, shadow_rays_per_bounce=1)
        if tech == "LIGHT_SOURCE":
            return metrics.rays_per_frame(w, h, st.samples, 1)
        if tech == "RESTIR_DI":
            return metrics.rays_per_frame(w, h, 1, 1)
        return metrics.rays_per_frame(w, h, 1 if tech == "BRUTE_FORCE" else st.samples, st.bounces)

    def cornell(w, h):
        builder, cam = cornell_box(w, h)
        return builder.compile(), cam

    # (path, render_many(n) maker, technique, scene maker, width, height,
    # frames per rep, frames of the profiled dispatch; 0: not profiled).  The
    # plain wavefront takes 1-2 s a frame on the host, so it and the K1
    # wavefront under ReSTIR DI are timed over 8 frames a rep to keep the
    # script well inside its time limit.  The profiler slows the host several
    # times over, so its wall time is not used: the idle share is
    # 1 - (device busy per frame) / (CUDA-event ms per frame of the timed reps).
    k1, k2, di = render_many(Renderer), render_many(MegakernelRenderer), render_many(MegakernelReSTIRDI)
    cases = [("k1_wavefront", k1, "NEE_MIS", cornell, 256, 256, 64, 4),
             ("k2_megakernel", k2, "NEE_MIS", cornell, 256, 256, 64, 64),
             ("plain_wavefront", plain_wavefront, "NEE_MIS", cornell, 256, 256, 8, 0),
             ("k1_wavefront", k1, "NEE_MIS", cornell, 1920, 1088, 64, 2),
             ("k2_megakernel", k2, "NEE_MIS", cornell, 1920, 1088, 64, 64)]
    cases += [("k2_megakernel", k2, tech, cornell, 256, 256, 64, 0)
              for tech in ("BRUTE_FORCE", "UNIFORM", "COSINE", "GGX", "BRDF", "LIGHT_SOURCE")]
    cases += [("k3k4_megakernel_di", di, "RESTIR_DI", cornell, 256, 256, 64, 16),
              ("k3k4_megakernel_di", di, "RESTIR_DI", cornell, 1920, 1088, 64, 4),
              ("k1_wavefront", k1, "RESTIR_DI", cornell, 256, 256, 8, 2),
              ("k2_megakernel", k2, "NEE_MIS", stress_scene, 128, 128, 64, 0),
              ("k3k4_megakernel_di", di, "RESTIR_DI", stress_scene, 128, 128, 64, 0)]
    gi, gi_fv = render_many(MegakernelReSTIRGI), render_many(MegakernelReSTIRGI, final_vis=True)
    cases += [("k5_megakernel_gi", gi, "RESTIR_GI", cornell, 256, 256, 64, 16),
              ("k5_megakernel_gi_final_vis", gi_fv, "RESTIR_GI", cornell, 256, 256, 64, 16),
              ("k5_megakernel_gi", gi, "RESTIR_GI", cornell, 1920, 1088, 64, 8),
              ("k5_megakernel_gi_final_vis", gi_fv, "RESTIR_GI", cornell, 1920, 1088, 64, 8),
              ("k6k7_megakernel_gi", render_many(MegakernelReSTIRGI, mono=False), "RESTIR_GI", cornell, 256, 256,
               64, 16),
              ("k5_megakernel_gi", gi, "RESTIR_GI", stress_scene, 128, 128, 64, 8),
              ("k1_wavefront", k1, "RESTIR_GI", cornell, 256, 256, 8, 2)]
    # the textured Cornell box (ops/texture.py), beside the untextured rows above
    cases += [(f"{path}_textured", make, tech, textured_host, w, h, 64, 0)
              for path, make, tech in (("k2_megakernel", k2, "NEE_MIS"), ("k3k4_megakernel_di", di, "RESTIR_DI"),
                                       ("k5_megakernel_gi", gi, "RESTIR_GI"))
              for w, h in ((256, 256), (1920, 1088))]
    scene_names = {stress_scene: "stress", textured_host: "textured cornell"}
    for name, make, tech, scene_of, w, h, frames, prof_frames in cases:
        st = settings_for(tech)
        scene, cam = scene_of(w, h)
        run = make(scene, cam, st, "cuda")
        run(2)                                     # warm-up dispatch
        torch.cuda.synchronize()
        reps = gpu_ms(lambda: run(frames), 5)
        ms_frame = statistics.median(reps) / frames
        row = dict(path=name, technique=tech, scene=scene_names.get(scene_of, "cornell"),
                   size=f"{w}x{h}", frames_per_rep=frames, reps_ms=reps, ms_per_frame=ms_frame,
                   rays_per_s=rays(tech, w, h, st, name.endswith("final_vis")) / (ms_frame / 1000.0))
        if prof_frames:
            prof = device_busy(lambda: run(prof_frames), lambda: sum(launch_counts().values()))
            # a trace that lacks some of the port's launches, or holds no
            # kernel, is "not measured" (null), not an idle card
            seen = prof["traced"] == prof["launched"] and prof["n_kernels"] > 0
            busy = prof["busy_ms"] / prof_frames
            row.update(profiled_frames=prof_frames, port_launches=prof["launched"],
                       port_kernels_traced=prof["traced"],
                       device_busy_ms_per_frame=busy if seen else None,
                       idle_share=1.0 - busy / ms_frame if seen else None,
                       kernels_per_frame=prof["n_kernels"] / prof_frames if seen else None,
                       top_kernels_ms=prof["top"])
        emit("timing", **row)
        del run
        torch.cuda.empty_cache()

    phase_timing_overflow_watch()
    phase_timing_train()


class _NoWatch:
    """An overflow watch that reads nothing: the A/B's other side."""

    def poll(self) -> None:
        pass

    def queue(self) -> None:
        pass


def phase_timing_overflow_watch() -> None:
    """The cost of the entry points' stack-overflow watch
    (ops/traverse.py::OverflowWatch: a copy of the flag to pinned memory and
    an event a call, read at the next call without a wait): the
    ``MegakernelRenderer`` NEE ``render_many(64)`` at Cornell 256² with the
    watch and without it, in turns (with, without, without, with), 5 reps
    each, by CUDA events."""
    import torch

    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    builder, cam = cornell_box(256, 256)
    mk = MegakernelRenderer(builder.compile(), cam, settings_for("NEE_MIS"), device="cuda")
    watch = mk.overflow
    times: dict = {"watch": [], "no_watch": []}
    for variant in ("watch", "no_watch", "no_watch", "watch"):
        mk.overflow = watch if variant == "watch" else _NoWatch()
        mk.render_many(2)                          # warm-up
        torch.cuda.synchronize()
        times[variant] += gpu_ms(lambda: mk.render_many(64), 5)
    mk.overflow = watch
    med = {k: statistics.median(v) / 64 for k, v in times.items()}
    spread = {k: (max(v) - min(v)) / 64 for k, v in times.items()}
    emit("timing_overflow_watch", path="MegakernelRenderer NEE_MIS", size="256x256", frames_per_rep=64,
         reps_ms=times, ms_per_frame=med, spread_ms_per_frame=spread,
         watch_minus_no_watch_ms_per_frame=med["watch"] - med["no_watch"])


def train_steps(scene, cam, technique: str, settings):
    """``run(n)``: ``n`` steps of ``make_train_step`` under ``technique``
    (``"nee"`` or a hemisphere sampler) on ``scene`` (on the card), each
    from the scene's own materials, against that wavefront's frame 1."""
    import torch

    from fypraytracer_tpu_torch.core.camera import generate_rays
    from fypraytracer_tpu_torch.ops.traverse import pick_tracer
    from fypraytracer_tpu_torch.parallel.shard import make_train_step
    from fypraytracer_tpu_torch.render.integrators import radiance_hemisphere, radiance_nee_mis

    w, h = cam.width, cam.height
    o, d = generate_rays(cam.inv_projection, cam.inv_view, w, h, device="cuda")
    pix = torch.arange(w * h, device="cuda")
    target = (radiance_nee_mis(scene, pick_tracer(scene), o, d, pix, 1, settings) if technique == "nee" else
              radiance_hemisphere(scene, pick_tracer(scene), o, d, pix, 1, settings, technique))
    step = make_train_step(scene, w, h, settings, technique=technique, device="cuda")

    def run(n):
        for _ in range(n):
            step(scene.materials, cam.inv_projection, cam.inv_view, 1, target)
    return run


def phase_timing_train() -> None:
    """Training at Cornell 256²: ``DiffRenderer.step`` (5 reps of 10 steps),
    K8 per launch beside its plain version (the 5c numbers) with its busy
    time over 10 launches, and ``make_train_step`` under NEE and cosine (5
    reps of 2 steps, each from the same parameters); each with the card's
    busy time per step from torch.profiler and the idle share it implies."""
    import torch

    from fypraytracer_tpu_torch.render import megakernel_diff as md

    scene, cam, cam_t, tgt = diff_inputs()
    w, h = cam.width, cam.height
    alb = scene.materials.albedo
    dr = md.DiffRenderer(scene, cam, bounces=2, sky_color=SKY, device="cuda")

    def diff_steps(n):
        a = alb
        for _ in range(n):
            a, _ = dr.step(a, tgt, 3, lr=0.1)

    def kernel_launches(n):
        for _ in range(n):
            md.diff_megakernel(scene, cam, alb, tgt, 3, 2, SKY, cam=cam_t)

    cases = [("DiffRenderer.step", diff_steps, 10), ("diff_megakernel launch", kernel_launches, 10),
             ("make_train_step NEE_MIS", train_steps(scene, cam, "nee", settings_for("NEE_MIS")), 2),
             ("make_train_step COSINE", train_steps(scene, cam, "cosine", settings_for("COSINE")), 2)]
    for name, run, n in cases:
        run(1)                                       # warm-up
        torch.cuda.synchronize()
        reps = gpu_ms(lambda: run(n), 5)
        ms = statistics.median(reps) / n
        prof = device_busy(lambda: run(n), lambda: sum(launch_counts().values()))
        seen = prof["traced"] == prof["launched"] and prof["n_kernels"] > 0
        busy = prof["busy_ms"] / n
        emit("timing", path=name, size=f"{w}x{h}", steps_per_rep=n, reps_ms=reps, ms_per_step=ms,
             port_launches=prof["launched"], port_kernels_traced=prof["traced"],
             device_busy_ms_per_step=busy if seen else None, idle_share=1.0 - busy / ms if seen else None,
             kernels_per_step=prof["n_kernels"] / n if seen else None, top_kernels_ms=prof["top"])


# K2's launches that ab_turn times in each tree: (technique, scene, width,
# height, frames, calls); NEE at Cornell 256² (8 and 64 frames), stress 128²
# and 1920x1088, every other sampler at Cornell 256² (brute force is
# uniform's kernel at one sample)
K2_AB = ([("NEE_MIS", "cornell", 256, 256, 8, 20), ("NEE_MIS", "cornell", 256, 256, 64, 10),
          ("NEE_MIS", "stress", 128, 128, 8, 20), ("NEE_MIS", "cornell", 1920, 1088, 8, 5)]
         + [(tech, "cornell", 256, 256, 8, 20) for tech in ("UNIFORM", "COSINE", "GGX", "BRDF", "LIGHT_SOURCE")])


def k2_by_shape() -> dict:
    """K2's device ms a launch of the whole image (the lanes ``k2_lanes``
    picks) at each of ``K2_AB``, as ``ab_turn`` times it in each tree
    (``kernel_ms``); in a tree that still has K2's threaded walk
    (``megakernel_threaded``, since removed), that kernel too under NEE at
    1920x1088, 8 frames."""
    from fypraytracer_tpu_torch.render import megakernel as mk
    from fypraytracer_tpu_torch.render.megakernel import megakernel
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    out = {}
    if hasattr(mk, "megakernel_threaded"):
        builder, cam = cornell_box(1920, 1088)
        scene, st = builder.compile().to("cuda"), settings_for("NEE_MIS")
        mk.megakernel_threaded(scene, cam, 1, 8, st)        # warm-up
        out["NEE_MIS threaded cornell 1920x1088 8 frames"] = kernel_ms(
            lambda: mk.megakernel_threaded(scene, cam, 1, 8, st), 5,
            launches=lambda: mk.megakernel_threaded.launches)
    for tech, name, w, h, frames, calls in K2_AB:
        if name == "stress":
            scene, cam = stress_scene(w, h)
        else:
            builder, cam = cornell_box(w, h)
            scene = builder.compile().to("cuda")
        st = settings_for(tech)
        megakernel(scene, cam, 1, frames, st)               # warm-up
        out[f"{tech} {name} {w}x{h} {frames} frames"] = kernel_ms(lambda: megakernel(scene, cam, 1, frames, st),
                                                                   calls)
    return dict(ms_by_shape=out)


def restir_bits() -> dict:
    """Digests (sha256, 16 hex digits) of the ReSTIR kernels' outputs at
    ``SHAPES``, the camera static and moved 0.05 to the side before frame 3
    (after two frames of the kernels' own loops): K3's stage, K4's state
    and accum, K6's stage, K7's state and accum, K5's stage, state and
    accum in both visibility modes; of the DI and GI entry points' images
    after 8 frames (GI mono, ``final_vis`` and ``mono=False``); and of K5's
    (both modes) and K6's outputs on the textured Cornell box at 256².
    ``ab`` compares them between checkouts, bit for bit; it uses only what
    the ReSTIR modules had before K4, K6 and K7 moved to the wide BVH."""
    import copy
    import hashlib

    import numpy as np
    import torch

    from fypraytracer_tpu_torch.render import megakernel_restir as mr
    from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg
    from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    di, gi = settings_for("RESTIR_DI"), settings_for("RESTIR_GI")
    out = {}
    for name, w, h in SHAPES:
        if name == "stress":
            scene, cam0 = stress_scene(w, h)
        else:
            builder, cam0 = cornell_box(w, h)
            scene = morton_permuted_scene(builder.compile())[0].to("cuda")
        B = w * h
        em = mr.prepare_emissive_table(scene)
        for move in (False, True):
            cam = copy.deepcopy(cam0)
            tag = f"{name} {w}x{h} {'moved' if move else 'static'}"
            state = torch.zeros((mr.ST_ROWS, B), device="cuda")
            mr.restir_di_megakernel(scene, em, cam, state, 1, 2, di, cam.proj_view, cam.proj_view)
            z = (torch.zeros((mg.GT_ROWS, B), device="cuda"), torch.zeros((mg.GS_ROWS, B), device="cuda"))
            _, gstate, _ = mg.restir_gi_megakernel(scene, cam, *z, 1, 2, gi, cam.proj_view, cam.proj_view,
                                                   mono=False)
            _, mstate, mstage = mg.restir_gi_megakernel(scene, cam, *z, 1, 2, gi, cam.proj_view, cam.proj_view)
            ppv = cam.proj_view
            if move:
                cam.move_to(cam.position + np.float32([0.05, 0.0, 0.0]))
            stage = mr.restir_di_k3(scene, em, cam, 3, di, state, ppv)
            acc, st_out = torch.zeros((B, 3), device="cuda"), state.clone()
            mr.restir_di_k4(scene, em, cam, 3, di, stage, st_out, acc)
            out[f"K3 stage {tag}"] = digest(stage)
            out[f"K4 state+accum {tag}"] = digest(st_out, acc)
            gstage = mg.restir_gi_k1(scene, cam, 3, gi, gstate, ppv)
            out[f"K6 stage {tag}"] = digest(gstage)
            gacc, gst = torch.zeros((B, 3), device="cuda"), gstate.clone()
            mg.restir_gi_k2(scene, cam, 3, gi, gstage, gst, gacc)
            out[f"K7 state+accum {tag}"] = digest(gst, gacc)
            out.update(k5_bits(scene, cam, gi, mstate, mstage, ppv, tag))
        for cls, st, mode in ((mr.MegakernelReSTIRDI, di, {}), (mg.MegakernelReSTIRGI, gi, dict(mono=False)),
                              (mg.MegakernelReSTIRGI, gi, {"mono": True}),
                              (mg.MegakernelReSTIRGI, gi, {"final_vis": True})):
            r = cls(scene, copy.deepcopy(cam0), st, device="cuda", **mode)
            label = "".join(f" {k}={v}" for k, v in mode.items())
            out[f"{cls.__name__}{label} {name} {w}x{h} 8 frames"] = digest(r.render_many(8))
    scene, cam = textured_scene(256, 256)
    B = 256 * 256
    z = (torch.zeros((mg.GT_ROWS, B), device="cuda"), torch.zeros((mg.GS_ROWS, B), device="cuda"))
    _, mstate, mstage = mg.restir_gi_megakernel(scene, cam, *z, 1, 2, gi, cam.proj_view, cam.proj_view)
    _, gstate, _ = mg.restir_gi_megakernel(scene, cam, *z, 1, 2, gi, cam.proj_view, cam.proj_view, mono=False)
    out["K6 stage textured cornell 256x256 static"] = digest(mg.restir_gi_k1(scene, cam, 3, gi, gstate,
                                                                                cam.proj_view))
    out.update(k5_bits(scene, cam, gi, mstate, mstage, cam.proj_view, "textured cornell 256x256 static"))
    torch.cuda.synchronize()
    return out


def k5_bits(scene, cam, st, state, stage, ppv, tag: str) -> dict:
    """``restir_bits``'s digests of one K5 launch in each visibility mode
    (frame 3 from the given previous state and stage): its stage, and its
    state with the accum."""
    import hashlib

    import torch

    from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg

    out = {}
    B = cam.width * cam.height
    for fv in (False, True):
        acc, s_, g_ = torch.zeros((B, 3), device="cuda"), torch.empty_like(state), torch.empty_like(stage)
        mg.restir_gi_mono(scene, cam, 3, st, state, stage, ppv, acc, s_, g_, final_vis=fv)
        mode = " final_vis" if fv else ""
        for label, ts in ((f"K5{mode} stage", (g_,)), (f"K5{mode} state+accum", (s_, acc))):
            h = hashlib.sha256()
            for t in ts:
                h.update(t.contiguous().cpu().numpy().tobytes())
            out[f"{label} {tag}"] = h.hexdigest()[:16]
    return out


def ab_turn(tree: str) -> None:
    """One turn of ``--ab``, in a process of its own: the untextured entry
    points of the package in ``tree`` (its kernels built there) at Cornell
    256² and 1920x1088: ``Renderer`` NEE (``render_many(8)``),
    ``MegakernelRenderer`` NEE, ``MegakernelReSTIRDI`` and
    ``MegakernelReSTIRGI`` (mono and ``mono=False``; ``render_many(64)``),
    DI and GI also on the stress scene at 128²; ``make_train_step`` under
    NEE and cosine at 256² (2 steps a rep) and ``DiffRenderer.step`` (10
    steps a rep); each 5 reps after a warm-up.
    Before them, K2 NEE a launch of the whole image (``k2_by_shape``),
    K3-K7 (K5 in both visibility modes) a launch at ``SHAPES``
    (``by_shape``; K3's two launches at ``SHAPES`` and ``BETWEEN``, K5's
    and K6's at ``SHAPES`` and, in this checkout only, at ``BETWEEN``),
    K5's and K6's ``gi_attribution`` where the tree's restir_gi.cu has the
    section clocks, K7's ``k7_attribution`` where its K7 has them, and K8 a
    launch at ``SHAPES`` with its loss and d_tri at Cornell 256²
    (``k8_by_shape``), with the registers and spills of that tree's K2 NEE
    and K3-K8 from its nvcc report, their occupancy where the tree reports
    it, and the digests of its ReSTIR outputs (``restir_bits``).  Each step is named on stderr as it starts.  Prints
    one ``AB`` line with, per path and rep, the ms a frame (a step) by CUDA
    events and the host's ms a frame to enqueue the call (wall clock up to
    its return, before the synchronize): where the two are close the path
    waits on the host."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import fypraytracer_tpu_torch
    from fypraytracer_tpu_torch.ops import kernels
    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer
    from fypraytracer_tpu_torch.render.megakernel_diff import DiffRenderer
    from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
    from fypraytracer_tpu_torch.render.megakernel_restir_gi import MegakernelReSTIRGI
    from fypraytracer_tpu_torch.render.renderer import Renderer
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    if not os.path.abspath(fypraytracer_tpu_torch.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {fypraytracer_tpu_torch.__file__}, not the package in {tree}")
    own = os.path.abspath(tree) == REPO

    def reps(fn, n):
        dev, host = [], []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn(n)
            t1 = time.perf_counter()
            end.record()
            torch.cuda.synchronize()
            dev.append(start.elapsed_time(end) / n)
            host.append((t1 - t0) * 1000.0 / n)
        return dict(ms=dev, host_ms=host)

    def progress(what):
        print(f"ab_turn {os.path.basename(tree)}: {what}", file=sys.stderr, flush=True)

    progress("ReSTIR outputs' digests")
    bits = restir_bits()
    progress("K2 and K3-K8 by shape")
    di, gi = settings_for("RESTIR_DI"), settings_for("RESTIR_GI")
    k2 = k2_by_shape()
    with open(os.path.join(tree, "fypraytracer_tpu_torch", "csrc", "megakernel.cu")) as f:
        if K2_CLOCKS[2:] in f.read():                   # the tree's K2 has its section clocks
            progress("K2 attribution")
            k2["attribution"] = {k: v["shares"] for k, v in k2_attribution().items()}
    tile_designs = SHAPES + BETWEEN if own else SHAPES
    tile = {"k2": k2, "k3": by_shape("k3", di), "k4": by_shape("k4", di),
            "k5": by_shape("k5", gi, design_shapes=tile_designs), "k6": by_shape("k6", gi, design_shapes=tile_designs),
            "k7": by_shape("k7", gi), "k8": k8_by_shape(outputs=True)}
    gi_attr = None
    with open(os.path.join(tree, "fypraytracer_tpu_torch", "csrc", "restir_gi.cu")) as f:
        if GI_CLOCKS[2:] in f.read():                   # the tree's K5 and K6 have their section clocks
            progress("K5 and K6 attribution")
            gi_attr = {k: dict(shares=v["shares"], ms=v["ms"]) for k, v in gi_attribution().items()}
    with open(os.path.join(tree, "fypraytracer_tpu_torch", "csrc", "restir_gi.cu")) as f:
        if "fyp_restir_gi_k7_clocks" in f.read():       # the tree's K7 has its section clocks
            progress("K7 attribution")
            gi_attr = dict(gi_attr or {}, **{f"k7 {k}": dict(shares=v["shares"], ms=v["ms"], walks=v["walks"])
                                             for k, v in k7_attribution().items()})
    out = {}
    cornell_sizes = (("cornell", 256, 256), ("cornell", 1920, 1088))
    for cls, tech, frames, shapes, mode in ((Renderer, "NEE_MIS", 8, cornell_sizes, {}),
                                            (MegakernelRenderer, "NEE_MIS", 64, cornell_sizes, {}),
                                            (MegakernelReSTIRDI, "RESTIR_DI", 64, SHAPES, {}),
                                            (MegakernelReSTIRGI, "RESTIR_GI", 64, SHAPES, {}),
                                            (MegakernelReSTIRGI, "RESTIR_GI", 64, SHAPES, dict(mono=False))):
        for name, w, h in shapes:
            if name == "stress":
                scene, cam = stress_scene(w, h)
            else:
                builder, cam = cornell_box(w, h)
                scene = builder.compile()
            key = f"{cls.__name__} {tech} {'mono=False ' if mode else ''}{'' if name == 'cornell' else 'stress '}{w}x{h}"
            progress(key)
            r = cls(scene, cam, settings_for(tech), device="cuda", **mode)
            r.render_many(2)                       # warm-up
            torch.cuda.synchronize()
            out[key] = reps(r.render_many, frames)
            del r
            torch.cuda.empty_cache()
    scene, cam, _, tgt = diff_inputs()
    for technique, tech in (("nee", "NEE_MIS"), ("cosine", "COSINE")):
        progress(f"make_train_step {tech}")
        run = train_steps(scene, cam, technique, settings_for(tech))
        run(1)                                     # warm-up
        torch.cuda.synchronize()
        out[f"make_train_step {tech} 256x256"] = reps(run, 2)
    progress("DiffRenderer.step")
    dr = DiffRenderer(scene, cam, bounces=2, sky_color=SKY, device="cuda")

    def diff_steps(n):
        a = scene.materials.albedo
        for _ in range(n):
            a, _ = dr.step(a, tgt, 3, lr=0.1)

    diff_steps(1)                                  # warm-up
    torch.cuda.synchronize()
    out["DiffRenderer.step 256x256"] = reps(diff_steps, 10)
    ptxas = {}
    for lib in ("megakernel", "restir_di", "restir_gi", "megakernel_diff"):
        ptxas.update({k: v for k, v in ptxas_report(kernels.build_info[lib]["log"]).items()
                      if k.startswith(("frames_kernel", "k3_candidates", "k4_shade", "gi_mono", "gi_stage",
                                       "diff_kernel"))})
    print("AB " + json.dumps(dict(paths=out, tile_kernels=tile, ptxas=ptxas, bits=bits, gi_attribution=gi_attr)),
          flush=True)


def ab(others: list) -> None:
    """``--ab DIR [DIR ...]``: this checkout's package against the ones in
    each DIR (another checkout, e.g. ``git archive`` of the parent commit
    unpacked into a git-ignored directory; a side is named by its
    directory's name, this one "change"), ``ab_turn`` in turns: the others,
    this one, this one again, the others in reverse (parent, change,
    change, parent for one).  Prints one line a path: each side's median
    and range over its reps, change / each side, and each turn's median
    device and host ms in the order of the turns; one line a shape of K2
    and K3-K8 with each side's device ms a launch; one line with each
    side's K2 section shares (None for a tree whose K2 has no clocks) and
    one with its K5 and K6 section shares (``ab_gi_attribution``); one
    line with each side's registers, spills, occupancy and launches by
    shape; one line a K8 output with each turn's loss and d_tri off the change's first
    (``ab_k8_gates``); and one line a ReSTIR output whose digest any turn
    of any side gives otherwise than the change's first (``ab_bits``), with
    a count of those that agree."""
    trees = [os.path.abspath(t) for t in others] + [REPO]
    labels = [os.path.basename(t.rstrip(os.sep)) for t in trees[:-1]] + ["change"]
    order = list(zip(labels, trees))
    runs: dict = {label: [] for label in labels}
    turns = []
    failed = set()
    for label, tree in order + order[::-1]:
        if label in failed:
            continue
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--ab-turn", tree], capture_output=True,
                           text=True, cwd=tree, timeout=1200)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("AB ")]
        if r.returncode != 0 or not line:
            # a side whose turn fails is reported and left out; the change's must not fail
            emit("ab_turn_failed", side=label, returncode=r.returncode,
                 steps=[ln for ln in r.stderr.splitlines() if ln.startswith("ab_turn ")][-3:],
                 tail=(r.stdout + r.stderr)[-1500:])
            if label == "change":
                raise RuntimeError(f"the change's turn failed ({r.returncode})")
            failed.add(label)
            continue
        runs[label].append(json.loads(line[0][3:]))
        turns.append((label, runs[label][-1]))
    labels = [label for label in labels if label not in failed]
    turns = [(label, t) for label, t in turns if label not in failed]
    for key in runs["change"][0]["paths"]:
        reps = {label: [x for t in runs[label] for x in t["paths"][key]["ms"]] for label in labels}
        med = {label: statistics.median(v) for label, v in reps.items()}
        emit("ab", path=key, median=med, range={label: [min(v), max(v)] for label, v in reps.items()},
             change_over={label: med["change"] / med[label] for label in labels if label != "change"},
             turn_ms=[[label, statistics.median(t["paths"][key]["ms"])] for label, t in turns],
             turn_host_ms=[[label, statistics.median(t["paths"][key]["host_ms"])] for label, t in turns],
             reps=reps)
    tile_kernels = ("k2", "k3", "k4", "k5", "k6", "k7", "k8")
    for kernel in tile_kernels:
        # every side's shapes, the change's first (a side may time a kernel the change no longer has)
        shapes = list(runs["change"][0]["tile_kernels"][kernel]["ms_by_shape"])
        shapes += [k for label in labels for k in runs[label][0]["tile_kernels"][kernel]["ms_by_shape"] if k not in shapes]
        for shape in shapes:
            ms = {label: [t["tile_kernels"][kernel]["ms_by_shape"][shape] for t in runs[label]] for label in labels
                  if shape in runs[label][0]["tile_kernels"][kernel]["ms_by_shape"]}
            med = {label: statistics.median(v) for label, v in ms.items()}
            emit("ab_kernel", kernel=kernel, shape=shape, median_ms=med, turn_ms=ms,
                 change_over={label: med["change"] / med[label] for label in med if label != "change"}
                 if "change" in med else None)
    emit("ab_k2_attribution", shares={label: [t["tile_kernels"]["k2"].get("attribution") for t in runs[label]]
                                       for label in labels})
    emit("ab_gi_attribution", sections={label: [t.get("gi_attribution") for t in runs[label]] for label in labels})
    emit("ab_kernel_build", ptxas={label: runs[label][0]["ptxas"] for label in labels},
         occupancy={label: {k: runs[label][0]["tile_kernels"][k].get("occupancy_by_shape") for k in tile_kernels[1:]}
                    for label in labels},
         designs={label: {k: [t["tile_kernels"][k].get("designs_by_shape") for t in runs[label]]
                          for k in tile_kernels[1:]} for label in labels})
    # K8 sums in a run-dependent order: each side's loss and d_tri within
    # phase 5c's gates of the change's first turn
    for key, want in runs["change"][0]["tile_kernels"]["k8"]["outputs"].items():
        w_tri = max(abs(x) for x in want["d_tri"])
        turns_rel = {}
        for label in labels:
            turns_rel[label] = []
            for t in runs[label]:
                got = t["tile_kernels"]["k8"]["outputs"][key]
                d_tri = max(abs(a - b) for a, b in zip(got["d_tri"], want["d_tri"])) / w_tri
                turns_rel[label].append([abs(got["loss"] - want["loss"]) / want["loss"], d_tri])
        ok = all(lr <= 1e-5 and dr <= 1e-4 for v in turns_rel.values() for lr, dr in v)
        emit("ab_k8_gates", output=key, loss_and_d_tri_rel=turns_rel, ok=ok)
    first = runs["change"][0]["bits"]
    agree = 0
    for key, want in first.items():
        got = {label: [t["bits"].get(key) for t in runs[label]] for label in labels}
        if all(v == want for vs in got.values() for v in vs):
            agree += 1
        else:
            emit("ab_bits", output=key, change_first=want, digests=got, equal=False)
    emit("ab_bits_summary", outputs=len(first), equal_in_every_turn=agree)


def main() -> int:
    quick = "--quick" in sys.argv[1:]     # phases 1-6d only, no timing
    args = sys.argv[1:]
    if args[:1] == ["--ab-turn"]:
        ab_turn(args[1])
        return 0
    summary: dict = {}
    try:
        phase_env()
        if args[:1] == ["--ab"]:
            ab(args[1:])
            return 0
        sys.path.insert(0, REPO)
        phase_build()
        phase_k1(summary)
        phase_segment()
        phase_k2(summary)
        phase_k2_walks(summary)
        phase_restir(summary)
        phase_restir_gi(summary)
        phase_diff(summary)
        phase_textured(summary)
        phase_main(summary)
        phase_train(summary)
        phase_parallel(summary)
        phase_app()
        if not quick:
            phase_timing()
    except Exception:
        traceback.print_exc()
        print(json.dumps({"ok": False}), file=sys.stderr, flush=True)
        return 1

    import torch

    k2 = ("fypraytracer_tpu_torch/csrc/megakernel.cu", "fypraytracer_tpu/render/megakernel.py:1788")
    replaces = {"trace_closest": ("fypraytracer_tpu_torch/csrc/trace.cu", "fypraytracer_tpu/ops/pallas_dense.py:36"),
                **{name: k2 for name in K2_NAMES.values()},
                "restir_di_k3": ("fypraytracer_tpu_torch/csrc/restir_di.cu",
                                 "fypraytracer_tpu/render/megakernel_restir.py:243"),
                "restir_di_k4": ("fypraytracer_tpu_torch/csrc/restir_di.cu",
                                 "fypraytracer_tpu/render/megakernel_restir.py:417"),
                **{k: ("fypraytracer_tpu_torch/csrc/restir_gi.cu", "fypraytracer_tpu/render/megakernel_restir_gi.py:917")
                   for k in ("restir_gi_mono", "restir_gi_mono[final_vis]")},
                "restir_gi_k1": ("fypraytracer_tpu_torch/csrc/restir_gi.cu",
                                 "fypraytracer_tpu/render/megakernel_restir_gi.py:169"),
                "restir_gi_k2": ("fypraytracer_tpu_torch/csrc/restir_gi.cu",
                                 "fypraytracer_tpu/render/megakernel_restir_gi.py:447+:544"),
                "diff_megakernel": ("fypraytracer_tpu_torch/csrc/megakernel_diff.cu",
                                    "fypraytracer_tpu/render/megakernel_diff.py:117")}
    # the textured instantiations: the kernel beside the JAX fetch it carries
    fetch = " + fypraytracer_tpu/render/megakernel.py:1526 (build_tex_lookup)"
    replaces.update({name: (k2[0], k2[1] + fetch) for name in TEX_ROWS.values()})
    replaces.update({f"{k}[textured]": (src, rep + fetch) for k, (src, rep) in replaces.items()
                     if k in ("restir_di_k3", "restir_gi_mono", "restir_gi_k1")})
    replaces["restir_gi_mono[final_vis,textured]"] = (replaces["restir_gi_mono"][0],
                                                      replaces["restir_gi_mono"][1] + fetch)
    kern = [dict(name=k, route="cuda", source=src, replaces=rep, **summary[k]) for k, (src, rep) in replaces.items()]
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
