#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``fypraytracer_tpu_torch`` — and nothing of the JAX package — through
its main paths: the Cornell box under NEE+MIS (2 bounces, 1 spp), every other
technique 0-7, and the 200,712-triangle stress scene under NEE and ReSTIR DI,
in phases:

  1. environment: the card's name and power limit, torch and CUDA versions;
     TF32 is switched off for matmuls and cuDNN;
  2. build: the three kernel sources compiled from ``csrc/`` with nvcc, one
     nvcc per source, started together;
  3. K1 ``trace_closest`` against its plain PyTorch walk on the card;
  4. K2 ``megakernel`` against its plain version under the parity gates of
     tests/test_render_parity.py:111-114: every technique 0-6 at the main
     path's shape (Cornell 256², 8 frames, 2 bounces, 1 spp) and NEE on the
     stress scene at 128², 8 frames; then at 64², 4 frames, NEE with 1
     bounce and with 2 spp, the other samplers, and light sampling at 4 spp
     without spheres and sky (the DI unbiasedness check's settings);
  5. K3 ``restir_di_k3`` and K4 ``restir_di_k4`` each against its plain
     version on the same inputs, and the frame loop of both against
     ``restir_di_megakernel_plain``: 128², 8 frames on the stress scene, and
     64², 4 + 4 frames on Cornell with a camera move in between;
  6. the main paths, each with the kernels' launch counters reset just before
     and read just after: Cornell at 256² through ``Renderer`` and
     ``MegakernelRenderer`` under NEE, 8 frames, scored against
     ``benchmarks/goldens/cornell_nee.png`` (PSNR >= 35 dB, mean8 >= 3);
     ``MegakernelRenderer`` for every other technique 0-5 at 256²; the stress
     scene at 128², 8 frames, through ``MegakernelRenderer`` (NEE) and
     ``MegakernelReSTIRDI``, scored against ``stress_nee.png`` and
     ``stress_di.png``; and ReSTIR DI's image mean over 64 frames against the
     light-sampling megakernel's over 256 frames (within 5%);
  7. timing with CUDA events: the median of 5 reps after a warm-up, of
     ``render_many(64)`` for the K1 wavefront and the K2 megakernel (every
     technique) at 256², NEE also at 1920x1088, ``MegakernelReSTIRDI`` at
     256² and 1920x1088, both stress paths at 128², and of ``render_many(8)``
     for the plain PyTorch wavefront (NEE) and the K1 wavefront under ReSTIR
     DI at 256²; for the NEE K1 and K2 paths and the ReSTIR DI paths on
     Cornell, the card's busy time per frame from torch.profiler and the
     idle share it implies.

Each phase prints one JSON line; any failure exits non-zero.  The line before
the last is the kernels' summary, the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --quick    # phases 1-6: build, check, main paths
"""

from __future__ import annotations

import functools
import json
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


def settings_for(technique: str, **kw):
    """The main path's settings (2 bounces, 1 spp, the goldens' sky) for a
    technique named as in ``SamplingTechnique``."""
    from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique

    kw = dict(dict(bounces=2, samples=1, sky_color=SKY), **kw)
    return RenderSettings(technique=SamplingTechnique[technique], **kw)


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
         numpy_build_seconds=build_s, emissive=int(scene.emissive_tris.shape[0]))
    return scene, cam


def score(avg, golden_name: str, expect_shape) -> dict:
    """Finite, of the expected shape, and PSNR/mean8 against a golden."""
    import torch

    from fypraytracer_tpu_torch.core.color import finalize_pixels, to_uint8_rgb
    from fypraytracer_tpu_torch.utils import metrics
    from fypraytracer_tpu_torch.utils.image import load_png

    finite = bool(torch.isfinite(avg).all())
    rgb8 = to_uint8_rgb(finalize_pixels(avg, 1.0)).cpu().numpy()
    row = dict(shape=list(avg.shape), finite=finite, mean8=float(rgb8.mean()))
    ok = finite and tuple(avg.shape) == tuple(expect_shape) and row["mean8"] >= MEAN_FLOOR
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
    names = ("trace", "megakernel", "restir_di")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(kernels.build, names))      # raises if any build failed
    secs = time.perf_counter() - t0
    for name, info in kernels.build_info.items():
        for ln in info["log"].splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[ptxas {name}] {ln.strip()}", flush=True)
    emit("build", seconds=secs, libs={k: os.path.basename(v["path"]) for k, v in kernels.build_info.items()})


def phase_k1(summary: dict) -> None:
    import numpy as np
    import torch

    from fypraytracer_tpu_torch.core.camera import generate_rays
    from fypraytracer_tpu_torch.ops.traverse import trace_closest, trace_rays
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    builder, cam = cornell_box(256, 256)
    scene = builder.compile().to("cuda")
    o_cam, d_cam = generate_rays(cam.inv_projection, cam.inv_view, 256, 256, device="cuda")
    rng = np.random.default_rng(1234)
    o_rnd = rng.uniform([-0.99, 0.01, -0.99], [0.99, 1.99, 0.99], (65536, 3)).astype(np.float32)
    d_rnd = rng.normal(size=(65536, 3)).astype(np.float32)
    o = torch.cat([o_cam, torch.as_tensor(o_rnd, device="cuda")]).contiguous()
    d = torch.cat([d_cam, torch.as_tensor(d_rnd, device="cuda")]).contiguous()

    k = trace_closest(scene.bvh, scene.geometry, o, d)
    p = trace_rays(scene.bvh, scene.geometry, o, d)
    torch.cuda.synchronize()
    same = (k["tri"] == p["tri"]).float().mean().item()
    both = (k["tri"] >= 0) & (p["tri"] >= 0)
    dt = (k["t"][both] - p["t"][both]).abs().max().item() if bool(both.any()) else 0.0

    # per-call times at the main path's shape: the 256² camera rays
    ms = statistics.median(gpu_ms(lambda: trace_closest(scene.bvh, scene.geometry, o_cam, d_cam), 20))
    plain_ms = statistics.median(gpu_ms(lambda: trace_rays(scene.bvh, scene.geometry, o_cam, d_cam), 3))
    ok = same >= 0.9999 and dt <= 1e-5
    summary["trace_closest"] = dict(max_abs_err=dt, ms=ms, plain_ms=plain_ms, ids_equal=same)
    emit("k1_vs_plain", rays=int(o.shape[0]), ids_equal=same, max_abs_dt=dt, hit_frac=both.float().mean().item(),
         ms_per_call_65536=ms, plain_ms_per_call_65536=plain_ms, ok=ok)
    if not ok:
        raise AssertionError("K1 disagrees with its plain version")


def phase_k2(summary: dict) -> None:
    from fypraytracer_tpu_torch.render.megakernel import megakernel, megakernel_plain
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    def cornell(size, with_spheres=True):
        builder, cam = cornell_box(size, size, with_spheres=with_spheres)
        return builder.compile().to("cuda"), cam

    scenes = {"cornell": cornell, "cornell_no_spheres": lambda size: cornell(size, False),
              "stress": lambda size: stress_scene(size, size)}

    def check(tech, size, frames, scene_name="cornell", **kw):
        """K2 against its plain version; per-launch times of both."""
        st = settings_for(tech, **kw)
        scene, cam = scenes[scene_name](size)
        megakernel(scene, cam, 1, frames, st)                 # warm-up
        out = {}
        ms = statistics.median(gpu_ms(lambda: out.update(got=megakernel(scene, cam, 1, frames, st)), 5))
        plain_ms = statistics.median(gpu_ms(lambda: out.update(ref=megakernel_plain(scene, cam, 1, frames, st)), 1))
        row = parity(out["got"].cpu().numpy(), out["ref"].cpu().numpy())
        emit("k2_vs_plain", technique=tech, scene=scene_name, size=f"{size}x{size}", frames=frames,
             bounces=st.bounces, samples=st.samples, ms_per_launch=ms, plain_ms=plain_ms, **row)
        if not row["ok"]:
            raise AssertionError(f"K2 disagrees with its plain version: {tech} on {scene_name} at {size}², {kw}")
        return dict(max_abs_err=row["max_abs"], ms=ms, plain_ms=plain_ms, median_abs_err=row["median_abs"],
                    frac_px_over_1e3=row["frac_px_over_1e3"], parity_shape=f"{scene_name} {size}x{size}x{frames}f")

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
        check("NEE_MIS", 64, 4, bounces=bounces, samples=samples)
    for tech in ("UNIFORM", "COSINE", "GGX", "BRDF", "LIGHT_SOURCE"):
        check(tech, 64, 4)
    check("LIGHT_SOURCE", 64, 4, "cornell_no_spheres", samples=4, sky_color=(0.0, 0.0, 0.0))


def phase_restir(summary: dict) -> None:
    import torch

    from fypraytracer_tpu_torch.render import megakernel_restir as mr
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    st = settings_for("RESTIR_DI")
    scene, cam = stress_scene(128, 128)
    em = mr.prepare_emissive_table(scene)
    B = cam.width * cam.height
    ppv = cam.proj_view

    # each kernel against its plain version on the same inputs, after two
    # frames of history
    state = torch.zeros((mr.ST_ROWS, B), device="cuda")
    mr.restir_di_megakernel_plain(scene, em, cam, state, 1, 2, st, ppv, ppv)
    out = {}
    mr.restir_di_k3(scene, em, cam, 3, st, state, ppv)                 # warm-up
    k3_ms = statistics.median(gpu_ms(lambda: out.update(stage=mr.restir_di_k3(scene, em, cam, 3, st, state, ppv)), 5))
    k3_plain_ms = statistics.median(gpu_ms(
        lambda: out.update(ref=mr.restir_di_k3_plain(scene, em, cam, 3, st, state, ppv)), 1))
    d = (out["stage"] - out["ref"]).abs()
    k3_off = ((d > 1e-3 * torch.clamp_min(out["ref"].abs(), 1.0)).any(0)).float().mean().item()
    k3_row = dict(max_abs_err=d.max().item(), frac_px_over_1e3=k3_off, ok=k3_off < 0.01)
    emit("k3_vs_plain", size="128x128", scene="stress", ms_per_launch=k3_ms, plain_ms=k3_plain_ms, **k3_row)

    acc_k, acc_p = (torch.zeros((B, 3), device="cuda") for _ in range(2))
    st_k, st_p = state.clone(), state.clone()
    mr.restir_di_k4(scene, em, cam, 3, st, out["ref"], st_k, acc_k)
    mr.restir_di_k4_plain(scene, em, cam, 3, st, out["ref"], st_p, acc_p)
    k4_row = parity(acc_k.cpu().numpy(), acc_p.cpu().numpy())
    k4_row["state_frac_px_over_1e3"] = ((st_k - st_p).abs() > 1e-3 * torch.clamp_min(st_p.abs(), 1.0)).any(0).float().mean().item()
    k4_row["ok"] = bool(k4_row["ok"] and k4_row["state_frac_px_over_1e3"] < 0.01)
    scratch = torch.zeros((B, 3), device="cuda")
    k4_ms = statistics.median(gpu_ms(lambda: mr.restir_di_k4(scene, em, cam, 3, st, out["ref"], st_k, scratch), 5))
    k4_plain_ms = statistics.median(gpu_ms(
        lambda: mr.restir_di_k4_plain(scene, em, cam, 3, st, out["ref"], st_p, scratch), 1))
    emit("k4_vs_plain", size="128x128", scene="stress", ms_per_launch=k4_ms, plain_ms=k4_plain_ms, **k4_row)
    summary["restir_di_k3"] = dict(max_abs_err=k3_row["max_abs_err"], ms=k3_ms, plain_ms=k3_plain_ms,
                                   frac_px_over_1e3=k3_off, parity_shape="128x128 stress, 1 frame")
    summary["restir_di_k4"] = dict(max_abs_err=k4_row["max_abs"], ms=k4_ms, plain_ms=k4_plain_ms,
                                   median_abs_err=k4_row["median_abs"],
                                   frac_px_over_1e3=k4_row["frac_px_over_1e3"], parity_shape="128x128 stress, 1 frame")
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


def phase_main(summary: dict) -> None:
    import torch

    from fypraytracer_tpu_torch.ops.traverse import trace_closest
    from fypraytracer_tpu_torch.render import megakernel_restir as mr
    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer, megakernel
    from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
    from fypraytracer_tpu_torch.render.renderer import Renderer
    from fypraytracer_tpu_torch.scene.procedural import cornell_box

    def reset():
        trace_closest.launches = megakernel.launches = 0
        mr.restir_di_k3.launches = mr.restir_di_k4.launches = 0

    def counts():
        return dict(trace_closest=trace_closest.launches, megakernel=megakernel.launches,
                    restir_di_k3=mr.restir_di_k3.launches, restir_di_k4=mr.restir_di_k4.launches)

    def path(name, make, golden, expect, needs):
        """Drive one entry point with the counters reset just before and read
        just after; fail unless every kernel in ``needs`` launched."""
        reset()
        avg = make()
        torch.cuda.synchronize()
        launched = counts()
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


def device_busy(fn) -> tuple[float, int, list]:
    """Milliseconds the card spent in kernels during ``fn()``, the number of
    kernels it ran, and the three kernels that took most time, by
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.self_device_time_total / 1000.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return sum(by_name.values()), len(kernels), [[name[:60], ms] for name, ms in top]


def phase_timing() -> None:
    import torch

    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer, megakernel_plain
    from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
    from fypraytracer_tpu_torch.render.renderer import Renderer
    from fypraytracer_tpu_torch.scene.procedural import cornell_box
    from fypraytracer_tpu_torch.utils import metrics

    def plain_wavefront(scene, cam, settings, device):
        """The wavefront frames with every trace the plain PyTorch walk."""
        scene = scene.to(device)
        return lambda n: megakernel_plain(scene, cam, 1, n, settings)

    def render_many(cls):
        return lambda scene, cam, settings, device: cls(scene, cam, settings, device=device).render_many

    def rays(tech, w, h, st):
        """Rays a frame as bench.py counts them (primary + bounce + shadow)."""
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
    for name, make, tech, scene_of, w, h, frames, prof_frames in cases:
        st = settings_for(tech)
        scene, cam = scene_of(w, h)
        run = make(scene, cam, st, "cuda")
        run(2)                                     # warm-up dispatch
        torch.cuda.synchronize()
        reps = gpu_ms(lambda: run(frames), 5)
        ms_frame = statistics.median(reps) / frames
        row = dict(path=name, technique=tech, scene="stress" if scene_of is stress_scene else "cornell",
                   size=f"{w}x{h}", frames_per_rep=frames, reps_ms=reps, ms_per_frame=ms_frame,
                   rays_per_s=rays(tech, w, h, st) / (ms_frame / 1000.0))
        if prof_frames:
            busy, n_kernels, top = device_busy(lambda: run(prof_frames))
            # the profiler at times records no kernel of a dispatch that surely ran
            # some; such a reading is "not measured" (null), not an idle card
            seen = n_kernels > 0
            row.update(profiled_frames=prof_frames,
                       device_busy_ms_per_frame=busy / prof_frames if seen else None,
                       idle_share=1.0 - busy / prof_frames / ms_frame if seen else None,
                       kernels_per_frame=n_kernels / prof_frames if seen else None, top_kernels_ms=top)
        emit("timing", **row)
        del run
        torch.cuda.empty_cache()


def main() -> int:
    quick = "--quick" in sys.argv[1:]     # phases 1-6 only, no timing
    summary: dict = {}
    try:
        phase_env()
        sys.path.insert(0, REPO)
        phase_build()
        phase_k1(summary)
        phase_k2(summary)
        phase_restir(summary)
        phase_main(summary)
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
                                 "fypraytracer_tpu/render/megakernel_restir.py:417")}
    kern = [dict(name=k, route="cuda", source=src, replaces=rep, **summary[k]) for k, (src, rep) in replaces.items()]
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
