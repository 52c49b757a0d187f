"""Headless CLI — the framework's app surface, on PyTorch and the CUDA kernels.

The torch counterpart of ``fypraytracer_tpu/app/cli.py``, which replaces the
reference's interactive Walnut/ImGui app (WalnutApp.cpp) with three
commands mirroring its workflows (SURVEY.md §7 step 9):

  render     one technique, fixed frame count or time budget, image +
             provenance filename (WalnutApp.cpp:780-910 offline mode)
  benchmark  all (or selected) techniques at equal time/frames, MSE/PSNR
             against a golden image or a long-run self-reference
             (the "Benchmark render results" button, WalnutApp.cpp:590-615)
  train      inverse rendering: fit material parameters to a target image

Usage::

    python -m fypraytracer_tpu_torch.app.cli render --scene cornell --technique
        nee --width 256 --height 256 --frames 64 -o out/
    python -m fypraytracer_tpu_torch.app.cli benchmark --scene cornell --seconds 10
    python -m fypraytracer_tpu_torch.app.cli train --scene cornell --steps 50

Arguments and JSON lines are the JAX CLI's (cli.py:552-641), with these
differences:

  * ``--device`` (default ``cuda``): the card, where the entry points launch
    the hand-written kernels; ``cpu`` runs their plain PyTorch versions;
  * no fallback: a failing megakernel raises (the JAX CLI re-renders on
    the wavefront, cli.py:166-174); ``--strict`` is accepted and has
    nothing to switch;
  * every time is read after the card has finished (``torch.cuda.
    synchronize``); ``--burst`` keeps the JAX protocol's short dispatches,
    idle sleeps and best rep net of host overhead, fenced by a
    synchronize;
  * the megakernel path's untimed first batch (the kernels' build) is not
    kept in the image: a render of ``--frames N`` holds N frames;
  * times, MSE and PSNR are printed unrounded (sub-millisecond frames on
    the card);
  * scenes compile with the C++ builders (``accel/native.py``) where they
    build, else NumPy's, and a JSON line says which ran;
  * ``train --devices N`` trains over the ``torch.distributed`` default
    group of N processes, one a device (start them with ``torchrun
    --nproc-per-node N``; each rank prints its scene line, the training
    lines come from shard 0); the albedo perturbation is a
    ``torch.Generator`` seeded 0;
  * no compile cache to enable: the kernels are cached in ``_build/``;
  * ``render --trace-dir DIR`` writes ``DIR/trace.json``, the profiler's
    trace of the command with the package's spans merged in
    (``utils/profiling.py::device_trace``).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import torch

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique

_TECH = {
    "brute": SamplingTechnique.BRUTE_FORCE,
    "uniform": SamplingTechnique.UNIFORM,
    "cosine": SamplingTechnique.COSINE,
    "ggx": SamplingTechnique.GGX,
    "brdf": SamplingTechnique.BRDF,
    "light": SamplingTechnique.LIGHT_SOURCE,
    "nee": SamplingTechnique.NEE_MIS,
    "restir-di": SamplingTechnique.RESTIR_DI,
    "restir-gi": SamplingTechnique.RESTIR_GI,
}


def _sync(device) -> None:
    """Wait for the card's queued work when ``device`` is a CUDA device."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _load_scene(args):
    from fypraytracer_tpu_torch.scene.sceneio import builtin_scene, load_scene_file

    if args.scene.endswith(".json"):
        builder, cam = load_scene_file(args.scene)
    else:
        builder, cam = builtin_scene(args.scene, args.width, args.height)
    cam.resize(args.width, args.height)
    t0 = time.perf_counter()
    scene = builder.compile(native=True)
    print(json.dumps({"scene": args.scene, "triangles": int(scene.num_triangles),
                      "builders": builder.last_builders, "build_seconds": time.perf_counter() - t0}))
    return scene, cam


def _settings(args, technique) -> RenderSettings:
    return RenderSettings(
        technique=technique, bounces=args.bounces, samples=args.samples,
        sky_color=tuple(args.sky), light_candidates=args.candidates,
        spatial_neighbors=args.neighbors, spatial_radius=args.radius,
        temporal_history_limit=args.history)


def _burst_run(mk, frames, burst, reps, idle):
    """The JAX CLI's burst-window protocol (cli.py:63-96): short dispatches
    of ``burst`` frames separated by ``idle``-second sleeps, each fenced by
    a synchronize; the reported number is the fastest rep net of the
    per-call host overhead (a fence with no new work).  Accumulates
    ``frames`` in all so image quality stays comparable.  Returns
    ``(avg_hdr, frames_done, burst_ms/frame)``."""
    def fence(avg):
        if avg.is_cuda:
            torch.cuda.synchronize(avg.device)

    avg = mk.render_many(burst)                 # build + warm
    fence(avg)
    done = burst
    best = float("inf")
    while done < max(frames, burst * (reps + 1)):
        time.sleep(idle)
        t0 = time.perf_counter()
        avg = mk.render_many(burst)
        fence(avg)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        fence(avg)                              # no new work: host overhead
        host = time.perf_counter() - t0
        best = min(best, max(wall - host, 1e-9))
        done += burst
    return avg, done, best / burst * 1000.0


def _make_megakernel_renderer(scene, cam, settings, gi_fast=False, device="cuda"):
    """The one-launch renderer of a technique: ``MegakernelRenderer`` (K2)
    for 0-6, ``MegakernelReSTIRDI`` (K3+K4), ``MegakernelReSTIRGI`` mono
    (K5; ``gi_fast``: one visibility ray for the spatial winner)."""
    tech = settings.technique
    if tech == SamplingTechnique.RESTIR_DI:
        from fypraytracer_tpu_torch.render.megakernel_restir import MegakernelReSTIRDI
        return MegakernelReSTIRDI(scene, cam, settings, device=device)
    if tech == SamplingTechnique.RESTIR_GI:
        from fypraytracer_tpu_torch.render.megakernel_restir_gi import MegakernelReSTIRGI
        return MegakernelReSTIRGI(scene, cam, settings, device=device, mono=True, final_vis=bool(gi_fast))
    from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer
    return MegakernelRenderer(scene, cam, settings, device=device)


def _render_run(scene, cam, settings, frames=None, seconds=None, impl="auto", burst=0, burst_reps=4,
                burst_idle=2.5, gi_fast=False, device="cuda"):
    """Accumulate frames; returns ``(avg_hdr, frames, avg_frame_ms, impl_used)``.

    ``impl``: 'auto' | 'wavefront' | 'megakernel', chosen as the JAX CLI
    chooses (megakernel for ``frames`` >= 16 with W·H divisible by 128, or
    when asked).  The megakernel renders ``frames`` once untimed (the
    kernels' build), restarts, and renders them again timed, so the image
    holds the frames asked for (the JAX CLI keeps both batches: 2·frames);
    the wavefront renders a frame untimed, then frames until the budget is
    spent.  A failing kernel raises: there is no fallback to the
    wavefront.  ``burst`` > 0 times the megakernel by ``_burst_run``."""
    from fypraytracer_tpu_torch.render.renderer import Renderer

    use_mk = impl == "megakernel" or (
        impl == "auto" and frames is not None and (frames >= 16 or burst)
        and (cam.width * cam.height) % 128 == 0)
    if burst and not use_mk:
        raise SystemExit(
            "--burst requires the megakernel path (resolution divisible "
            f"by 128, --frames set); got {cam.width}x{cam.height}, impl={impl}")
    if use_mk:
        if frames is None:
            raise SystemExit("the megakernel path renders a frame budget: --impl megakernel requires --frames")
        mk = _make_megakernel_renderer(scene, cam, settings, gi_fast=gi_fast, device=device)
        if burst:
            avg, n, ms = _burst_run(mk, frames, burst, burst_reps, burst_idle)
            return avg, n, ms, "megakernel-burst"
        mk.render_many(frames)                   # the kernels' build and a warm run, untimed
        mk.reset()
        _sync(device)
        t0 = time.perf_counter()
        avg = mk.render_many(frames)             # timed
        _sync(device)
        dt = time.perf_counter() - t0
        return avg, frames, dt / frames * 1000.0, "megakernel"

    r = Renderer(scene, cam, settings, device=device)
    r.render_hdr()                               # the kernels' build, untimed
    r.reset()
    _sync(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        avg = r.render_hdr()
        n += 1
        if frames is not None and n >= frames:
            break
        if seconds is not None:
            _sync(device)
            if time.perf_counter() - t0 >= seconds:
                break
    _sync(device)
    dt = time.perf_counter() - t0
    return avg, n, dt / n * 1000.0, "wavefront"


def _render_checkpointed(scene, cam, settings, frames, ckpt_dir, every, impl="auto", gi_fast=False,
                         device="cuda"):
    """Long offline render (JAX cli.py:194-264): accumulate ``frames`` in
    ``every``-frame batches, checkpointing after each (``utils/checkpoint.py``:
    accumulation, frame index, the ReSTIR state), resuming from ``ckpt_dir``
    where it holds a checkpoint, into the renderer it records."""
    from fypraytracer_tpu_torch.render.renderer import Renderer
    from fypraytracer_tpu_torch.utils.checkpoint import load_checkpoint, read_meta, save_checkpoint

    resumed = os.path.exists(os.path.join(ckpt_dir, "meta.json"))
    use_mk = impl != "wavefront" and (cam.width * cam.height) % 128 == 0
    if impl == "megakernel" and not use_mk:
        raise SystemExit("--impl megakernel requires width*height divisible by 128; "
                         f"got {cam.width}x{cam.height}")
    if resumed:
        # resume into the renderer (and GI visibility estimator) that wrote
        # the checkpoint, never into whatever today's flags would pick
        saved = read_meta(ckpt_dir).get("renderer", {})
        use_mk = saved.get("class", "Renderer") != "Renderer"
        if saved.get("final_vis") is not None:
            gi_fast = bool(saved["final_vis"])

    if use_mk:
        def factory(s, c, st):
            return _make_megakernel_renderer(s, c, st, gi_fast=gi_fast, device=device)
    else:
        factory = functools.partial(Renderer, device=device)

    r = load_checkpoint(ckpt_dir, scene, renderer_cls=factory) if resumed else factory(scene, cam, settings)
    done0 = r.frame_index - 1
    print(json.dumps({"checkpoint": ckpt_dir, "resumed": resumed, "frames_done": done0}))

    _sync(device)
    t0 = time.perf_counter()
    avg = None
    while r.frame_index - 1 < frames:
        n = min(every, frames - (r.frame_index - 1))
        if use_mk:
            avg = r.render_many(n)
        else:
            for _ in range(n):
                avg = r.render_hdr()
        save_checkpoint(ckpt_dir, r)
        print(json.dumps({"frames_done": r.frame_index - 1, "checkpointed": True}))
    if avg is None:   # already complete on resume
        avg = (r.accum / float(max(r.frame_index - 1, 1))).reshape(r.camera.height, r.camera.width, 3)
    _sync(device)
    n_new = (r.frame_index - 1) - done0
    ms = (time.perf_counter() - t0) / max(n_new, 1) * 1000.0
    return avg, r.frame_index - 1, ms, ("megakernel" if use_mk else "wavefront") + "-ckpt"


def _rgb8(hdr):
    """The 8-bit image of an HDR average (tonemapped, clamped), on the host."""
    from fypraytracer_tpu_torch.core.color import finalize_pixels, to_uint8_rgb

    return to_uint8_rgb(finalize_pixels(torch.as_tensor(hdr), 1.0)).cpu().numpy()


def _save(outdir, name, hdr, settings, avg_ms, minutes, golden=None):
    from fypraytracer_tpu_torch.utils import metrics
    from fypraytracer_tpu_torch.utils.image import load_bmp, save_bmp, save_png
    from fypraytracer_tpu_torch.utils.provenance import run_name, write_sidecar

    rgb8 = _rgb8(hdr)
    mse = psnr = None
    if golden:
        if not golden.endswith(".bmp"):
            raise SystemExit("golden must be a .bmp (MisUtils protocol)")
        mse = metrics.mse_8bit(rgb8, load_bmp(golden))
        psnr = metrics.psnr(mse)
    base = run_name(settings, avg_frame_ms=avg_ms, total_minutes=minutes, mse=mse, psnr=psnr)
    os.makedirs(outdir, exist_ok=True)
    save_bmp(os.path.join(outdir, base + ".bmp"), rgb8)
    save_png(os.path.join(outdir, base + ".png"), rgb8)
    write_sidecar(os.path.join(outdir, base + ".json"), settings, avg_frame_ms=avg_ms, total_minutes=minutes,
                  mse=mse, psnr=psnr)
    return base, mse, psnr


def cmd_render(args):
    if args.trace_dir:
        from fypraytracer_tpu_torch.utils.profiling import device_trace

        with device_trace(args.trace_dir, args.device):
            _render(args)
        print(json.dumps({"trace": os.path.join(args.trace_dir, "trace.json")}))
    else:
        _render(args)


def _render(args):
    scene, cam = _load_scene(args)
    settings = _settings(args, _TECH[args.technique])
    if args.checkpoint_dir:
        if args.frames is None:
            raise SystemExit("--checkpoint-dir requires --frames")
        hdr, n, avg_ms, impl = _render_checkpointed(
            scene, cam, settings, args.frames, args.checkpoint_dir, args.checkpoint_every, impl=args.impl,
            gi_fast=args.gi_fast, device=args.device)
    else:
        hdr, n, avg_ms, impl = _render_run(scene, cam, settings, frames=args.frames, seconds=args.seconds,
                                           impl=args.impl, gi_fast=args.gi_fast, device=args.device)
    base, mse, psnr = _save(args.out, args.technique, hdr, settings, avg_ms, n * avg_ms / 60000.0, args.golden)
    print(json.dumps({"output": base, "frames": n, "avg_frame_ms": avg_ms, "impl": impl, "mse": mse,
                      "psnr": psnr}))


def cmd_benchmark(args):
    """Equal-budget comparison across techniques (the reference's whole
    purpose, README.md:5-7)."""
    if args.burst and args.frames is None:
        raise SystemExit("--burst requires --frames (not --seconds)")
    from fypraytracer_tpu_torch.utils import metrics as M
    from fypraytracer_tpu_torch.utils.image import save_png

    scene, cam = _load_scene(args)
    techniques = (args.techniques.split(",") if args.techniques
                  else ["uniform", "cosine", "ggx", "brdf", "light", "nee", "restir-di", "restir-gi"])

    # golden: long accumulation of the lowest-variance estimator (default
    # 256 frames of NEE+MIS at >= 4 spp; the reference's implicit oracle is
    # a long-run render, README.md:31)
    golden8 = None
    if args.golden_frames > 0:
        golden_hdr, _, _, _ = _render_run(
            scene, cam, _settings(args, _TECH[args.golden_technique]).replace(samples=max(args.samples, 4)),
            frames=args.golden_frames, device=args.device)
        golden8 = _rgb8(golden_hdr)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            save_png(os.path.join(args.out, "golden.png"), golden8)

    rows = []
    for name in techniques:
        hdr, n, avg_ms, impl = _render_run(scene, cam, _settings(args, _TECH[name]), frames=args.frames,
                                           seconds=args.seconds, burst=args.burst, burst_reps=args.burst_reps,
                                           burst_idle=args.burst_idle, gi_fast=args.gi_fast, device=args.device)
        rgb8 = _rgb8(hdr)
        row = {"technique": name, "frames": n, "avg_frame_ms": avg_ms, "impl": impl}
        if golden8 is not None:
            mse = M.mse_8bit(rgb8, golden8)
            row.update(mse=mse, psnr=M.psnr(mse))
        rows.append(row)
        print(json.dumps(row))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            save_png(os.path.join(args.out, name + ".png"), rgb8)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "benchmark.json"), "w") as f:
            json.dump(rows, f, indent=2)


def _mesh(args):
    """The pixel mesh of a training run: this one process without
    ``--devices`` (or with 1), else the ``torch.distributed`` default group,
    joined from the ``env://`` variables that ``torchrun`` sets, which must
    hold ``--devices`` processes; on CUDA each renders on the card of its
    local rank."""
    from fypraytracer_tpu_torch.parallel.distributed import init_distributed, make_pixel_mesh

    if not args.devices or args.devices == 1:
        return make_pixel_mesh(None, args.device)
    import torch.distributed as dist

    init_distributed(backend="nccl" if torch.device(args.device).type == "cuda" else "gloo")
    if dist.get_world_size() != args.devices:
        raise SystemExit(f"--devices {args.devices}: the process group holds {dist.get_world_size()} processes")
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())))
        torch.cuda.set_device(device)
    return make_pixel_mesh(None, device)


def _perturbed(albedo, device):
    """The albedo perturbed by a normal of 0.25 (a ``torch.Generator``
    seeded 0), clipped to [0.05, 0.95]: every shard draws the same."""
    gen = torch.Generator(device=device).manual_seed(0)
    noise = torch.randn(albedo.shape, generator=gen, device=device)
    return torch.clamp(albedo + 0.25 * noise, 0.05, 0.95)


def _train_fast(args, scene, cam):
    """Fused-kernel inverse rendering of the albedo (JAX cli.py:375-417):
    ``DiffRenderer`` (K8), the targets the port's cosine wavefront's frames
    1-4."""
    from fypraytracer_tpu_torch.core.camera import generate_rays
    from fypraytracer_tpu_torch.ops.traverse import pick_tracer
    from fypraytracer_tpu_torch.render.integrators import radiance_hemisphere
    from fypraytracer_tpu_torch.render.megakernel_diff import DiffRenderer

    device = torch.device(args.device)
    settings = _settings(args, SamplingTechnique.COSINE)
    dr = DiffRenderer(scene, cam, bounces=args.bounces, sky_color=tuple(args.sky), device=device)
    o, d = generate_rays(cam.inv_projection, cam.inv_view, cam.width, cam.height, device=device)
    pix = torch.arange(cam.width * cam.height, device=device)
    trace = pick_tracer(dr.scene)
    n_tgt = min(args.steps, 4)
    targets = {f: radiance_hemisphere(dr.scene, trace, o, d, pix, f, settings, "cosine")
               for f in range(1, n_tgt + 1)}
    true_alb = dr.scene.materials.albedo
    alb = _perturbed(true_alb, device)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(args.steps):
        f = 1 + (i % n_tgt)
        alb, loss = dr.step(alb, targets[f], f, lr=args.lr * 10)
        alb = torch.clamp(alb, 0.0, 1.0)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(json.dumps({"step": i, "loss": float(loss)}))
    _sync(device)
    dt = (time.perf_counter() - t0) / args.steps
    err = float((alb - true_alb).abs().mean())
    print(json.dumps({"final_albedo_mae": err, "impl": "megakernel", "avg_step_ms": dt * 1000}))


def _train_restir(args, scene, cam, mode="restir-di"):
    """Inverse rendering through the ReSTIR reservoir estimators (JAX
    cli.py:420-483): ``parallel/restir_shard.py``'s train steps, the
    discrete reservoir machinery detached, the albedo updated by SGD in
    micro-steps of up to 10 a call."""
    import dataclasses

    from fypraytracer_tpu_torch.parallel import restir_shard as RS
    from fypraytracer_tpu_torch.parallel.shard import gather_pixels, replicate_scene

    gi = mode == "restir-gi"
    settings = _settings(args, SamplingTechnique.RESTIR_GI if gi else SamplingTechnique.RESTIR_DI)
    mesh = _mesh(args)
    say = print if mesh.index == 0 else (lambda *_: None)
    scene_d = replicate_scene(scene, mesh)
    ip, iv, ppv = cam.inv_projection, cam.inv_view, cam.prev_proj_view
    render, init_state = (RS.make_restir_gi_sharded if gi else RS.make_restir_di_sharded)(
        scene_d, mesh, cam.width, cam.height, settings)
    target = gather_pixels(mesh, render(ip, iv, ppv, 1, init_state())[0])

    true_albedo = scene_d.materials.albedo
    params = dataclasses.replace(scene_d.materials, albedo=_perturbed(true_albedo, mesh.device))
    group = max(min(args.steps, 10), 1)
    # lr scale per estimator (JAX cli.py:463-466): DI's MSE sits ~1e-4, GI's
    # pixel values are larger
    lr = args.lr * (25 if gi else 500)
    step, init_tr = (RS.make_restir_gi_train_step if gi else RS.make_restir_di_train_step)(
        scene_d, mesh, cam.width, cam.height, settings, lr=lr, fields=("albedo",), steps_per_call=group,
        clip01=("albedo",))
    state0 = init_tr()
    done = 0
    while done < args.steps:
        params, _, losses = step(params, ip, iv, ppv, 1, state0, target)
        done += group
        say(json.dumps({"step": min(done, args.steps) - 1, "loss": float(torch.atleast_1d(losses)[-1])}))
    err = float((params.albedo - true_albedo).abs().mean())
    say(json.dumps({"final_albedo_mae": err, "impl": mode}))


def cmd_train(args):
    """Inverse-rendering demo: recover albedos from a rendered target.

    ``--impl megakernel`` takes the fused loss and gradient kernel
    (``render/megakernel_diff.py``, K8; albedo, cosine estimator); the
    default trains by autograd through the NEE wavefront
    (``parallel/shard.py::make_train_step``, K1 traces), ``--technique
    restir-di|restir-gi`` through the ReSTIR estimators."""
    import dataclasses

    from fypraytracer_tpu_torch.parallel.shard import (gather_pixels, make_train_step, replicate_scene,
                                                       sharded_render)

    scene, cam = _load_scene(args)
    if args.technique in ("restir-di", "restir-gi"):
        if args.impl == "megakernel":
            raise SystemExit("--impl megakernel trains the fused cosine-estimator kernel; it does not support "
                             f"--technique {args.technique}")
        return _train_restir(args, scene, cam, mode=args.technique)
    if args.impl == "megakernel":
        return _train_fast(args, scene, cam)
    settings = _settings(args, SamplingTechnique.NEE_MIS)
    mesh = _mesh(args)
    say = print if mesh.index == 0 else (lambda *_: None)
    scene_d = replicate_scene(scene, mesh)

    # target: the cosine frame with the TRUE materials
    step = make_train_step(scene_d, cam.width, cam.height, settings, lr=args.lr, mesh=mesh)
    render = sharded_render(scene_d, mesh, cam.width, cam.height,
                            settings.replace(technique=SamplingTechnique.COSINE), "cosine")
    ip, iv = cam.inv_projection, cam.inv_view
    target = gather_pixels(mesh, render(ip, iv, 1))

    params = dataclasses.replace(scene_d.materials, albedo=_perturbed(scene_d.materials.albedo, mesh.device))
    for i in range(args.steps):
        params, loss = step(params, ip, iv, i + 1, target)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            say(json.dumps({"step": i, "loss": float(loss)}))
    err = float((params.albedo - scene_d.materials.albedo).abs().mean())
    say(json.dumps({"final_albedo_mae": err}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="fypraytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", default="cornell", help="builtin name or scene .json path")
        sp.add_argument("--width", type=int, default=256)
        sp.add_argument("--height", type=int, default=256)
        sp.add_argument("--bounces", type=int, default=2)
        sp.add_argument("--samples", type=int, default=1)
        sp.add_argument("--sky", type=float, nargs=3, default=[0.05, 0.06, 0.08])
        sp.add_argument("--candidates", type=int, default=8)
        sp.add_argument("--neighbors", type=int, default=5)
        sp.add_argument("--radius", type=int, default=30)
        sp.add_argument("--history", type=int, default=2)
        sp.add_argument("--device", default="cuda",
                        help="cuda: the hand-written kernels on the card; cpu: their plain PyTorch versions")
        sp.add_argument("--strict", action="store_true",
                        help="accepted for the JAX CLI's sake: a failing kernel always raises here")
        sp.add_argument("--gi-fast", action="store_true",
                        help="ReSTIR GI speed mode: one visibility ray for the spatial winner "
                             "(final_vis) instead of one per neighbour (Renderer.cu:2356-2366)")

    r = sub.add_parser("render", help="render one technique")
    common(r)
    r.add_argument("--technique", choices=sorted(_TECH), default="nee")
    r.add_argument("--frames", type=int, default=None)
    r.add_argument("--seconds", type=float, default=None)
    r.add_argument("--golden", default=None, help="golden BMP for MSE/PSNR")
    r.add_argument("--impl", choices=["auto", "wavefront", "megakernel"], default="auto",
                   help="renderer implementation")
    r.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint/resume directory for long renders: saves accumulation + reservoir state "
                        "every --checkpoint-every frames and resumes from an existing checkpoint")
    r.add_argument("--checkpoint-every", type=int, default=64)
    r.add_argument("--trace-dir", default=None,
                   help="write DIR/trace.json: a torch.profiler trace of the whole command (scene build, "
                        "renders, save) with the package's spans on a track of their own (Perfetto)")
    r.add_argument("-o", "--out", default="RenderedImages")
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("benchmark", help="equal-budget technique comparison")
    common(b)
    b.add_argument("--techniques", default=None, help="comma list")
    b.add_argument("--frames", type=int, default=None)
    b.add_argument("--seconds", type=float, default=None)
    b.add_argument("--golden-frames", type=int, default=256,
                   help="0 = timing-only (skip the golden render + PSNR)")
    b.add_argument("--golden-technique", choices=sorted(_TECH), default="nee",
                   help="estimator for the golden image")
    b.add_argument("--burst", type=int, default=0,
                   help="frames per dispatch for burst-window timing (0 = off): short dispatches + idle sleeps")
    b.add_argument("--burst-reps", type=int, default=4)
    b.add_argument("--burst-idle", type=float, default=2.5, help="idle seconds between burst dispatches")
    b.add_argument("-o", "--out", default=None)
    b.set_defaults(fn=cmd_benchmark)

    t = sub.add_parser("train", help="inverse-rendering material fit")
    common(t)
    t.add_argument("--steps", type=int, default=30)
    t.add_argument("--lr", type=float, default=0.2)
    t.add_argument("--devices", type=int, default=None,
                   help="train over this many processes of the torch.distributed default group (torchrun)")
    t.add_argument("--impl", choices=["wavefront", "megakernel"], default="wavefront",
                   help="megakernel = fused loss+albedo-grad kernel")
    t.add_argument("--technique", choices=["nee", "restir-di", "restir-gi"], default="nee",
                   help="estimator to differentiate through; restir-di/restir-gi = pixel gradients through "
                        "the reservoir estimators")
    t.set_defaults(fn=cmd_train)

    args = p.parse_args(argv)
    if args.cmd in ("render", "benchmark") and args.frames is None and args.seconds is None:
        args.frames = 16
    args.fn(args)


if __name__ == "__main__":
    main()
