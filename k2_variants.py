#!/usr/bin/env python3
"""K2 (csrc/megakernel.cu) against variants of its own source, in turns, on one card.

Each variant is the committed source with a few lines replaced (``VARIANTS``):
the launch bound's blocks a multiprocessor (``mbN``: every sampler's
``min_blocks`` set to N, ``mb0`` no minimum), the light tree's corner loop
unrolled (``unrolled``) and NEE's shadow walk unbounded (``unbounded``);
``+`` joins them (``mb8+unrolled``).  A variant's
copy of ``csrc/`` goes under ``fypraytracer_tpu_torch/_build/variants/``;
each side runs in a process of its own (the build's flags and sources are
process state), all sides built first, in parallel, then timed in turns
(kept, the variants, the variants again in reverse, kept).  Times are CUDA
events around 3 reps of a run of launches after a warm-up, the median rep
over the run's launches, at the shapes ``chip_smoke.py --ab`` times K2
(``K2_AB``) and with 1 and 2 lanes at 1920x1088.  Prints one JSON line a
side's build (registers and spill bytes of every K2 instantiation), one a
turn, and one a shape with each side's median ms and its ratio to kept.
Needs a CUDA card:

    python3 k2_variants.py mb8 unrolled
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# name -> [(file in csrc/, old text, new text)]
VARIANTS = {
    "unrolled": [("shading.cuh", "#pragma unroll 1\n  for (int i = 0; i < 8; ++i) {",
                  "#pragma unroll\n  for (int i = 0; i < 8; ++i) {")],
    "unbounded": [("megakernel.cu", "r = Ray{s.pos + s.n * kOriginEps, l_dir, __fadd_rn(dist, tol), kShadow};",
                   "r = Ray{s.pos + s.n * kOriginEps, l_dir, kBig + 0.0f * tol, kShadow};")],
}
MIN_BLOCKS = "constexpr int min_blocks() { return S == NEE ? 5 : 6; }"
# (technique, scene, width, height, frames, lanes or None for k2_lanes, launches a rep)
CASES = ([("NEE_MIS", "cornell", 256, 256, 8, None, 20), ("NEE_MIS", "cornell", 256, 256, 64, None, 5),
          ("NEE_MIS", "stress", 128, 128, 8, None, 20), ("NEE_MIS", "cornell", 1920, 1088, 8, None, 3),
          ("NEE_MIS", "cornell", 1920, 1088, 8, 1, 3), ("NEE_MIS", "cornell", 1920, 1088, 8, 2, 3)]
         + [(t, "cornell", 256, 256, 8, None, 20) for t in ("UNIFORM", "COSINE", "GGX", "BRDF", "LIGHT_SOURCE")])


def use_variant(name: str):
    """Point ops/kernels.py at the variant's copy of csrc/ (made once)."""
    from fypraytracer_tpu_torch.ops import kernels

    if name == "kept":
        return kernels
    dst = os.path.join(kernels.BUILD_DIR, "variants", name, "csrc")
    if not os.path.isdir(dst):
        tmp = f"{dst}.{os.getpid()}"
        shutil.copytree(kernels.CSRC, tmp)
        for part in name.split("+"):
            if part.startswith("mb"):
                subs = [("megakernel.cu", MIN_BLOCKS,
                         f"constexpr int min_blocks() {{ return {max(int(part[2:]), 1)}; }}")]
            else:
                subs = VARIANTS[part]
            for fn, old, new in subs:
                path = os.path.join(tmp, fn)
                with open(path) as f:
                    text = f.read()
                if old not in text:
                    raise RuntimeError(f"variant {part}: {fn} has no {old!r}")
                with open(path, "w") as f:
                    f.write(text.replace(old, new))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.replace(tmp, dst)
    kernels.CSRC = dst
    return kernels


def build(name: str) -> None:
    import chip_smoke

    kernels = use_variant(name)
    kernels.build("megakernel")
    rep = {k: v for k, v in chip_smoke.ptxas_report(kernels.build_info["megakernel"]["log"]).items()
           if k.startswith("frames_kernel")}
    print("BUILD " + json.dumps(dict(side=name, ptxas=rep)), flush=True)


def scenes() -> dict:
    from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
    from fypraytracer_tpu_torch.scene import procedural

    out = {}
    for name, w, h in {(c[1], c[2], c[3]) for c in CASES}:
        if name == "stress":
            builder, cam = procedural.stress(w, h)
            out[(name, w, h)] = (morton_permuted_scene(builder.compile(native=True))[0].to("cuda"), cam)
        else:
            builder, cam = procedural.cornell_box(w, h)
            out[(name, w, h)] = (builder.compile().to("cuda"), cam)
    return out


def time_side(name: str) -> None:
    import torch

    from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render import megakernel as mk

    use_variant(name)
    sc = scenes()
    ms = {}
    for tech, scene_name, w, h, frames, lanes, calls in CASES:
        scene, cam = sc[(scene_name, w, h)]
        st = RenderSettings(technique=SamplingTechnique[tech], bounces=2, samples=1, sky_color=(0.05, 0.06, 0.08))
        lanes = lanes or mk.k2_lanes(frames)

        def run():
            mk.megakernel(scene, cam, 1, frames, st, lanes=lanes)

        run()
        torch.cuda.synchronize()
        reps = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                run()
            end.record()
            torch.cuda.synchronize()
            reps.append(start.elapsed_time(end) / calls)
        ms[f"{tech} {scene_name} {w}x{h} {frames} frames lanes{lanes}"] = statistics.median(reps)
    for scene, _ in sc.values():
        check_overflow(scene)
    print("TURN " + json.dumps(dict(side=name, ms=ms)), flush=True)


def main(variants: list) -> int:
    sides = ["kept"] + variants
    me = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, me, "--build", s], cwd=REPO, stdout=subprocess.PIPE, text=True)
             for s in sides]
    for p in procs:
        out, _ = p.communicate(timeout=900)
        print(out, end="", flush=True)
        if p.returncode != 0:
            return p.returncode
    turns = {s: [] for s in sides}
    for side in sides + sides[::-1]:
        r = subprocess.run([sys.executable, me, "--time", side], cwd=REPO, capture_output=True, text=True,
                           timeout=900)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("TURN ")]
        if r.returncode != 0 or not line:
            print(r.stdout + r.stderr[-3000:], flush=True)
            return r.returncode or 1
        print(line[0], flush=True)
        turns[side].append(json.loads(line[0][5:])["ms"])
    for shape in turns["kept"][0]:
        med = {s: statistics.median(t[shape] for t in turns[s]) for s in sides}
        print(json.dumps(dict(shape=shape, median_ms=med, over_kept={s: med[s] / med["kept"] for s in variants})),
              flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        build(sys.argv[2])
    elif sys.argv[1:2] == ["--time"]:
        time_side(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
