"""The readings a cell's limits are set from, on the chip at the cell's size.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3 [--frames N] [--seconds S]

Not run by the benchmark's own runs.  For each seed it prints one JSON
line with the numbers the cell's check compares, each read with something
else in the program's place:

  * ``control``: the plain reference itself computed in bfloat16, the
    precision below the configuration's float32;
  * for the training cell, the faults a training step can have, planted in
    the float32 reference put in the program's place: ``half_batch`` (the
    loss and gradient of the first half of the image's rows, their mean
    taken over that half) and ``altered`` (each step's loss 1% high where
    it is produced).  A step that leaves its state unchanged reads 1
    on ``grad_gap`` and ``change_gap`` by construction (its gradient, read
    from its albedo, and its change are nought) and is not run.

A render cell's control sums ``--frames`` frames (about what one run's
window holds) at the pixels its check samples for that seed.  A training
cell's readings are taken at both of its check's stages: from the seed's
albedo (``start``), and from the program's own state after a window of
``--seconds`` (``window``), where the program's own reading is printed
beside them, and whether a step of the stage began at an albedo clamped
to 0 (``from_zero``).  The sound readings are also what the benchmark's
runs print.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpubench.reference import diff, scenes  # noqa: E402
from gpubench.run import Cell, load_module, manifest  # noqa: E402
from gpubench.seeds import frame0_of  # noqa: E402

# Cells kept out of BENCHMARK.json while the program fails them, with the
# entries they and the metrics only they report would have there, grouped as
# in BENCHMARK.json: a metric's list may name only cells that the manifest
# has.  Their harness is kept whole, and this tool and the tests still drive
# them.  A cell is admitted by appending these entries to BENCHMARK.json
# alone: an entry the manifest has is no longer held out.
# cornell-train-1080p: K8 returns a NaN gradient on some steps once the
# metallic sphere's albedo is clamped to 0 (PERF.md §7); its limits are set
# from readings of windows that end before K8's first NaN, and step_ms's
# bound from two sets of 6 runs at 40 s (PERF.md §2).
HELD_OUT = {
    "workloads": [
        {"name": "cornell-train-1080p", "config": "cornell", "traffic": "train-1080p", "chips": 1,
         "why": "1920x1088 DiffRenderer.step, cosine, 2 bounces, SGD lr 0.2 clamped to [0,1], loss read every "
                "16 steps: K8, segment sum, update; not K2"},
    ],
    "end_to_end": [
        {"name": "step_ms", "unit": "ms", "better": "lower", "bound": 0.025, "source": "host_clock",
         "workloads": ["cornell-train-1080p"]},
    ],
    "per_layer": [
        {"name": "host_ms.step", "unit": "ms", "better": "lower", "source": "host_clock", "layer": "entry points",
         "moves": "step_ms", "workloads": ["cornell-train-1080p"]},
        {"name": "k8_roofline", "unit": "%", "better": "higher", "source": "device_trace", "layer": "kernels",
         "moves": "step_ms", "workloads": ["cornell-train-1080p"]},
        {"name": "idle_share.step", "unit": "%", "better": "lower", "source": "device_trace", "layer": "device",
         "moves": "step_ms", "workloads": ["cornell-train-1080p"]},
    ],
}


def bench_with_held_out() -> dict:
    """BENCHMARK.json with each held-out entry it does not have appended."""
    b = manifest()
    out = dict(b)
    for key, entries in HELD_OUT.items():
        have = {e["name"] for e in b[key]}
        out[key] = b[key] + [e for e in entries if e["name"] not in have]
    return out


def render_readings(cell, seed, frames, device) -> dict:
    entry = load_module("entries", cell.traffic["entry"])
    tr = cell.traffic
    pixels = entry.sample_pixels(seed, tr["width"] * tr["height"], cell.data["check"]["pixels"])
    frame0 = frame0_of(seed)
    ref = entry.reference_sums(cell, seed, pixels, frame0, frames, device)
    low = entry.reference_sums(cell, seed, pixels, frame0, frames, device, torch.bfloat16)
    return {"control": entry.gaps(low, ref)}


def planted_step(scene, cam, bvh, albedo, target, frame: int, tr: dict, fault: str):
    """One clamped SGD step of the float32 reference with ``fault``
    planted: ``(new albedo, loss, gradient)``, on the host."""
    from gpubench.reference.bvh import closest_hit

    geo = scene.geometry
    dev = geo.positions.device
    W, H = cam.width, cam.height
    rows_kept = max(H // 2, 1) if fault == "half_batch" else H

    def trace(o, d, live):
        return closest_hit(bvh, geo.positions, geo.tri_v, o, d, live)

    leaf = albedo.detach().float().to(dev).clone().requires_grad_(True)
    loss = 0.0
    for y0 in range(0, rows_kept, diff.ROWS):
        ids = torch.arange(y0 * W, min(rows_kept, y0 + diff.ROWS) * W, device=dev)
        out = diff.render(scene, leaf, cam, ids, frame, tr["bounces"], tr["sky"], trace)
        part = ((out - target.to(dev)[ids]) ** 2).sum() / float(3 * W * rows_kept)
        part.backward()
        loss += float(part.detach())
    grad = leaf.grad.detach().cpu()
    new = torch.clamp(albedo.float().cpu() - tr["lr"] * grad, *tr["clamp"])
    return new, loss * (1.01 if fault == "altered" else 1.0), grad


def _planted_sgd(cell, judged, device, fault: str):
    """The float32 reference's SGD with ``fault`` planted in its step."""
    from gpubench.reference.bvh import tree

    tr = cell.traffic
    host, cam = scenes.build(cell.config, tr["width"], tr["height"])
    scene = host.to(device)
    bvh = tree(scene.geometry)
    a = judged["albedo0"].float()
    losses, albedos, grads = [], [a.double()], []
    for k in range(len(judged["losses"])):
        a, loss, grad = planted_step(scene, cam, bvh, a, judged["target"], judged["frame0"] + k, tr, fault)
        losses.append(loss)
        albedos.append(a.double())
        grads.append(grad)
    return losses, albedos, grads


def train_readings(cell, seed, device, seconds: float) -> dict:
    """Both stages' readings: the program's own, the control's and each
    planted fault's, against the reference from the same albedo."""
    import time

    from gpubench.entries import diff_step as ds
    from gpubench.run import Recorder

    rec = Recorder()
    prog = ds.setup(cell, seed, device, rec)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or prog.steps < prog.min_updates:
        prog.update(rec)
    torch.cuda.synchronize(device)
    judged = prog.collect()
    del prog
    lr = cell.traffic["lr"]
    out = {}
    for stage in ("start", "window"):
        base = judged[stage]
        ref = ds.reference_steps(cell, base, device)
        out[f"{stage}.program"] = ds.gaps(base, *ref, lr)
        # whether a step began at an albedo clamped to 0, where K8's fault lies (PERF.md §7)
        out[f"{stage}.from_zero"] = any(bool((a == 0).any()) for a in [base["albedo0"]] + base["albedos"][:-1])
        for name, (losses, albedos, _) in (("control", ds.reference_steps(cell, base, device, torch.bfloat16)),
                                           ("half_batch", _planted_sgd(cell, base, device, "half_batch")),
                                           ("altered", _planted_sgd(cell, base, device, "altered"))):
            out[f"{stage}.{name}"] = ds.gaps(dict(base, losses=losses, albedos=albedos[1:]), *ref, lr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=5000)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control readings are taken on the card: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell.find(args.workload, bench_with_held_out())
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.traffic["entry"] == "diff_step":
            r = train_readings(cell, seed, dev, args.seconds)
        else:
            r = render_readings(cell, seed, args.frames, dev)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
