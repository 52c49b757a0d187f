"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; everything it needs is found by name:

  * ``gpubench/configs/<config>.json``: the scene and how it is built;
  * ``gpubench/traffic/<traffic>.json``: the entry point and its load
    (resolution, bounces, samples, frames an update, ...);
  * ``gpubench/workloads/<cell>.json``: the cell's frozen operation and
    byte counts (``gpubench/count/``) and the limits of its check;
  * ``gpubench/entries/<entry>.py``: how the system under test is set up,
    driven for one update and judged against the plain reference, the
    span around its call into the program (``CALL_SPAN``), and the count
    of its kernels' work (``count``);
  * ``gpubench/metrics/<metric>.py``: one reader a metric.

The run sets up (scene, renderer, warm-up of exactly the cell's shapes),
measures a closed loop of updates for ``--seconds``, reads the device's
memory peak, frees the program, and only then runs the plain reference
(``gpubench/reference/``) to decide ``correct``.  ``--trace 1`` runs the
same window under ``torch.profiler`` and reports the per-layer metrics
instead of the end-to-end ones.  A run without a CUDA device, or with
fewer than the cell asks for, prints no result and exits 2; a process
that holds JAX or the JAX package after the window prints none and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "gpubench")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that must not be loaded by the process that
# prints a result: the reference package and the libraries it runs on
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fypraytracer_tpu")


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``gpubench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gpubench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """Everything a run reads about its cell, found by name."""

    name: str
    config: dict
    traffic: dict
    data: dict            # gpubench/workloads/<cell>.json
    chips: int

    @classmethod
    def find(cls, name: str, bench: dict | None = None) -> "Cell":
        bench = bench or manifest()
        entries = [w for w in bench["workloads"] if w["name"] == name]
        if not entries:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        w = entries[0]
        return cls(name=name, config=load_json("configs", f"{w['config']}.json"),
                   traffic=load_json("traffic", f"{w['traffic']}.json"),
                   data=load_json("workloads", f"{name}.json"), chips=int(w["chips"]))


class Recorder:
    """The benchmark's own host spans, kept in memory: ``(name, start,
    end)`` on ``time.perf_counter``.  While a profiler runs, each span is
    also a ``record_function`` range, so the trace can say what the host
    was doing during the device's idle gaps."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.profiling:
            import torch

            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    def total(self, name: str, t0: float = float("-inf"), t1: float = float("inf")) -> tuple[float, int]:
        """Seconds and count of the spans called ``name`` that start in [t0, t1)."""
        sel = [e - s for n, s, e in self.spans if n == name and t0 <= s < t1]
        return sum(sel), len(sel)


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cell: Cell
    rec: Recorder
    setup_s: float = 0.0
    window: tuple[float, float] = (0.0, 0.0)
    updates: list = dataclasses.field(default_factory=list)   # (start, end) a update
    units_per_update: int = 1
    unit: str = "frame"
    call_span: str = ""                                         # the span around the entry point's call
    trace: object = None                                        # gpubench.trace.Trace

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def measure(run: Run, prog, seconds: float, trace: bool, device) -> tuple[int, int]:
    """The measured window: updates in a closed loop until ``seconds`` have
    passed and the program has made the updates its check needs
    (``min_updates``), then one synchronize.  Returns ``(attempted,
    failed)``."""
    import torch

    attempted = failed = 0
    prof = None
    if trace:
        from gpubench.trace import start_profiler

        prof = start_profiler(device)
        run.rec.profiling = True
    t_w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        attempted += 1
        try:
            prog.update(run.rec)
        except RuntimeError as e:      # a check inside the program (e.g. its walks' overflow) refused the update
            failed += 1
            print(f"update {attempted} failed: {e}", file=sys.stderr)
        t1 = time.perf_counter()
        run.updates.append((t0, t1))
        if t1 - t_w0 >= seconds and attempted >= getattr(prog, "min_updates", 1):
            break
    with run.rec.span("synchronize"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    run.window = (t_w0, time.perf_counter())
    if prof is not None:
        from gpubench.trace import read_profile

        prof.__exit__(None, None, None)
        run.rec.profiling = False
        run.trace = read_profile(prof, run.rec)
    return attempted, failed


def forbidden_loaded() -> list[str]:
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top & set(FORBIDDEN_MODULES))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", size=None,
             bench: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line as a dict (``checks``
    last).  ``device="cpu"`` and ``size=(width, height)`` are for the tests,
    which drive the harness around the program's plain CPU paths."""
    import torch

    cell = Cell.find(name, bench)
    if size is not None:
        cell.traffic = dict(cell.traffic, width=size[0], height=size[1])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec = Recorder()
    entry = load_module("entries", cell.traffic["entry"])
    prog = entry.setup(cell, seed, dev, rec)
    run = Run(cell=cell, rec=rec, units_per_update=prog.units_per_update, unit=prog.unit,
              call_span=entry.CALL_SPAN)
    run.setup_s = time.perf_counter() - T_START
    attempted, failed = measure(run, prog, seconds, trace, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    judged = prog.collect()
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = entry.check(cell, seed, judged, dev)
    check_s = time.perf_counter() - t_check
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    for c in checks.values():       # a comparison that gives no number fails, and prints as null
        if not math.isfinite(c["value"]):
            c["value"] = None
    bench = bench or manifest()
    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if m.get("workloads") is not None and name not in m["workloads"]:
            continue
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted * run.units_per_update,
           "failed": failed * run.units_per_update, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["check_s"] = check_s
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be positive")
    bench = manifest()
    cell = Cell.find(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}: no result",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", bench=bench)
    bad = forbidden_loaded()
    if bad:
        print(f"the process holds {', '.join(bad)} after the window: no result", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
