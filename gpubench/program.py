"""The program's own spans (``fypraytracer_tpu_torch/utils/profiling.py``),
read after a run for the per-layer metrics that look inside the port.

The port records ``(name, start_ns, end_ns, parent)`` on
``time.perf_counter_ns``, the clock of the benchmark's ``Recorder``:
set-up spans always (``kernels.load``, ``native.load``,
``kernels.first_launch``, ``scene.*``), hot-path spans only while a
profiler records (``mk.call`` and, inside it, ``mk.poll``, ``k2.prepare``,
``k2.launch``, ``mk.accumulate``).  So set-up is read from any run, and
the window's calls from a traced one.  No entry's span names are listed
here: an entry's call is the outermost port span opened inside the
benchmark's call span (``CALL_SPAN``), and its launch that call's child
named ``*.launch``.  The spans are put on the profiler's timeline by the
port's ``to_timeline``, paired through the entry's call span, which both
clocks know: the ``Recorder``'s on the host, the trace's (a
``record_function`` range) on the profiler's.

Every reading is None where the program keeps no such spans (a port
without them), or where its buffer dropped a span opened before the end
of the stretch read.

    python3 gpubench/program.py --workload <cell> --seed <n> --seconds <s>

runs the cell once, traced, and prints its result line's metrics and a
split of its set-up and of each call's host and idle time by span.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys

LIBS = ("kernels.load", "native.load", "kernels.first_launch")


def port_profiling():
    """The port's profiling module, or None where it keeps no spans."""
    try:
        from fypraytracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, n) for n in ("spans", "to_timeline", "TRACER")):
        return None
    return profiling


def spans_before(t1_s: float):
    """The port's spans (all of them, in order of opening), or None where
    there are none or the buffer dropped a span opened before ``t1_s``
    (``perf_counter`` seconds)."""
    prof = port_profiling()
    if prof is None:
        return None
    first_drop = prof.TRACER.first_drop_ns
    if first_drop is not None and first_drop < t1_s * 1e9:
        return None
    return prof.spans() or None


def union_s(intervals) -> float:
    """Seconds covered by the ``(start, end)`` intervals, in seconds."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def setup_start(run) -> float:
    """The run's start, ``perf_counter`` seconds: ``setup_s`` before the end
    of the benchmark's last span of set-up, where ``setup_s`` is read (the
    profiler of a traced run starts after it, before the window)."""
    ends = [e for _, _, e in run.rec.spans if e <= run.window[0]]
    return (max(ends) if ends else run.window[0]) - run.setup_s


def setup_spans(run):
    """The port's closed spans opened in set-up."""
    spans = spans_before(run.window[0])
    if spans is None:
        return None
    t0, t1 = setup_start(run) * 1e9, run.window[0] * 1e9
    return [s for s in spans if t0 <= s.start_ns < t1 and s.end_ns is not None]


def setup_in_port_s(run):
    got = setup_spans(run)
    if got is None:
        return None
    sel = [(s.start_ns / 1e9, s.end_ns / 1e9) for s in got if s.parent is None]
    return union_s(sel) if sel else None


def libs_s(run):
    got = setup_spans(run)
    if got is None:
        return None
    sel = [(s.start_ns / 1e9, s.end_ns / 1e9) for s in got if s.name in LIBS]
    return union_s(sel) if sel else None


def window_calls(run):
    """``(spans, calls, inside)``: the port's spans, the indices of the
    call spans of the window (in each of the benchmark's ``CALL_SPAN``
    spans, the first outermost port span opened in it), and of every span
    inside one of them (the calls included); None where the window holds
    no such call."""
    spans = spans_before(run.window[1])
    if spans is None:
        return None
    tops = [(s.start_ns, i) for i, s in enumerate(spans) if s.parent is None and s.end_ns is not None]
    tops.sort()
    calls = []
    for n, b0, b1 in run.rec.spans:
        if n != run.call_span or not run.window[0] <= b0 < run.window[1]:
            continue
        j = bisect.bisect_left(tops, (b0 * 1e9, -1))
        if j < len(tops) and tops[j][0] <= b1 * 1e9:
            calls.append(tops[j][1])
    if not calls:
        return None
    inside = set(calls)
    for i, s in enumerate(spans):          # a parent opens before its children
        if s.parent in inside:
            inside.add(i)
    return spans, calls, inside


def prelaunch_ms(run):
    """Mean over the window's calls of (end of the call's launch span, its
    child named ``*.launch``, − the call's start), in ms; None where no
    call launched."""
    got = window_calls(run)
    if got is None:
        return None
    spans, calls, _ = got
    ends = {s.parent: s.end_ns for s in spans if s.name.endswith(".launch") and s.end_ns is not None}
    sel = [(ends[c] - spans[c].start_ns) / 1e6 for c in calls if c in ends]
    return sum(sel) / len(sel) if sel else None


def mapped_window(run):
    """The window's port spans on the profiler's timeline, ``(name,
    start_us, end_us, parent)``, and the number of calls; None without a
    trace holding kernels, or where the entry's call spans on the two
    clocks do not pair one to one."""
    tr = run.trace
    prof = port_profiling()
    got = window_calls(run)
    if tr is None or not tr.kernels or prof is None or got is None:
        return None
    spans, calls, inside = got
    host = sorted(s for n, s, _ in run.rec.spans if n == run.call_span and run.window[0] <= s < run.window[1])
    prof_starts = sorted(s for n, s, _ in tr.spans if n == run.call_span)
    if not host or len(host) != len(prof_starts):
        return None
    pairs = [(round(h * 1e9), p) for h, p in zip(host, prof_starts)]
    return prof.to_timeline([spans[i] for i in sorted(inside)], pairs), len(calls)


def idle_by_span(gaps, mapped) -> dict:
    """Seconds of the ``gaps`` (``(start_us, end_us)``) under each span
    name, each microsecond put down to the innermost of the ``mapped``
    spans (properly nested, ``(name, start_us, end_us, parent)``) that
    covers it; the part under none under None."""
    events = []
    for i, (_, s, e, _) in enumerate(mapped):
        events += [(s, 1, i), (e, 0, i)]
    for s, e in gaps:
        events += [(s, 1, -1), (e, 0, -1)]
    events.sort()
    out: dict = {}
    stack, in_gap, prev = [], 0, None
    for t, opens, i in events:
        if in_gap and prev is not None and t > prev:
            name = mapped[stack[-1]][0] if stack else None
            out[name] = out.get(name, 0.0) + (t - prev) / 1e6
        prev = t
        if i < 0:
            in_gap += 1 if opens else -1
        elif opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    return out


def idle_in_port_ms(run):
    """The device's idle time inside the window's port spans, ms a call."""
    got = mapped_window(run)
    if got is None:
        return None
    mapped, n_calls = got
    idle = idle_by_span(run.trace.gaps(), mapped)
    return sum(v for k, v in idle.items() if k is not None) * 1e3 / n_calls


def call_split(run) -> dict | None:
    """Per span name, ms a call: its time (``host``), its time less its
    children's (``self``), and the device's idle time under it, innermost
    (``idle``); the idle time under no port span is under
    ``"outside the port"``."""
    got = window_calls(run)
    if got is None:
        return None
    spans, calls, inside = got
    n = len(calls)
    out: dict = {}
    child: dict = {}
    for i in inside:
        s = spans[i]
        if s.end_ns is None:
            continue
        row = out.setdefault(s.name, {"host": 0.0, "self": 0.0, "idle": 0.0})
        row["host"] += (s.end_ns - s.start_ns) / 1e6 / n
        if s.parent is not None:
            child[s.parent] = child.get(s.parent, 0) + s.end_ns - s.start_ns
    for i in inside:
        s = spans[i]
        if s.end_ns is not None:
            out[s.name]["self"] += (s.end_ns - s.start_ns - child.get(i, 0)) / 1e6 / n
    mapped = mapped_window(run)
    if mapped is not None:
        for name, secs in idle_by_span(run.trace.gaps(), mapped[0]).items():
            key = "outside the port" if name is None else name
            out.setdefault(key, {"host": 0.0, "self": 0.0, "idle": 0.0})["idle"] += secs * 1e3 / n
    return out


def setup_split(run) -> dict | None:
    """Seconds of set-up per port span name (summed) and per span of the
    benchmark's own."""
    sel = setup_spans(run)
    if sel is None:
        return None
    out = {"setup_s": run.setup_s, "in_port_s": setup_in_port_s(run), "libs_s": libs_s(run), "port": {},
           "benchmark": {}}
    for s in sel:
        out["port"][s.name] = out["port"].get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    for n, s, e in run.rec.spans:
        if s < run.window[0]:
            out["benchmark"][n] = out["benchmark"].get(n, 0.0) + e - s
    return out


def clock_drift_us(run, n: int = 50):
    """How far the two clocks drift over the window: the median offset
    (profiler − host) of the first and of the last ``n`` call pairs, less
    the median of all, in µs."""
    import statistics

    if run.trace is None:
        return None
    host = sorted(s for m, s, _ in run.rec.spans if m == run.call_span and run.window[0] <= s < run.window[1])
    prof = sorted(s for m, s, _ in run.trace.spans if m == run.call_span)
    if len(host) != len(prof) or len(host) < 2 * n:
        return None
    off = [p - h * 1e6 for h, p in zip(host, prof)]
    mid = statistics.median(off)
    return {"first": statistics.median(off[:n]) - mid, "last": statistics.median(off[-n:]) - mid}


def main(argv=None) -> int:
    import os
    import time

    ap = argparse.ArgumentParser(description="one traced run of a cell, its set-up and calls split by span")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from gpubench import run as bench        # the run's clock starts here (``T_START``)

    # set-up's first steps, timed here in its place: they are done once a process
    steps = {}
    t = time.perf_counter()
    import torch

    steps["import torch"] = time.perf_counter() - t
    if not torch.cuda.is_available():
        print("no CUDA device: no result", file=sys.stderr)
        return 2
    t = time.perf_counter()
    torch.empty(1, device="cuda")
    steps["CUDA context"] = time.perf_counter() - t
    t = time.perf_counter()
    import fypraytracer_tpu_torch.render.megakernel  # noqa: F401
    import gpubench.reference.nee  # noqa: F401

    steps["imports of the port and the reference"] = time.perf_counter() - t
    runs = []
    measure = bench.measure

    def keep(run, *a, **k):
        runs.append(run)
        return measure(run, *a, **k)

    bench.measure = keep
    out = bench.run_cell(args.workload, args.seed, args.seconds, True, "cuda")
    run = runs[0]
    setup = setup_split(run)
    if setup is not None:
        setup["first_steps"] = steps
    print(json.dumps({"workload": args.workload, "seed": args.seed, "correct": out["correct"],
                      "device": out["device"], "metrics": out["metrics"], "breakdown": out.get("breakdown"),
                      "clock": clock_drift_us(run), "calls": call_split(run), "setup": setup}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
