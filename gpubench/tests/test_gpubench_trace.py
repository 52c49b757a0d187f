"""The traced run's reader counts the card's work by each event's category:
kernels, copies and memsets, and never a ``record_function`` range drawn on
the device's timeline, whoever opened it."""

import json

import pytest

from gpubench import trace
from gpubench.run import Recorder


class ExportingProfiler:
    """Stands in for ``torch.profiler.profile`` after its window: exports
    the given events as its trace."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def ev(cat, name, ts, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


def recorder():
    rec = Recorder()
    rec.spans = [("render_many", 0.0, 1.0), ("synchronize", 1.0, 2.0)]
    return rec


EVENTS = [
    ev("user_annotation", "render_many", 100.0, 100.0),          # the benchmark's host spans
    ev("user_annotation", "synchronize", 200.0, 100.0),
    ev("user_annotation", "mk.call", 105.0, 50.0),               # a host range that is no benchmark span
    ev("gpu_user_annotation", "render_many", 110.0, 180.0),      # the same ranges on the device's timeline
    ev("gpu_user_annotation", "k2.launch", 120.0, 160.0),
    ev("gpu_memset", "Memset (Device)", 50.0, 55.0),             # begins before the window
    ev("kernel", "frames_kernel<5, false>", 120.0, 130.0),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 260.0, 10.0),
    ev("kernel", "after the window", 400.0, 100.0),
    ev("cuda_runtime", "cudaLaunchKernel", 115.0, 3.0),
    ev("cpu_op", "aten::empty", 106.0, 1.0),
    ev("Trace", "PyTorch Profiler (0)", 0.0, 1000.0),
    {"ph": "i", "cat": "kernel", "name": "an instant", "ts": 150.0, "pid": 1, "tid": 1},
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python"}},
]


def test_only_kernels_copies_and_memsets_are_the_card_s_work():
    tr = trace.read_profile(ExportingProfiler(EVENTS), recorder())
    assert tr.window_us == (100.0, 300.0)
    assert sorted(tr.spans) == [("render_many", 100.0, 200.0), ("synchronize", 200.0, 300.0)]
    assert tr.kernels == [("Memset (Device)", 100.0, 105.0), ("frames_kernel<5, false>", 120.0, 250.0),
                          ("Memcpy DtoH (Device -> Pinned)", 260.0, 270.0)]
    assert tr.busy_s == pytest.approx((5 + 130 + 10) / 1e6)
    assert tr.gaps() == [(105.0, 120.0), (250.0, 260.0), (270.0, 300.0)]


def test_a_range_on_the_device_s_timeline_is_never_busy_time():
    """A range the program opens around its launch (``k2.launch``) would,
    read as work, cover the gaps on either side of the kernel."""
    ranges = [e for e in EVENTS if e.get("cat") != "kernel" or e["name"] != "frames_kernel<5, false>"]
    tr = trace.read_profile(ExportingProfiler(ranges), recorder())
    assert [n for n, _, _ in tr.kernels] == ["Memset (Device)", "Memcpy DtoH (Device -> Pinned)"]
    assert tr.busy_s == pytest.approx(15 / 1e6)


def test_a_trace_without_the_benchmark_s_spans_has_no_window():
    tr = trace.read_profile(ExportingProfiler([e for e in EVENTS if e.get("cat") != "user_annotation"]),
                            recorder())
    assert tr.window_us == (0.0, 0.0) and tr.kernels == [] and tr.spans == []


def test_each_gap_is_put_down_to_the_innermost_span():
    """The sweep names each point by the latest opened span covering it, as
    a scan over every span does, on nested spans and gaps between them."""
    import random

    rng = random.Random(5)
    spans = []
    for k in range(300):              # calls of 0-40 us, each holding a child, some 50 us apart
        s = k * 50.0 + rng.random() * 5
        e = s + rng.random() * 40
        spans.append(("call", s, e))
        spans.append(("launch", s + 0.3 * (e - s), s + 0.6 * (e - s)))
    spans.append(("window", -1.0, 20000.0))
    points = sorted(rng.random() * 16000 for _ in range(2000))
    tr = trace.Trace(kernels=[], spans=spans, window_us=(0.0, 16000.0))

    def scan(t):
        inner = max((sp for sp in spans if sp[1] <= t < sp[2]), key=lambda sp: sp[1], default=None)
        return inner[0] if inner else "outside the benchmark's spans"
    assert tr.host_spans_at(points) == [scan(t) for t in points]
    assert trace.Trace(kernels=[], spans=[], window_us=(0.0, 1.0)).host_spans_at([0.5]) == [
        "outside the benchmark's spans"]
