"""The traced run's reading of ``torch.profiler``.

The profiler records the card's work and the benchmark's own host spans
(``record_function`` ranges named as ``Recorder`` names them) on one
timeline.  From it: the traced window (the first update's start to the
closing synchronize's end), the seconds in which the card worked (the
union of the intervals of its kernels, copies and memsets inside the
window), each one's launches and time, and the device's idle gaps, each
named by the innermost benchmark span the host was in when the gap began.

The events are read from the profiler's exported trace (a file under the
run's ``TMPDIR``, removed once read), where each carries its category
(``cat``), which the profiler's Python events do not give in every
release of torch.  The card's work is told apart by that category, never
by its name: a ``record_function`` range that the benchmark or the program
opens is drawn on the device's timeline too (``gpu_user_annotation``),
over the kernels it encloses and the gaps between them, and is no work of
the card.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import os
import tempfile

DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")    # the categories of the card's own work
HOST_RANGE = "user_annotation"                          # a record_function range on the host


def start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


@dataclasses.dataclass
class Trace:
    kernels: list        # (name, start_us, end_us), the card's work (DEVICE_WORK) inside the window
    spans: list          # (name, start_us, end_us), the benchmark's host spans
    window_us: tuple

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def busy_intervals(self) -> list:
        out = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_times(self, pattern: str) -> list:
        """Durations in seconds of the kernels whose name holds ``pattern``."""
        return [(e - s) / 1e6 for n, s, e in self.kernels if pattern in n]

    def gaps(self) -> list:
        """(start_us, end_us) of the window's idle stretches."""
        out, t = [], self.window_us[0]
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window_us[1] > t:
            out.append((t, self.window_us[1]))
        return out

    def host_spans_at(self, points_us: list) -> list:
        """For each of the ascending ``points_us``, the name of the innermost
        (latest opened) benchmark span the host was in: one sweep, since a
        training window holds some ten thousand gaps and spans."""
        order = sorted(self.spans, key=lambda sp: sp[1])
        active: list = []             # (-start, end, name): the latest opened on top
        out, i = [], 0
        for t in points_us:
            while i < len(order) and order[i][1] <= t:
                heapq.heappush(active, (-order[i][1], order[i][2], order[i][0]))
                i += 1
            while active and active[0][1] <= t:       # ended before t: never open again
                heapq.heappop(active)
            out.append(active[0][2] if active else "outside the benchmark's spans")
        return out

    def breakdown(self) -> dict:
        by_op: dict = {}
        for n, s, e in self.kernels:
            by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
        by_span: dict = {}
        gaps = self.gaps()
        for (s, e), name in zip(gaps, self.host_spans_at([s for s, _ in gaps])):
            by_span[name] = by_span.get(name, 0.0) + (e - s) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], v] for n, v in top], "idle_gaps": [[n, v] for n, v in gaps]}


def trace_events(prof) -> list:
    """The profiler's complete events (``ph`` "X") as its exported trace has them."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def read_profile(prof, rec) -> Trace:
    names = {n for n, _, _ in rec.spans}      # whatever spans the entry recorded
    kernels, spans = [], []
    for e in trace_events(prof):
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_WORK:
            kernels.append((e["name"], start, end))
        elif e.get("cat") == HOST_RANGE and e["name"] in names:
            spans.append((e["name"], start, end))
    if spans:
        window = (min(s for _, s, _ in spans), max(e for _, _, e in spans))
    else:
        window = (0.0, 0.0)
    inside = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in kernels if e > window[0] and s < window[1]]
    return Trace(kernels=inside, spans=spans, window_us=window)
