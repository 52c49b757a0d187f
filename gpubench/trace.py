"""The traced run's reading of ``torch.profiler``.

The profiler records the card's kernels and the benchmark's own host spans
(``record_function`` ranges named as ``Recorder`` names them) on one
timeline.  From it: the traced window (the first update's start to the
closing synchronize's end), the seconds in which any kernel ran (the
union of the kernels' intervals inside the window), each kernel's
launches and time, and the device's idle gaps, each named by the
innermost benchmark span the host was in when the gap began.
"""

from __future__ import annotations

import dataclasses

def start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


@dataclasses.dataclass
class Trace:
    kernels: list        # (name, start_us, end_us), inside the window
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

    def host_span_at(self, t_us: float) -> str:
        inner = None
        for n, s, e in self.spans:
            if s <= t_us < e and (inner is None or s >= inner[1]):
                inner = (n, s)
        return inner[0] if inner else "outside the benchmark's spans"

    def breakdown(self) -> dict:
        by_op: dict = {}
        for n, s, e in self.kernels:
            by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
        by_span: dict = {}
        for s, e in self.gaps():
            name = self.host_span_at(s)
            by_span[name] = by_span.get(name, 0.0) + (e - s) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], v] for n, v in top], "idle_gaps": [[n, v] for n, v in gaps]}


def read_profile(prof, rec) -> Trace:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    names = {n for n, _, _ in rec.spans}      # whatever spans the entry recorded
    kernels, spans = [], []
    for e in prof.events():
        if e.name in names:
            # a record_function range is also drawn on the device's timeline,
            # over its kernels and the gaps between them: it is no kernel
            if e.device_type != cuda:
                spans.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type == cuda:
            kernels.append((e.name, e.time_range.start, e.time_range.end))
    if spans:
        window = (min(s for _, s, _ in spans), max(e for _, _, e in spans))
    else:
        window = (0.0, 0.0)
    inside = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in kernels if e > window[0] and s < window[1]]
    return Trace(kernels=inside, spans=spans, window_us=window)
