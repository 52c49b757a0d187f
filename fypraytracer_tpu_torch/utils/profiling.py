"""Profiling & observability.

The torch counterpart of ``fypraytracer_tpu/utils/profiling.py``.  The
reference only has wall-clock frame timing with a running average
(Walnut::Timer around Renderer::Render, WalnutApp.cpp:880-897, average at
:782-785) and no device-side profiling (SURVEY.md §5).  Here:

  * ``FrameTimer`` — the same running-average protocol; with a CUDA
    ``device`` it waits for the card before each reading of the clock, so
    a frame's time holds its kernels, not only their launches;
  * ``RaysCounter`` — rays/s accounting (BASELINE.md metric);
  * ``device_trace`` — a ``torch.profiler`` capture of the CPU and, on a
    GPU, the card's timeline, written as a Chrome/Perfetto trace;
  * ``log_event`` — structured JSONL logging (the reference logs by
    encoding metadata into output filenames).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time

import torch


def _is_cuda(device) -> bool:
    """Whether ``device`` is a CUDA device; None: whether torch sees a card."""
    return torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"


class FrameTimer:
    """Per-frame wall time + running average (WalnutApp.cpp:782-785).
    ``device``: the device the frames run on (by default the card, where
    torch sees one); a CUDA device is synchronized before the clock is read
    at a frame's start and end."""

    def __init__(self, device=None):
        self.sync = functools.partial(torch.cuda.synchronize, device) if _is_cuda(device) else (lambda: None)
        self.total_s = 0.0
        self.frames = 0
        self.last_ms = 0.0

    @contextlib.contextmanager
    def frame(self):
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        dt = time.perf_counter() - t0
        self.last_ms = dt * 1000.0
        self.total_s += dt
        self.frames += 1

    @property
    def avg_ms(self) -> float:
        return (self.total_s / self.frames * 1000.0) if self.frames else 0.0

    @property
    def total_minutes(self) -> float:
        return self.total_s / 60.0


class RaysCounter:
    """Accumulates traced-ray counts; reports rays/s."""

    def __init__(self):
        self.rays = 0

    def add_frame(self, width: int, height: int, samples: int, bounces: int,
                  shadow_rays_per_bounce: int = 0):
        self.rays += width * height * samples * (1 + bounces * (1 + shadow_rays_per_bounce))

    def rays_per_second(self, elapsed_s: float) -> float:
        return self.rays / max(elapsed_s, 1e-12)


@contextlib.contextmanager
def device_trace(logdir: str, device=None):
    """Capture a profile of the block into ``logdir/trace.json`` (view with
    Perfetto or chrome://tracing).  The CUDA activity is traced when
    ``device`` is a GPU (by default: when torch sees a card).  Yields the
    profiler, whose ``key_averages()`` tables the kernels."""
    from torch.profiler import ProfilerActivity, profile

    cuda = _is_cuda(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def log_event(path: str, **fields) -> None:
    """Append one structured JSONL record."""
    fields.setdefault("ts", time.time())
    with open(path, "a") as f:
        f.write(json.dumps(fields, default=str) + "\n")
