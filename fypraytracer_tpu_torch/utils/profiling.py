"""Profiling & observability.

The torch counterpart of ``fypraytracer_tpu/utils/profiling.py``.  The
reference only has wall-clock frame timing with a running average
(Walnut::Timer around Renderer::Render, WalnutApp.cpp:880-897, average at
:782-785) and no device-side profiling (SURVEY.md §5).  Here:

  * ``FrameTimer`` — the same running-average protocol; with a CUDA
    ``device`` it waits for the card before each reading of the clock, so
    a frame's time holds its kernels, not only their launches;
  * the port's spans — ``(name, start_ns, end_ns, parent)`` on
    ``time.perf_counter_ns`` in one bounded in-memory buffer (``spans()``,
    ``clear()``, ``TRACER.dropped``):

      - ``setup_span(name)``: work done once a process or a scene (kernel
        libraries, scene compilation, upload), always recorded;
      - ``span(name)``: hot-path work (an entry point's call and its
        phases), recorded only while tracing is on: while a
        ``torch.profiler`` session records, or inside a ``tracing()``
        block.  Off, it costs one flag test and returns a shared no-op.

    Neither is a ``record_function`` or NVTX range: such a range is also
    drawn on the profiler's device timeline, where a reader of the card's
    kernels would count it as busy time;
  * ``to_timeline`` — the spans on another clock (a profiler's), each
    shifted by the median offset of the instants read on both nearest it;
  * ``device_trace`` — a ``torch.profiler`` capture of the CPU and, on a
    GPU, the card's timeline, written as a Chrome/Perfetto trace with the
    port's spans merged in on the profiler's timeline.  The CLI's
    ``render --trace-dir DIR`` writes one of a whole render.

The spans, by module:

  ============================  =======================================  =====
  name                          where                                    class
  ============================  =======================================  =====
  ``kernels.load``              ``ops/kernels.py::load``, a library's    setup
                                first load; children ``kernels.hash``,
                                ``kernels.nvcc`` (a build),
                                ``kernels.dlopen``
  ``kernels.first_launch``      the first call of each C entry           setup
  ``native.load``               ``accel/native.py``: g++ build and load  setup
  ``scene.compile``             ``SceneBuilder.compile``; children       setup
                                ``scene.bvh``, ``scene.light_tree``,
                                ``scene.tex``, ``scene.wide``
  ``scene.morton``              ``morton_permuted_scene``                setup
  ``scene.upload``              ``Scene.to``                             setup
  ``mk.call``                   ``MegakernelRenderer.render_many``;      hot
                                children ``mk.poll``, ``k2.prepare``,
                                ``k2.launch``, ``mk.accumulate``
  ============================  =======================================  =====
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import statistics
import time
import typing

import torch
from torch.autograd import profiler as _autograd_profiler

# the name of device_trace's clock marks, the one record_function it opens
CLOCK_MARK = "fyp.clock_mark"


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


class Span(typing.NamedTuple):
    """One recorded span; ``end_ns`` is None while it is open, ``parent``
    the index in ``spans()`` of the innermost recorded span open when it
    opened, or None.  The port's entry points run on one thread."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None


class Tracer:
    """The bounded buffer of spans.  A span opened while the buffer holds
    ``capacity`` is dropped and counted (``dropped``; ``first_drop_ns``
    is when the first was opened); its children take the nearest recorded
    span as parent."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self.forced = 0                 # open tracing() blocks
        self.dropped = 0
        self.first_drop_ns: int | None = None
        self._records: list[list] = []  # [name, start_ns, end_ns, parent record]
        self._open: list[list] = []     # the recorded spans open now, innermost last

    def open(self, name: str) -> list | None:
        t0 = time.perf_counter_ns()
        if len(self._records) >= self.capacity:
            self.dropped += 1
            if self.first_drop_ns is None:
                self.first_drop_ns = t0
            return None
        rec = [name, t0, None, self._open[-1] if self._open else None]
        self._records.append(rec)
        self._open.append(rec)
        return rec

    def close(self, rec: list | None) -> None:
        if rec is None:
            return
        rec[2] = time.perf_counter_ns()
        stack = self._open
        for i in range(len(stack) - 1, -1, -1):     # the top, unless spans closed out of order
            if stack[i] is rec:
                del stack[i]
                break

    def spans(self) -> list[Span]:
        index = {id(r): i for i, r in enumerate(self._records)}
        return [Span(n, s, e, None if p is None else index.get(id(p))) for n, s, e, p in self._records]

    def clear(self) -> None:
        """Forget every span and drop; spans open now are not recorded
        when they close."""
        self._records = []
        self._open = []
        self.dropped = 0
        self.first_drop_ns = None


TRACER = Tracer()


class _Open:
    """The context of one span to record."""

    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = TRACER.open(self.name)
        return self

    def __exit__(self, *exc):
        TRACER.close(self.rec)
        return False


_NOOP = contextlib.nullcontext()


def span(name: str):
    """A hot-path span: recorded while tracing is on, else a shared no-op."""
    if TRACER.forced or _autograd_profiler._is_profiler_enabled:
        return _Open(name)
    return _NOOP


def setup_span(name: str):
    """A set-up span: always recorded."""
    return _Open(name)


def setup_spanned(name: str):
    """Decorator: every call of the function is a set-up span."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with setup_span(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


@contextlib.contextmanager
def tracing():
    """Record hot-path spans inside the block, with or without a profiler."""
    TRACER.forced += 1
    try:
        yield
    finally:
        TRACER.forced -= 1


def spans() -> list[Span]:
    """Every span recorded since the last ``clear()``, in order of opening."""
    return TRACER.spans()


def clear() -> None:
    TRACER.clear()


# the pairs whose median offset places a span: the nearest ones, since the
# profiler's clock (a cycle counter scaled to wall time) and perf_counter
# drift apart over seconds
NEAREST_PAIRS = 5


def to_timeline(spans_: list[Span], pairs) -> list[tuple]:
    """The closed spans as ``(name, start_us, end_us, parent)`` on another
    clock.  ``pairs`` holds ``(perf_counter_ns, timeline_us)`` readings of
    the same instants on both clocks; each span is shifted by the median
    offset of the ``NEAREST_PAIRS`` pairs read nearest its start.  Raises
    on no pairs."""
    pairs = sorted(pairs)
    if not pairs:
        raise ValueError("to_timeline: no instant known on both clocks")
    host = [ns for ns, _ in pairs]
    offsets = [t_us - ns / 1e3 for ns, t_us in pairs]
    k = min(NEAREST_PAIRS, len(pairs))
    out = []
    for s in spans_:
        if s.end_ns is None:
            continue
        i = bisect.bisect_left(host, s.start_ns)
        lo, hi = i, i              # grow [lo, hi) to the k pairs nearest the start
        while hi - lo < k:
            if lo > 0 and (hi == len(host) or s.start_ns - host[lo - 1] <= host[hi] - s.start_ns):
                lo -= 1
            else:
                hi += 1
        off = statistics.median(offsets[lo:hi])
        out.append((s.name, s.start_ns / 1e3 + off, s.end_ns / 1e3 + off, s.parent))
    return out


def _clock_mark() -> int:
    """A ``CLOCK_MARK`` range on the profiler's timeline; returns the
    ``perf_counter_ns`` read as it opened."""
    t = time.perf_counter_ns()
    with torch.profiler.record_function(CLOCK_MARK):
        pass
    return t


# the track of the port's spans in trace.json
_SPAN_TID = 0xF1F


@contextlib.contextmanager
def device_trace(logdir: str, device=None):
    """Capture a profile of the block into ``logdir/trace.json`` (view with
    Perfetto or chrome://tracing), with every port span opened inside the
    block as a complete event on the profiler's timeline, on a track of
    its own.  The CUDA activity is traced when ``device`` is a GPU (by
    default: when torch sees a card).  Yields the profiler, whose
    ``key_averages()`` tables the kernels.

    The spans are placed by clock marks, ``record_function`` ranges (the
    only ones the port opens; outside the benchmark's traces) opened five
    times at the block's start and five at its end, each paired with the
    ``perf_counter_ns`` read as it opened: a span takes the marks at the
    end nearer it, their median leaving out the first mark's one-time
    set-up."""
    from torch.profiler import ProfilerActivity, profile

    cuda = _is_cuda(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    t0 = time.perf_counter_ns()
    with profile(activities=activities) as prof:
        marks = [_clock_mark() for _ in range(NEAREST_PAIRS)]
        yield prof
        if cuda:
            torch.cuda.synchronize()
        marks += [_clock_mark() for _ in range(NEAREST_PAIRS)]
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    stamps = sorted(float(e["ts"]) for e in events if e.get("name") == CLOCK_MARK and e.get("ph") == "X"
                    and e.get("cat") != "gpu_user_annotation")
    if len(stamps) != len(marks):
        raise RuntimeError(f"device_trace: {len(stamps)} clock marks in the trace, {len(marks)} made")
    every = spans()
    mine = [s for s in every if s.start_ns >= t0]
    pid = os.getpid()
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": _SPAN_TID,
                   "args": {"name": "fypraytracer_tpu_torch spans"}})
    for name, s, e, parent in to_timeline(mine, zip(marks, stamps)):
        events.append({"ph": "X", "cat": "port_span", "name": name, "pid": pid, "tid": _SPAN_TID, "ts": s,
                       "dur": e - s, "args": {"parent": None if parent is None else every[parent].name}})
    with open(path, "w") as f:
        json.dump(trace, f)
