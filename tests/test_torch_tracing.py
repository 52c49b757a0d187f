"""The port's spans (``utils/profiling.py``): hot-path spans only while
tracing is on, set-up spans always, the bounded buffer, the spans the
entry points and builders emit, and their mapping onto a profiler's
timeline.  CPU, except the one test marked ``requires_cuda``."""

import ctypes
import ctypes.util
import json

import pytest
import torch

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.ops import kernels
from fypraytracer_tpu_torch.render.megakernel import MegakernelRenderer, morton_permuted_scene
from fypraytracer_tpu_torch.scene.procedural import cornell_box
from fypraytracer_tpu_torch.utils import profiling

MK_SPANS = {"mk.call", "mk.poll", "mk.accumulate"}


@pytest.fixture
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def names(spans):
    return [s.name for s in spans]


def nee():
    return RenderSettings(technique=SamplingTechnique.NEE_MIS, bounces=2, samples=1)


def test_hot_spans_only_while_tracing(fresh):
    assert not torch.autograd.profiler._is_profiler_enabled
    for _ in range(100):
        with profiling.span("t.off"):
            pass
    assert profiling.spans() == []
    assert profiling.span("t.off") is profiling.span("t.other")      # the one shared no-op
    with profiling.tracing():
        with profiling.span("t.outer"):
            with profiling.span("t.inner"):
                pass
    with profiling.span("t.off"):
        pass
    got = profiling.spans()
    assert names(got) == ["t.outer", "t.inner"]
    outer, inner = got
    assert outer.parent is None and inner.parent == 0
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_tracing_turns_on_inside_a_profiler(fresh):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("t.profiled"):
            pass
    with profiling.span("t.after"):
        pass
    assert names(profiling.spans()) == ["t.profiled"]


def test_setup_spans_always_and_the_builders_emit_theirs(fresh):
    builder, cam = cornell_box(width=16, height=8)
    scene = builder.compile()
    morton_permuted_scene(scene)
    scene.to("cpu")
    got = profiling.spans()
    assert names(got)[:5] == ["scene.compile", "scene.bvh", "scene.light_tree", "scene.tex", "scene.wide"]
    assert [got[s.parent].name for s in got[1:5]] == ["scene.compile"] * 4
    assert names(got)[5:] == ["scene.morton", "scene.upload"]
    assert all(s.parent is None for s in got[5:]) and got[0].parent is None


def test_the_buffer_is_bounded_and_counts_what_it_drops():
    tracer = profiling.Tracer(capacity=3)
    recs = [tracer.open(f"s{i}") for i in range(5)]
    for rec in reversed(recs):
        tracer.close(rec)
    assert names(tracer.spans()) == ["s0", "s1", "s2"]
    assert tracer.dropped == 2 and tracer.first_drop_ns >= tracer.spans()[2].start_ns
    tracer.clear()
    assert tracer.spans() == [] and tracer.dropped == 0 and tracer.first_drop_ns is None


def test_first_call_of_an_entry_is_a_setup_span(fresh, monkeypatch):
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to load")
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "build", lambda name: libc)
    fn = kernels.load("libc", "abs", [ctypes.c_int])
    assert names(profiling.spans()) == ["kernels.load", "kernels.dlopen"]
    assert fn(-3) == 3 and fn(-4) == 4 and kernels.load("libc", "abs", [ctypes.c_int])(-5) == 5
    got = profiling.spans()
    assert names(got) == ["kernels.load", "kernels.dlopen", "kernels.first_launch"]
    assert got[2].parent is None and got[1].parent == 0


def test_later_launches_call_the_bare_entry(fresh, monkeypatch):
    """After its first call an entry is looked up as the bare ctypes
    function: later launches pay nothing for the first launch's span."""
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to load")
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "build", lambda name: libc)
    first = kernels.load("libc", "abs", [ctypes.c_int])
    assert not isinstance(first, ctypes._CFuncPtr) and first(-2) == 2
    bare = kernels.load("libc", "abs", [ctypes.c_int])
    assert isinstance(bare, ctypes._CFuncPtr) and bare is kernels.load("libc", "abs", [ctypes.c_int])
    assert bare.restype is ctypes.c_int and tuple(bare.argtypes) == (ctypes.c_int,) and bare(-7) == 7
    assert names(profiling.spans()).count("kernels.first_launch") == 1


def test_render_many_emits_its_spans_on_the_cpu(fresh):
    builder, cam = cornell_box(width=16, height=8)
    mk = MegakernelRenderer(builder.compile(), cam, nee(), device="cpu")
    mk.render_many(1)
    assert not MK_SPANS & set(names(profiling.spans()))
    with profiling.tracing():
        mk.render_many(2)
    got = profiling.spans()
    call = [i for i, s in enumerate(got) if s.name == "mk.call"]
    assert len(call) == 1
    inside = [s.name for s in got if s.parent == call[0]]
    assert inside == ["mk.poll", "mk.accumulate"]           # the plain path launches nothing


def test_render_many_frees_its_frames_before_the_average(monkeypatch):
    """The spans split the accumulation from the launch without keeping the
    launch's frames alive while the average is allocated (a whole image
    more at the peak)."""
    import weakref

    from fypraytracer_tpu_torch.render import megakernel as mk

    builder, cam = cornell_box(width=8, height=4)
    renderer = MegakernelRenderer(builder.compile(), cam, nee(), device="cpu")
    frames, alive = [], []
    launch, divide = mk.megakernel, torch.Tensor.__truediv__

    def spied_launch(*args, **kwargs):
        out = launch(*args, **kwargs)
        frames.append(weakref.ref(out))
        return out

    def spied_divide(self, other):
        if self is renderer.accum:
            alive.append(frames[-1]() is not None)
        return divide(self, other)

    monkeypatch.setattr(mk, "megakernel", spied_launch)
    monkeypatch.setattr(torch.Tensor, "__truediv__", spied_divide)
    with profiling.tracing():
        renderer.render_many(1)
    renderer.render_many(1)
    assert alive == [False, False]


@pytest.mark.requires_cuda
def test_render_many_emits_k2_spans_on_a_card(fresh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    builder, cam = cornell_box(width=64, height=32)
    mk = MegakernelRenderer(builder.compile(), cam, nee(), device="cuda")
    mk.render_many(2)
    torch.cuda.synchronize()
    with profiling.tracing():
        mk.render_many(2)
    torch.cuda.synchronize()
    got = profiling.spans()
    call = [i for i, s in enumerate(got) if s.name == "mk.call"]
    assert len(call) == 1
    assert [s.name for s in got if s.parent == call[0]] == ["mk.poll", "k2.prepare", "k2.launch", "mk.accumulate"]
    assert "scene.upload" in names(got)


def test_the_clock_mapping_puts_an_op_inside_its_span(tmp_path, fresh):
    with profiling.device_trace(str(tmp_path), device="cpu"):
        with profiling.span("t.matmul"):
            (torch.ones(96, 96) @ torch.ones(96, 96)).sum()
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    mm = [e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    sp = [e for e in events if e.get("name") == "t.matmul" and e.get("cat") == "port_span"]
    assert len(mm) == 1 and len(sp) == 1
    mm, sp = mm[0], sp[0]
    assert sp["ts"] - 50 <= mm["ts"] and mm["ts"] + mm["dur"] <= sp["ts"] + sp["dur"] + 50


def test_device_trace_writes_the_port_spans(tmp_path, fresh):
    builder, cam = cornell_box(width=16, height=8)
    with profiling.device_trace(str(tmp_path), device="cpu"):
        mk = MegakernelRenderer(builder.compile(), cam, nee(), device="cpu")
        mk.render_many(1)
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    port = {e["name"]: e for e in events if e.get("cat") == "port_span"}
    assert {"scene.compile", "scene.bvh", "scene.upload"} | MK_SPANS <= set(port)
    assert port["scene.bvh"]["args"]["parent"] == "scene.compile"
    assert port["mk.poll"]["args"]["parent"] == "mk.call" and port["mk.call"]["args"]["parent"] is None
    assert all(e["dur"] >= 0 for e in port.values())


def test_to_timeline_takes_the_median_offset_of_the_nearest_pairs():
    spans = [profiling.Span("a", 1_000, 3_000, None), profiling.Span("open", 2_000, None, None)]
    # three instants read on both clocks, one of them late on the timeline
    got = profiling.to_timeline(spans, [(0, 10.0), (4_000, 14.0), (8_000, 30.0)])
    assert got == [("a", 11.0, 13.0, None)]
    with pytest.raises(ValueError):
        profiling.to_timeline(spans, [])
    # clocks drifting apart by 1e-4: a span takes the offset of the pairs around it
    pairs = [(t, t / 1e3 * (1 + 1e-4) + 500.0) for t in range(0, 20_000_000_000, 30_000_000)]
    late = profiling.Span("late", 19_000_000_000, 19_000_100_000, None)
    (_, s, e, _), = profiling.to_timeline([late], pairs)
    assert abs(s - (19_000_000.0 * (1 + 1e-4) + 500.0)) < 5.0 and e - s == pytest.approx(100.0)
