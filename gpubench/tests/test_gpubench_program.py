"""The readers of the port's own spans (``gpubench/program.py`` and its four
metrics) on a synthetic run: two closed-loop calls whose spans, kernels and
gaps are known to the microsecond, on a profiler clock 7 ms and 10 s off
the host's."""

import types

import pytest

from gpubench import program
from gpubench.run import Recorder, Run, load_module
from gpubench.trace import Trace
from fypraytracer_tpu_torch.utils.profiling import Span, to_timeline

T0 = 10.0                   # the window's start, host seconds
OFF_US = 7000 - T0 * 1e6    # profiler us = host us + OFF_US
READERS = ("prelaunch_ms.frame", "idle_in_port_ms.frame", "setup_in_port_s", "libs_s")


def ns(s):
    return int(round(s * 1e9))


def call_spans(first, t_us):
    """One render_many's port spans, the call opening ``t_us`` after the window's start."""
    t = T0 + t_us / 1e6
    us = 1e-6
    return [("mk.call", t, t + 1900 * us, None), ("mk.poll", t, t + 200 * us, first),
            ("k2.prepare", t + 200 * us, t + 900 * us, first), ("k2.launch", t + 900 * us, t + 1400 * us, first),
            ("mk.accumulate", t + 1400 * us, t + 1900 * us, first)]


def port_spans():
    raw = [("scene.compile", 1.0, 2.0, None),                  # an earlier scene's, before this run
           ("scene.compile", 6.0, 6.5, None), ("scene.bvh", 6.1, 6.3, 1), ("native.load", 6.15, 6.2, 2),
           ("scene.upload", 6.6, 6.7, None),
           ("kernels.load", 7.0, 7.4, None), ("kernels.hash", 7.0, 7.1, 5), ("kernels.dlopen", 7.1, 7.4, 5),
           ("kernels.first_launch", 7.5, 7.6, None)]
    raw += call_spans(len(raw), 100)
    raw += call_spans(len(raw), 50100)
    return [Span(n, ns(s), ns(e), p) for n, s, e, p in raw]


def fake_port(spans, first_drop_ns=None):
    return types.SimpleNamespace(spans=lambda: list(spans), to_timeline=to_timeline,
                                 TRACER=types.SimpleNamespace(first_drop_ns=first_drop_ns))


def synthetic_run(trace=True, unit="frame"):
    rec = Recorder()
    # set-up read at 9.9 s: the run started at 4.9 s; a profiler's start then delays the window
    rec.spans = [("scene_build", 5.9, 6.55), ("upload", 6.55, 6.7), ("warmup", 6.9, 9.9),
                 ("render_many", T0, T0 + 0.0021), ("synchronize", T0 + 0.0021, T0 + 0.0495),
                 ("render_many", T0 + 0.05, T0 + 0.0521), ("synchronize", T0 + 0.0521, T0 + 0.0995)]
    tr = None
    if trace:
        def p(s):
            return s * 1e6 + OFF_US

        tr = Trace(kernels=[("frames_kernel", 8600.0, 56000.0), ("frames_kernel", 58600.0, 106000.0)],
                   spans=[(n, p(s), p(e)) for n, s, e in rec.spans[3:]], window_us=(7000.0, 106500.0))
    return Run(cell=None, rec=rec, setup_s=5.0, window=(T0, T0 + 0.0995), updates=[(T0, T0 + 0.0495)] * 2,
               units_per_update=8, unit=unit, call_span="render_many", trace=tr)


@pytest.fixture
def port(monkeypatch):
    def use(spans=None, first_drop_ns=None, missing=False):
        mod = None if missing else fake_port(port_spans() if spans is None else spans, first_drop_ns)
        monkeypatch.setattr(program, "port_profiling", lambda: mod)
    return use


def read(name, run):
    return load_module("metrics", name).read(run)


def test_each_reader_on_a_synthetic_run(port):
    port()
    run = synthetic_run()
    assert read("prelaunch_ms.frame", run) == pytest.approx(1.4)        # k2.launch's end - mk.call's start
    # each call: 1,500 us of its gap inside the port (200 + 700 + 500 + 100), the rest outside
    assert read("idle_in_port_ms.frame", run) == pytest.approx(1.5)
    assert read("setup_in_port_s", run) == pytest.approx(0.5 + 0.1 + 0.4 + 0.1)
    assert read("libs_s", run) == pytest.approx(0.05 + 0.4 + 0.1)


def test_an_entry_s_spans_are_found_without_their_names(port):
    """Another entry's call and launch spans: the call is the outermost port
    span in the benchmark's call span, the launch its child ``*.launch``."""
    rename = {"mk.call": "dr.step", "k2.launch": "k8.launch", "k2.prepare": "k8.prepare"}
    port(spans=[s._replace(name=rename.get(s.name, s.name)) for s in port_spans()])
    run = synthetic_run()
    assert read("prelaunch_ms.frame", run) == pytest.approx(1.4)
    assert read("idle_in_port_ms.frame", run) == pytest.approx(1.5)
    assert program.call_split(run)["dr.step"]["host"] == pytest.approx(1.9)


def test_idle_is_put_down_to_the_innermost_span():
    trace = synthetic_run().trace
    spans = port_spans()
    window = [s for s in spans if s.start_ns >= ns(T0)]
    pairs = [(ns(T0), 7000.0), (ns(T0 + 0.05), 57000.0)]
    mapped = to_timeline(window, pairs)
    idle = program.idle_by_span(trace.gaps(), mapped)
    assert set(idle) == {None, "mk.poll", "k2.prepare", "k2.launch", "mk.accumulate"}
    assert idle[None] == pytest.approx((100 + 1100 + 500) / 1e6)
    assert idle["mk.poll"] == pytest.approx(400 / 1e6) and idle["k2.prepare"] == pytest.approx(1400 / 1e6)
    assert idle["k2.launch"] == pytest.approx(1000 / 1e6) and idle["mk.accumulate"] == pytest.approx(200 / 1e6)
    assert sum(idle.values()) == pytest.approx(sum(e - s for s, e in trace.gaps()) / 1e6)


def test_the_call_split(port):
    port()
    split = program.call_split(synthetic_run())
    assert split["mk.call"]["host"] == pytest.approx(1.9) and split["mk.call"]["self"] == pytest.approx(0.0)
    assert split["k2.prepare"]["self"] == pytest.approx(0.7) and split["k2.prepare"]["idle"] == pytest.approx(0.7)
    assert split["outside the port"]["idle"] == pytest.approx(0.85)


@pytest.mark.parametrize("name", READERS)
def test_nothing_from_a_program_without_spans(port, name):
    port(missing=True)
    assert read(name, synthetic_run()) is None


def test_nothing_from_a_stretch_the_buffer_dropped_from(port):
    port(first_drop_ns=ns(T0 + 0.06))
    run = synthetic_run()
    assert read("prelaunch_ms.frame", run) is None and read("idle_in_port_ms.frame", run) is None
    assert read("setup_in_port_s", run) == pytest.approx(1.1)      # set-up ended before the first drop
    port(first_drop_ns=ns(6.9))
    assert read("libs_s", run) is None


def test_nothing_where_a_reader_does_not_apply(port):
    port()
    assert read("prelaunch_ms.frame", synthetic_run(unit="step")) is None
    assert read("idle_in_port_ms.frame", synthetic_run(unit="step")) is None
    assert read("idle_in_port_ms.frame", synthetic_run(trace=False)) is None
    assert read("prelaunch_ms.frame", synthetic_run(trace=False)) == pytest.approx(1.4)
    # the CPU's plain path: no launch span
    port(spans=[s._replace(name="other") if s.name == "k2.launch" else s for s in port_spans()])
    assert read("prelaunch_ms.frame", synthetic_run()) is None
    # no set-up spans in this run's set-up: every one an earlier run's
    port(spans=[s._replace(start_ns=s.start_ns - ns(5)) if s.start_ns < ns(T0) else s for s in port_spans()])
    assert read("setup_in_port_s", synthetic_run()) is None and read("libs_s", synthetic_run()) is None


def test_calls_that_do_not_pair_map_nothing(port):
    port()
    run = synthetic_run()
    run.trace.spans = run.trace.spans[:1]           # one call on the profiler's clock, two on the host's
    assert read("idle_in_port_ms.frame", run) is None


def test_a_traced_cpu_run_reports_the_port_s_set_up(monkeypatch):
    """The harness's own traced run on the port's plain CPU path: of the
    port's spans it has set-up spans, and no launch, kernel or library.
    The run's clock starts where the run does, as a command's starts with
    its process: a library that the process loaded before (as an earlier
    test in the same worker does) is none of this run's."""
    import json
    import time

    from gpubench import run as bench_run
    from gpubench.control import bench_with_held_out
    from fypraytracer_tpu_torch.utils import profiling

    with profiling.setup_span("native.load"):
        pass
    time.sleep(0.01)                # what an earlier test ran, and this run's start
    monkeypatch.setattr(bench_run, "T_START", time.perf_counter())
    out = bench_run.run_cell("cornell-nee-1080p", 2 ** 31 + 11, 0.2, True, "cpu", size=(16, 8),
                             bench=bench_with_held_out())
    line = json.loads(json.dumps(out))
    assert line["correct"] is True
    assert "setup_in_port_s" in line["metrics"]
    assert line["metrics"]["setup_in_port_s"]["unit"] == "s"
    assert not {"prelaunch_ms.frame", "idle_in_port_ms.frame", "libs_s"} & set(line["metrics"])
