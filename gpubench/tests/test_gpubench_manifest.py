"""BENCHMARK.json keeps the benchmark's contract and finds every file by name,
as committed and after a cell is added by additions alone: the held-out
training cell admitted by its held-out entries (its cell, ``step_ms`` and the
step readers), a new frame cell with its own data files and per-layer
metric, and a second training cell (each a copy of the manifest that only
appends: entries, and the new cell's name to the lists of the metrics it
reports)."""

import json
import os
import re
import shutil

import pytest

from gpubench import control, run, trace
from gpubench.run import ROOT, Cell, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|per_tok)")


TRAIN = "cornell-train-1080p"
LIVE = {"name": "cornell-nee-1080p-live", "config": "cornell", "traffic": "nee-1080p-live", "chips": 1,
        "why": "one frame an update: a new frame cell, its own traffic, workload and per-layer files"}
LIVE_LAYER = {"name": "host_ms.live", "unit": "ms", "better": "lower", "source": "host_clock",
              "layer": "entry points", "moves": "frame_ms", "workloads": [LIVE["name"]]}
STEP = {"name": "cornell-train-256", "config": "cornell", "traffic": "train-256", "chips": 1,
        "why": "a second training cell: its own traffic and workload files, the step metrics by their lists"}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def with_cell(b, cell, layers=(), reports=()):
    """A copy of manifest ``b`` with ``cell`` and ``layers`` appended, and the
    cell's name appended to the lists of the metrics named in ``reports``."""
    def listed(m):
        return dict(m, workloads=m["workloads"] + [cell["name"]]) if m["name"] in reports else m
    return dict(b, workloads=b["workloads"] + [cell], end_to_end=[listed(m) for m in b["end_to_end"]],
                per_layer=[listed(m) for m in b["per_layer"]] + list(layers))


def only_adds(base, b) -> bool:
    """``b`` is ``base`` with entries appended to its lists and nothing else changed."""
    if isinstance(base, dict):
        return isinstance(b, dict) and set(b) == set(base) and all(only_adds(v, b[k]) for k, v in base.items())
    if isinstance(base, list):
        return isinstance(b, list) and len(b) >= len(base) and all(map(only_adds, base, b))
    return b == base


def reported(b, cell) -> set:
    """The metrics that manifest ``b`` asks of ``cell``: those that list it, or list nothing."""
    return {m["name"] for m in b["end_to_end"] + b["per_layer"] if m.get("workloads") is None or cell in m["workloads"]}


def live_copy(tmp_path):
    """The benchmark's folder copied, with the files a new one-frame cell
    adds: its traffic, its workload's data and its per-layer reader."""
    here = tmp_path / "gpubench"
    shutil.copytree(run.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(here / "traffic" / "nee-1080p.json") as f:
        traffic = json.load(f)
    with open(here / "traffic" / f"{LIVE['traffic']}.json", "w") as f:
        json.dump(dict(traffic, frames_per_update=1), f)
    shutil.copy(here / "workloads" / "cornell-nee-1080p.json", here / "workloads" / f"{LIVE['name']}.json")
    shutil.copy(here / "metrics" / "host_ms.frame.py", here / "metrics" / f"{LIVE_LAYER['name']}.py")
    return str(here)


def step_copy(tmp_path):
    """The benchmark's folder copied, with the files a second training cell
    adds: its traffic and its workload's data."""
    here = tmp_path / "gpubench"
    shutil.copytree(run.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(here / "traffic" / "train-1080p.json") as f:
        traffic = json.load(f)
    with open(here / "traffic" / f"{STEP['traffic']}.json", "w") as f:
        json.dump(dict(traffic, width=256, height=256), f)
    shutil.copy(here / "workloads" / f"{TRAIN}.json", here / "workloads" / f"{STEP['name']}.json")
    return str(here)


def added(kind, tmp_path, monkeypatch):
    """The manifest with one cell added by additions alone, its files in place."""
    if kind == "training_admitted":
        return control.bench_with_held_out()
    if kind == "frame_cell_added":
        monkeypatch.setattr(run, "HERE", live_copy(tmp_path))
        return with_cell(manifest(), LIVE, [LIVE_LAYER], reports=("frame_ms", "update_p95_ms"))
    assert kind == "step_cell_added"          # after the training cell's admission
    monkeypatch.setattr(run, "HERE", step_copy(tmp_path))
    return with_cell(control.bench_with_held_out(), STEP, reports=("step_ms", "host_ms.step"))


@pytest.fixture(params=["as_committed", "training_admitted", "frame_cell_added", "step_cell_added"])
def bench(request, tmp_path, monkeypatch):
    if request.param == "as_committed":
        return manifest()
    return added(request.param, tmp_path, monkeypatch)


def test_top_level_keys_and_size(bench):
    b = bench
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert len(json.dumps(b, indent=1)) <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16 and 1 <= len(b["command"]) <= 32
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
    for w in b["command"]:
        assert text_ok(w) and not w.startswith("/") and ".." not in w


def test_names_units_and_text(bench):
    b = bench
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    metrics = b["end_to_end"] + b["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(set(c["name"] for c in b["configs"])) == len(b["configs"])
    assert len(set(w["name"] for w in b["workloads"])) == len(b["workloads"])
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for n in names + [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for c in b["configs"]:
        assert text_ok(c["why"]) and text_ok(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert text_ok(w["why"]) and w["chips"] in (1, 4)
    for m in b["per_layer"]:
        assert text_ok(m["layer"])


def test_entries_have_exactly_their_keys(bench):
    b = bench
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_name_resolves_to_its_files(bench):
    b = bench
    for c in b["configs"]:
        assert c["file"].startswith("gpubench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert set(json.load(f)["reduced"]) == set(c["reduced"])
    configs_used = set()
    for w in b["workloads"]:
        cell = Cell.find(w["name"], b)
        configs_used.add(w["config"])
        assert os.path.isfile(os.path.join(run.HERE, "entries", f"{cell.traffic['entry']}.py"))
        assert cell.data["check"]["limits"]
        assert cell.data["frozen"]
        for frozen in cell.data["frozen"].values():
            assert frozen["ops_per_launch"] > 0 and frozen["bytes_per_launch"] > 0
    assert configs_used == {c["name"] for c in b["configs"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.isfile(os.path.join(run.HERE, "metrics", f"{m['name']}.py")), m["name"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    b = bench
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in b["workloads"]:
        names = reported(b, w["name"])
        assert "setup_s" in names
        assert names & set(e2e) - {"setup_s"}
        layers = [m for m in b["per_layer"] if m["name"] in names]
        assert layers
        for m in layers:
            assert m["moves"] in names, (m["name"], w["name"])


def test_chips_and_time_budget(bench):
    b = bench
    fours = sum(w["chips"] == 4 for w in b["workloads"])
    assert fours <= max(1, len(b["workloads"]) // 4)
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "traffic", "workloads"])
def test_data_files_are_json(kind, bench):
    for fn in os.listdir(os.path.join(run.HERE, kind)):
        assert fn.endswith(".json")
        with open(os.path.join(run.HERE, kind, fn)) as f:
            json.load(f)


def test_every_per_layer_metric_lists_its_cells(bench):
    """So that a cell added later is held to no per-layer metric it cannot read."""
    for m in bench["per_layer"]:
        assert isinstance(m.get("workloads"), list) and m["workloads"], m["name"]


def test_every_end_to_end_metric_but_setup_s_lists_its_cells(bench):
    """Every cell reports ``setup_s``; no other end-to-end metric is read in
    every kind of cell (a frame cell has no step), so a cell added later is
    held only to those whose lists it joins."""
    for m in bench["end_to_end"]:
        if m["name"] == "setup_s":
            assert "workloads" not in m
        else:
            assert isinstance(m.get("workloads"), list) and m["workloads"], m["name"]


def test_every_listed_cell_is_a_cell(bench):
    """A metric's list names only cells of its own manifest: a held-out cell's
    metrics are held out with it."""
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m["name"]
        assert len(set(m.get("workloads", []))) == len(m.get("workloads", []))


@pytest.mark.parametrize("kind", ["training_admitted", "frame_cell_added", "step_cell_added"])
def test_a_copy_only_adds(kind, tmp_path, monkeypatch):
    base = manifest()
    b = added(kind, tmp_path, monkeypatch)
    assert only_adds(base, b)
    assert not only_adds(b, base)
    for w in base["workloads"]:         # nothing that a committed cell reports changes
        assert reported(b, w["name"]) == reported(base, w["name"])


def test_the_training_cell_is_admitted_by_its_held_out_entries_alone():
    """The held-out training cell joins with its held-out entries appended and
    nothing else changed: every metric it reports comes with it, and no
    committed cell reports one of them."""
    base = manifest()
    b = control.bench_with_held_out()
    assert b == dict(base, **{k: base[k] + v for k, v in control.HELD_OUT.items()})
    assert {"setup_s", "step_ms", "host_ms.step", "idle_share.step", "k8_roofline"} == reported(b, TRAIN)
    for m in [m for v in control.HELD_OUT.values() for m in v if "workloads" in m]:
        assert m["workloads"] == [TRAIN], m["name"]


def test_a_held_out_cell_is_admitted_by_its_entries_alone(monkeypatch):
    """Once BENCHMARK.json has a held-out cell's entries, they are held out no more."""
    assert TRAIN not in {w["name"] for w in manifest()["workloads"]}
    held = {k: {e["name"] for e in v} for k, v in control.HELD_OUT.items()}
    assert not held["end_to_end"] & {m["name"] for m in manifest()["end_to_end"]}
    for b in (manifest(), control.bench_with_held_out()):
        monkeypatch.setattr(control, "manifest", lambda b=b: b)
        admitted = control.bench_with_held_out()
        for key, names in held.items():
            listed = [e["name"] for e in admitted[key]]
            assert len(listed) == len(set(listed)) and names <= set(listed), key


def k8_under_each_step(monkeypatch):
    """The CPU runs no kernel: put one K8 launch under each ``step`` span of the
    trace, so that the device's readers find what they read on the card."""
    sound = trace.read_profile

    def read(prof, rec):
        tr = sound(prof, rec)
        tr.kernels = [("diff_kernel<2>", s, e) for n, s, e in tr.spans if n == "step"]
        return tr
    monkeypatch.setattr(trace, "read_profile", read)


@pytest.mark.parametrize("traced,names", [(False, {"setup_s", "step_ms"}),
                                          (True, {"host_ms.step", "idle_share.step", "k8_roofline"})])
def test_the_admitted_training_cell_reports_its_metrics(traced, names, monkeypatch):
    """The held-out training cell added by its held-out entries alone, run on the CPU at
    a small size: ``setup_s``, ``step_ms`` and the three step readers."""
    b = control.bench_with_held_out()
    if traced:
        k8_under_each_step(monkeypatch)
    out = run.run_cell(TRAIN, 2 ** 31 + 19, 0.2, traced, "cpu", size=(16, 8), bench=b)
    assert out["correct"] is True
    assert set(out["metrics"]) == names
    group = {m["name"] for m in b["per_layer" if traced else "end_to_end"]}
    assert names == reported(b, TRAIN) & group


@pytest.mark.parametrize("traced,names", [(False, {"setup_s", "frame_ms", "update_p95_ms"}),
                                          (True, {LIVE_LAYER["name"]})])
def test_an_added_frame_cell_reports_frame_ms_and_update_p95_ms(traced, names, tmp_path, monkeypatch):
    """A new frame cell with its own data files reports the frame metrics
    whose lists it joins, and its own per-layer metric."""
    b = added("frame_cell_added", tmp_path, monkeypatch)
    out = run.run_cell(LIVE["name"], 2 ** 31 + 23, 0.2, traced, "cpu", size=(16, 8), bench=b)
    assert out["correct"] is True
    assert set(out["metrics"]) == names
    group = {m["name"] for m in b["per_layer" if traced else "end_to_end"]}
    assert names == reported(b, LIVE["name"]) & group


@pytest.mark.parametrize("traced,names", [(False, {"setup_s", "step_ms"}), (True, {"host_ms.step"})])
def test_a_second_training_cell_reports_step_ms(traced, names, tmp_path, monkeypatch):
    """A second training cell with its own data files reports ``step_ms`` and
    ``host_ms.step`` by joining their lists, no entry otherwise changed."""
    b = added("step_cell_added", tmp_path, monkeypatch)
    out = run.run_cell(STEP["name"], 2 ** 31 + 29, 0.2, traced, "cpu", size=(16, 8), bench=b)
    assert out["correct"] is True
    assert set(out["metrics"]) == names
    group = {m["name"] for m in b["per_layer" if traced else "end_to_end"]}
    assert names == reported(b, STEP["name"]) & group
