"""BENCHMARK.json keeps the benchmark's contract and finds every file by name."""

import json
import os
import re

import pytest

from gpubench.run import HERE, ROOT, Cell, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|per_tok)")


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16 and 1 <= len(b["command"]) <= 32
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
    for w in b["command"]:
        assert text_ok(w) and not w.startswith("/") and ".." not in w


def test_names_units_and_text():
    b = manifest()
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


def test_entries_have_exactly_their_keys():
    b = manifest()
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


def test_every_name_resolves_to_its_files():
    b = manifest()
    for c in b["configs"]:
        assert c["file"].startswith("gpubench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert set(json.load(f)["reduced"]) == set(c["reduced"])
    configs_used = set()
    for w in b["workloads"]:
        cell = Cell.find(w["name"], b)
        configs_used.add(w["config"])
        assert os.path.isfile(os.path.join(HERE, "entries", f"{cell.traffic['entry']}.py"))
        assert cell.data["check"]["limits"]
        assert cell.data["frozen"]
        for frozen in cell.data["frozen"].values():
            assert frozen["ops_per_launch"] > 0 and frozen["bytes_per_launch"] > 0
    assert configs_used == {c["name"] for c in b["configs"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.isfile(os.path.join(HERE, "metrics", f"{m['name']}.py")), m["name"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    b = manifest()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in b["workloads"]:
        def reported(m):
            return m.get("workloads") is None or w["name"] in m["workloads"]
        assert reported(e2e["setup_s"])
        assert any(reported(m) for n, m in e2e.items() if n != "setup_s")
        # a per-layer metric without a list is reported wherever what it moves is
        layers = [m for m in b["per_layer"]
                  if (reported(m) if "workloads" in m else reported(e2e[m["moves"]]))]
        assert layers
        for m in layers:
            assert m["moves"] in e2e and reported(e2e[m["moves"]]), (m["name"], w["name"])


def test_chips_and_time_budget():
    b = manifest()
    fours = sum(w["chips"] == 4 for w in b["workloads"])
    assert fours <= max(1, len(b["workloads"]) // 4)
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "traffic", "workloads"])
def test_data_files_are_json(kind):
    for fn in os.listdir(os.path.join(HERE, kind)):
        assert fn.endswith(".json")
        with open(os.path.join(HERE, kind, fn)) as f:
            json.load(f)
