"""The command line and the result line.  This machine has no CUDA device,
so the real command is refused here, as it must be; the rest of a run is
driven around the port's plain CPU paths at a tiny size."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gpubench import run
from gpubench.control import bench_with_held_out
from gpubench.run import ROOT


def test_no_card_prints_no_result_and_fails():
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal on a machine without a CUDA device")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "cornell-nee-1080p", "--seed",
                        str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


@pytest.mark.parametrize("argv", [[], ["--workload", "cornell-nee-1080p"],
                                  ["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"],
                                  ["--workload", "cornell-nee-1080p", "--seed", "1", "--seconds", "0"]])
def test_bad_arguments_are_refused(argv):
    with pytest.raises(SystemExit) as e:
        run.main(argv)
    assert e.value.code != 0


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        run.main(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1", "--trace", "0"])


def test_a_bare_copy_of_the_benchmark_fails(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's folder,
    the system under test is missing, and the run prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "cornell-nee-1080p", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=120, env=env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("cell,trace", [("cornell-nee-1080p", 0), ("cornell-nee-1080p", 1),
                                        ("cornell-train-1080p", 0)])
def test_result_line(cell, trace):
    b = bench_with_held_out()
    out = run.run_cell(cell, 2 ** 31 + 11, 0.2, bool(trace), "cpu", size=(16, 8), bench=b)
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    group = b["per_layer"] if trace else b["end_to_end"]
    allowed = {m["name"]: m["unit"] for m in group if m.get("workloads") is None or cell in m["workloads"]}
    assert set(line["metrics"]) <= set(allowed)
    for name, m in line["metrics"].items():
        assert m["unit"] == allowed[name] and isinstance(m["value"], float)
    if not trace:
        assert "setup_s" in line["metrics"]
    else:
        assert "busy_s" in line["device"] and "window_s" in line["device"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
