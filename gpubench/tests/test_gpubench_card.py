"""On the card: one short run of each cell through the real command, its
result line whole and correct.  Skips where torch sees no card.

    python3 -m pytest gpubench/tests/test_gpubench_card.py -q
"""

import json
import subprocess
import sys

import pytest
import torch

from gpubench.run import ROOT, manifest


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", cell, "--seed", "2147483649",
                        "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
