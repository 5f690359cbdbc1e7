"""On the card: a short run of each cell at its full size through the
command, untraced and traced, with ``correct`` true and, traced, every
per-layer metric of the cell read.  ``python -m pytest rrbench/tests -m cuda``
on a machine with an NVIDIA GPU."""

import json
import subprocess
import sys

import pytest
import torch

from rrbench import spec
from rrbench.tests.tiny import BENCH, ROOT, WORKLOADS


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", WORKLOADS)
def test_a_short_run_on_the_card_is_correct(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "rrbench.run", "--workload", name, "--seed",
         "3141592653", "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    dev = line["device"]
    assert dev["platform"] == "gpu"
    if trace:
        cell = spec.cell(BENCH, ROOT, name)
        assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
        assert 0 < dev["busy_s"] <= dev["window_s"]
        for name_, m in line["metrics"].items():
            assert m["value"] > 0, name_
            if name_.startswith("roofline_pct"):
                assert m["value"] <= 100.0
