"""A CPU rehearsal of each cell at a tiny size (the program's plain
versions on the CPU, the reference beside them) prints a last line of the
contract's shape, with every check passing."""

import json
import time

import pytest
import torch

from rrbench import run
from rrbench.tests import tiny

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", tiny.WORKLOADS)
def test_cpu_rehearsal_prints_the_contract_line(name, trace, capsys,
                                               monkeypatch):
    torch.set_num_threads(1)
    # a traced stretch of a few tiny points, so the window holds it
    monkeypatch.setattr(run, "TRACE_MIN_S", 0.02)
    cell = tiny.cell(name)
    result, checks = run.run_cell(cell, tiny.SEED, 0.3, bool(trace), "cpu",
                                  t_start=time.perf_counter())
    run.report(result, checks)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert all(k in line for k in REQUIRED)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= cell.traffic["frames_per_point"]
    assert line["device"]["platform"] == "cpu"
    names = set(line["metrics"])
    if trace:
        assert names <= {m["name"] for m in cell.per_layer}
        assert "point_setup_ms" in names
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert names == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    tail = err.strip().splitlines()[-len(checks):]
    assert [t.split()[1] for t in tail] == list(checks)
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", tiny.WORKLOADS[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_main_refuses_an_unknown_cell(capsys):
    rc = run.main(["--workload", "no.such-cell", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
