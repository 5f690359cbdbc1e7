"""``correct`` separates on the resident min-sum QC cell: the control (the
reference in float8 e4m3) reads non-zero while sound runs read 0, each
fault planted in the program underneath a CPU run (kernel 2's call
leaving the state unchanged, half of the batch counted twice, one hard
decision flipped) comes out not correct, and a traced CPU run records
kernel 2's calls under the min-sum rule, which its roofline counts at 12
operations a slot."""

import time

import pytest
import torch

from rrbench import control, run, spec, tracing, work
from rrbench.tests import tiny
from rrbench.tests.test_rrbench_control import (
    _altered_answer, _half_batch, _run, _unchanged_step)
from rrbench.tests.test_rrbench_program_spans import _ev, _span

QC_HOOK = "rounds_step"

NAME = "qc36.minsum-3.5dB"


def test_the_cell_runs_the_resident_minsum_decoder():
    cell = tiny.cell(NAME)
    assert cell.config["decoder"]["kind"] == "qc_resident_minsum"
    assert cell.config["decoder"]["check_rule"] == "minsum"


def test_control_fails_and_sound_runs_pass():
    torch.set_num_threads(1)
    out = control.readings(tiny.cell(NAME), [7, 8, 9], 0.2, 3,
                           "float8_e4m3fn", "cpu")
    assert all(v == 0 for v in out["lower"].values())
    for reading in out["control"]:
        assert reading["rounds"] > 0
        assert reading["preamble_diff"] > 0 and reading["decode_diff"] > 0


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch",
                                   "altered_answer"])
def test_a_fault_underneath_comes_out_not_correct(fault, monkeypatch):
    if fault == "unchanged_step":
        _unchanged_step(monkeypatch, QC_HOOK)
    elif fault == "half_batch":
        _half_batch(monkeypatch)
    else:
        _altered_answer(monkeypatch, QC_HOOK)
    result = _run(NAME)
    assert result["correct"] is False
    assert max(c["value"] for c in result["checks"].values()) > 0


def _device_trace(seconds):
    """A spans trace whose one kernel, launched inside ``rr.k.rounds_step``,
    runs ``seconds`` on the device."""
    us = seconds * 1e6
    return tracing.Trace([
        _span(tracing.WINDOW, 0, us + 20), _span("rr.k.rounds_step", 0, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 0.5, 0),
        _ev("kernel", "rounds_kernel", 10, us, 0)])


def test_a_traced_run_records_minsum_calls_for_kernel_2s_roofline(
        monkeypatch):
    """On the CPU the roofline reads nothing (it needs device time); the
    calls' records carry the min-sum rule, and on a hand-placed device
    time the reader charges them 12 operations a slot."""
    torch.set_num_threads(1)
    monkeypatch.setattr(run, "TRACE_MIN_S", 0.02)
    kept = {}
    window = run.Session.window

    def keep(self, *args, **kw):
        kept.update(window(self, *args, **kw))
        return kept
    monkeypatch.setattr(run.Session, "window", keep)
    cell = tiny.cell(NAME)
    assert "roofline_pct.k2" in {m["name"] for m in cell.per_layer}
    result, _ = run.run_cell(cell, tiny.SEED, 0.3, True, "cpu",
                             t_start=time.perf_counter())
    assert result["correct"] is True
    assert "roofline_pct.k2" not in result["metrics"]
    calls = kept["run"].calls
    assert calls and {c["rule"] for c in calls} == {"minsum"}
    nbytes = ops = 0
    for c in calls:
        b, o = work.decode_rounds_work(*c["dims"], c["total_dtype"],
                                       c["m_dtype"], "minsum",
                                       int(c["frame_steps"]))
        nbytes, ops = nbytes + b, ops + o
    E, z = calls[0]["dims"][2:4]
    assert ops == 12 * E * z * sum(int(c["frame_steps"]) for c in calls)
    seconds = 1e-3
    traced = tracing.Run(spans=_device_trace(seconds), calls=calls)
    pct = spec.load_reader("roofline_pct.k2")(traced)
    assert pct == pytest.approx(100.0 * work.bound(nbytes, ops)[0]
                                / seconds)
