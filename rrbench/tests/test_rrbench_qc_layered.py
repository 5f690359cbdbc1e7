"""``correct`` separates on the resident layered QC cell: the control (the
reference in float8 e4m3) reads non-zero while sound runs read 0, each
fault planted in the program underneath a CPU run (kernel 3's call
leaving the state unchanged, half of the batch counted twice, one hard
decision flipped) comes out not correct, and a traced CPU run reads
kernel 3's frozen share."""

import time

import pytest
import torch

from rrbench import control, run, spec, tracing
from rrbench.tests import tiny
from rrbench.tests.test_rrbench_control import (
    _altered_answer, _half_batch, _run)

# _altered_answer flips an answer of QCDecoder.decode_batched under the
# resident loop's hook name, and the layered loop answers through the same
# method
QC_HOOK = "rounds_step"

NAME = "qc36.layered-4.0dB"


def test_the_cell_runs_the_layered_decoder():
    assert tiny.cell(NAME).config["decoder"]["kind"] == "qc_layered"


def test_control_fails_and_sound_runs_pass():
    torch.set_num_threads(1)
    out = control.readings(tiny.cell(NAME), [7, 8, 9], 0.2, 3,
                           "float8_e4m3fn", "cpu")
    assert all(v == 0 for v in out["lower"].values())
    for reading in out["control"]:
        assert reading["rounds"] > 0
        assert reading["preamble_diff"] > 0 and reading["decode_diff"] > 0


def _unchanged_step(monkeypatch):
    """Kernel 3 returns the state it was given."""
    import qamreconciliation_tpu_torch.models.qc_decoder as qd

    def step(tables, it0, maxiter, total, c2v, synd, done, iters, **kw):
        return total, c2v, done, iters
    monkeypatch.setattr(qd, "bp_layered_sweeps_qc", step)


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch",
                                   "altered_answer"])
def test_a_fault_underneath_comes_out_not_correct(fault, monkeypatch):
    if fault == "unchanged_step":
        _unchanged_step(monkeypatch)
    elif fault == "half_batch":
        _half_batch(monkeypatch)
    else:
        _altered_answer(monkeypatch, QC_HOOK)
    result = _run(NAME)
    assert result["correct"] is False
    assert max(c["value"] for c in result["checks"].values()) > 0


def test_a_traced_run_reads_kernel_3s_metrics():
    """On the CPU the frozen share reads from the calls' records (the
    roofline needs device time, so it reads nothing)."""
    torch.set_num_threads(1)
    cell = tiny.cell(NAME)
    names = {m["name"] for m in cell.per_layer}
    assert {"roofline_pct.k3", "frozen_sweep_pct"} <= names
    result, _ = run.run_cell(cell, tiny.SEED, 0.3, True, "cpu",
                             t_start=time.perf_counter())
    assert result["correct"] is True
    frozen = result["metrics"]["frozen_sweep_pct"]["value"]
    assert 0.0 <= frozen < 100.0
    assert "roofline_pct.k3" not in result["metrics"]
    assert spec.load_reader("roofline_pct.k3")(tracing.Run()) is None
