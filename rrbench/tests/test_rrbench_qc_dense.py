"""``correct`` separates on the dense QC cell: the control (the reference
in float8 e4m3) reads non-zero while sound runs read 0, and each fault
planted in the program underneath a CPU run (kernel 1's step leaving the
messages unchanged, half of the batch counted twice, one hard decision
flipped) comes out not correct."""

import pytest
import torch

from rrbench import control
from rrbench.tests import tiny
from rrbench.tests.test_rrbench_control import (
    _altered_answer, _half_batch, _run)

# _altered_answer flips an answer of QCDecoder.decode_batched under the
# resident loop's hook name, and the dense loop answers through the same
# method
QC_HOOK = "rounds_step"

NAME = "qc36.dense-3.5dB"


def test_the_cell_runs_the_dense_decoder():
    assert tiny.cell(NAME).config["decoder"]["kind"] == "qc_dense"


def test_control_fails_and_sound_runs_pass():
    torch.set_num_threads(1)
    out = control.readings(tiny.cell(NAME), [7, 8, 9], 0.2, 3,
                           "float8_e4m3fn", "cpu")
    assert all(v == 0 for v in out["lower"].values())
    for reading in out["control"]:
        assert reading["rounds"] > 0
        assert reading["preamble_diff"] > 0 and reading["decode_diff"] > 0


def _unchanged_step(monkeypatch):
    """Kernel 1 returns the messages it was given (its violations
    unchanged)."""
    import qamreconciliation_tpu_torch.models.qc_decoder as qd
    real = qd.bp_check_phase_qc

    def step(t, c2v, synd, *args, **kw):
        return c2v, real(t, c2v, synd, *args, **kw)[1]
    monkeypatch.setattr(qd, "bp_check_phase_qc", step)


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
