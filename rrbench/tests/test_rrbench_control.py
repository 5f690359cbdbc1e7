"""``correct`` separates: the control (the reference in float8 e4m3, the
precision below the configuration's bf16, in the program's place) and
each fault a cell can have, planted in the program underneath a CPU run,
come out not correct, while sound runs read 0.  The frozen constructions
build the program's codes."""

import time

import numpy as np
import pytest
import torch

from rrbench import codes, control, run
from rrbench.tests import tiny


def _run(name):
    torch.set_num_threads(1)
    result, _ = run.run_cell(tiny.cell(name), tiny.SEED, 0.3, False, "cpu",
                             t_start=time.perf_counter())
    return result


@pytest.mark.parametrize("name", tiny.WORKLOADS)
def test_control_fails_and_sound_runs_pass(name):
    torch.set_num_threads(1)
    out = control.readings(tiny.cell(name), [7, 8, 9], 0.2, 3,
                           "float8_e4m3fn", "cpu")
    assert all(v == 0 for v in out["lower"].values())
    for reading in out["control"]:
        assert reading["rounds"] > 0
        assert reading["preamble_diff"] > 0 or reading["decode_diff"] > 0


def _unchanged_step(monkeypatch, hook):
    """The decoder's kernel step returns its state unchanged."""
    if hook == "rounds_step":
        import qamreconciliation_tpu_torch.models.qc_decoder as qd

        def step(tables, it0, maxiter, total, c2v, prior, synd, done, iters,
                 **kw):
            return total, c2v, done, iters
        monkeypatch.setattr(qd, "bp_decode_rounds_qc", step)
    else:
        import qamreconciliation_tpu_torch.models.decoder as gd
        real = gd.bp_check_phase_generic

        def step(t, c2v, synd, c_mask, **kw):
            return c2v, real(t, c2v, synd, c_mask, **kw)[1]
        monkeypatch.setattr(gd, "bp_check_phase_generic", step)


def _half_batch(monkeypatch):
    """The counters over half of the batch, doubled as the mean of the
    rest."""
    from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine
    real = ReconciliationEngine._decode_and_count_nb

    def half(self, lappr, word, max_iterations, points=None):
        h = lappr.shape[1] // 2
        return 2 * real(self, lappr[:, :h].contiguous(),
                        word[:, :h].contiguous(), max_iterations, points)
    monkeypatch.setattr(ReconciliationEngine, "_decode_and_count_nb", half)


def _altered_answer(monkeypatch, hook):
    """One hard decision of the decoder's answer flipped where it is
    produced."""
    if hook == "rounds_step":
        from qamreconciliation_tpu_torch.models.qc_decoder import QCDecoder
        cls = QCDecoder
    else:
        from qamreconciliation_tpu_torch.models.decoder import Decoder
        cls = Decoder
    real = cls.decode_batched

    def altered(self, prior, synd, max_iterations):
        done, iters, final = real(self, prior, synd, max_iterations)
        final = final.clone()
        final[0, 0] = -final[0, 0] if final[0, 0] != 0 else -1.0
        return done, iters, final
    monkeypatch.setattr(cls, "decode_batched", altered)


FAULTS = ("unchanged_step", "half_batch", "altered_answer")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", tiny.WORKLOADS)
def test_a_fault_underneath_comes_out_not_correct(name, fault, monkeypatch):
    # one chip a cell: the fault "the exchange between chips left out"
    # has no exchange to leave out
    kind = tiny.cell(name).config["decoder"]["kind"]
    hook = {"qc_resident": "rounds_step", "generic": "check_phase"}[kind]
    if fault == "unchanged_step":
        _unchanged_step(monkeypatch, hook)
    elif fault == "half_batch":
        _half_batch(monkeypatch)
    else:
        _altered_answer(monkeypatch, hook)
    result = _run(name)
    assert result["correct"] is False
    assert max(c["value"] for c in result["checks"].values()) > 0


def test_frozen_constructions_build_the_programs_codes():
    from qamreconciliation_tpu_torch.models.dvbs2 import (
        expanded_edges, make_table)
    from qamreconciliation_tpu_torch.models.qc_decoder import make_qc_ldpc

    qc = codes.build({"kind": "qc_ldpc", "nb_v": 180, "z": 360, "dv": 3,
                      "dc": 6, "seed": 12345})
    base, vid, cid = make_qc_ldpc(180, 360, 3, 6, seed=12345)
    assert qc.base_edges == base
    assert np.array_equal(qc.vid, vid) and np.array_equal(qc.cid, cid)
    d = codes.build({"kind": "dvbs2", "n": 64800, "rate": "1/2", "seed": 0})
    vid, cid = expanded_edges(make_table("1/2", seed=0))
    assert np.array_equal(d.vid, vid) and np.array_equal(d.cid, cid)
    assert d.vid.size == 226799 and (d.vnum, d.cnum) == (64800, 32400)
