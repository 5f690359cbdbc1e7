"""Port parity: the resident decoders under the engine and the CLI.

* ``run_point`` with the resident flooding decoder and with the resident
  layered decoder agrees with the JAX engine running the same decoder
  (Pallas in interpret mode) within 4 Monte-Carlo standard errors on BER
  and FER (the two draw different random streams); the BP iterations the
  port counts are those that ran.
* ``sim_reconciliation --qc --resident`` and ``--schedule layered
  --resident`` write the CSV schema on the CPU; the JAX CLI's guards hold.
"""

import csv
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models.alphabet import PAMAlphabet as JPAM
from qamreconciliation_tpu.models.matrix import Matrix as JMatrix
from qamreconciliation_tpu.models.qc_decoder import QCDecoder as JQC
from qamreconciliation_tpu.sims.engine import ReconciliationEngine as JEngine
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc, save_qc_csv,
)
from qamreconciliation_tpu_torch.sims import sim_reconciliation
from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine

torch.set_num_threads(1)

ALTERNATING = np.array([0, 1, 0, 1], np.uint8)


@pytest.fixture(scope="module")
def qc_code():
    return make_qc_ldpc(24, 32, 3, 6, seed=3)


@pytest.mark.parametrize("dec_kw", [
    dict(resident=True, resident_chunk=10),
    dict(schedule="layered", resident=True, check_rule="minsum"),
], ids=["resident", "resident-layered"])
def test_run_point_statistically_equals_jax(qc_code, dec_kw):
    base, vid, cid = qc_code
    B, snr, maxiter, frames = 64, 4.0, 20, 384
    kw = dict(nmconfig=ALTERNATING, seed=5)
    rj = JEngine(JQC(base, 32, dtype=jnp.float32, **dec_kw),
                 JMatrix(vid, cid), JPAM(2, 2.0), batch=B,
                 dtype=jnp.float32).run_point("softening", snr, maxiter,
                                              frames, 10 ** 9, **kw)
    dec = QCDecoder(base, 32, torch.float32, device="cpu", **dec_kw)
    rt = ReconciliationEngine(dec, Matrix(vid, cid), PAMAlphabet(2, 2.0),
                              batch=B, dtype=torch.float32).run_point(
        "softening", snr, maxiter, frames, 10 ** 9, **kw)
    assert rj.frames == rt.frames == frames
    # each round runs until all its frames converge or maxiter: at most
    # maxiter per round, and at least the mean iterations of the successes
    rounds = frames // B
    assert rt.bp_iterations == dec.iterations_run
    assert rt.iters <= rt.bp_iterations / rounds <= maxiter
    se_fer = math.sqrt(sum(r.fer * (1 - r.fer) / r.frames for r in (rj, rt)))
    se_ber = math.sqrt(sum(r.ber / r.frames for r in (rj, rt)))
    assert 0.05 < rj.fer < 0.95
    assert abs(rt.fer - rj.fer) <= 4 * se_fer, (rt.fer, rj.fer, se_fer)
    assert abs(rt.ber - rj.ber) <= 4 * se_ber, (rt.ber, rj.ber, se_ber)


@pytest.mark.parametrize("flags", [
    ["--resident", "--resident-chunk", "8"],
    ["--schedule", "layered", "--resident", "--layered-chunk", "3",
     "--check-rule", "minsum", "--dtype", "bfloat16"],
    ["--schedule", "layered", "--layered-groups", "1"],
], ids=["resident", "resident-layered", "layered-grouped"])
def test_cli_runs_the_resident_and_layered_decoders(qc_code, tmp_path,
                                                    flags):
    base = qc_code[0]
    path, out = str(tmp_path / "code.csv"), str(tmp_path / "out.csv")
    save_qc_csv(path, base, 32)
    res = sim_reconciliation.main([
        path, "--qc", "--snr", "3", "6", "--nsnr", "2", "--simloops", "32",
        "--batch", "16", "--maxiter", "20", "--device", "cpu", "--out", out,
        *flags,
    ])
    assert [r.frames for r in res] == [32, 32]
    assert all(r.bp_iterations > 0 for r in res)
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["", "EsN0dB", "ber", "fer", "iters"]
    assert [float(r[1]) for r in rows[1:]] == [3.0, 6.0]


def test_cli_passes_the_resident_options_and_keeps_the_guards(qc_code,
                                                              tmp_path):
    from qamreconciliation_tpu_torch.sims.common import load_decoder

    base = qc_code[0]
    path = str(tmp_path / "code.csv")
    save_qc_csv(path, base, 32)
    parser = sim_reconciliation.build_parser()
    dec, _, _ = load_decoder(parser.parse_args([
        path, "--qc", "--device", "cpu", "--resident",
        "--resident-rowgroup", "4", "--schedule", "layered",
        "--layered-chunk", "2", "--layered-groups", "0"]))
    assert dec.resident and dec.schedule == "layered"
    assert (dec.layered_chunk, dec.layered_groups) == (2, False)
    assert dec.resident_rowgroup == 4
    args = parser.parse_args([path, "--qc"])
    assert (args.resident_chunk, args.layered_chunk,
            args.layered_groups) == (50, 4, -1)
    for flags in (["--resident", "--point-batch"],
                  ["--graph-shard", "--resident"],
                  ["--graph-shard", "--schedule", "layered"]):
        with pytest.raises(SystemExit):
            sim_reconciliation.main([path, "--qc", "--device", "cpu",
                                     *flags])
    with pytest.raises(ValueError, match="resident_rowgroup"):
        sim_reconciliation.main([path, "--qc", "--device", "cpu",
                                 "--resident", "--resident-rowgroup", "1"])
