"""Port parity: the soft reverse-reconciliation slice as a whole.

* With injected ``(x, y)`` the port's round counters equal the JAX round
  composed from its public pieces (hard decision, softening metric, Gray
  word, poly LLRs, QC decode, exact counters).
* ``run_point`` BER/FER agree with the JAX engine within 4 Monte-Carlo
  standard errors (the two draw different random streams).
* The CLI writes the CSV schema; every module imports without jax/pandas.
"""

import csv
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models.alphabet import PAMAlphabet as JPAM
from qamreconciliation_tpu.models.matrix import Matrix as JMatrix
from qamreconciliation_tpu.models.noisemapper import NoiseMapper as JNM
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALTERNATING = np.array([0, 1, 0, 1], np.uint8)


@pytest.fixture(scope="module")
def qc_code():
    base, vid, cid = make_qc_ldpc(24, 32, 3, 6, seed=3)
    return base, vid, cid


def engines(qc_code, B, **dec_kw):
    base, vid, cid = qc_code
    jeng = JEngine(JQC(base, 32, dtype=jnp.float32, use_pallas=False,
                       **dec_kw),
                   JMatrix(vid, cid), JPAM(2, 2.0), batch=B,
                   dtype=jnp.float32)
    teng = ReconciliationEngine(
        QCDecoder(base, 32, torch.float32, device="cpu", **dec_kw),
        Matrix(vid, cid), PAMAlphabet(2, 2.0), batch=B, dtype=torch.float32,
    )
    return jeng, teng


def jax_round(eng, nm, x, y, alpha, maxiter):
    """The JAX softening round body composed from its public pieces, with
    (x, y) injected in place of its sampler."""
    s2b = jnp.asarray(eng.pa.s_to_b.astype(np.int32))
    x_hat = nm.hard_decide_index(y)
    n_hat = nm.map_noise(y, x_hat)
    word = eng._bits_nb(lambda b, idx: s2b[:, b][idx], x_hat)
    llr_bits = nm._poly_llr_bits(n_hat, x)
    lappr = jnp.float32(alpha) * eng._bits_nb(lambda b, _: llr_bits[b],
                                              x_hat)
    return np.asarray(
        eng._decode_and_count_nb(lappr, word, jnp.int32(maxiter))
    )


@pytest.mark.parametrize("dec_kw", [dict(check_rule="minsum"), dict()],
                         ids=["minsum", "sumproduct"])
def test_round_counters_equal_jax_on_injected_samples(qc_code, dec_kw):
    B, snr, maxiter = 16, 3.0, 30
    jeng, teng = engines(qc_code, B, **dec_kw)
    N0 = teng.noise_var(snr)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 4, (teng.N_symb, B)).astype(np.int32)
    y = (teng.pa.constellation[x] + math.sqrt(N0)
         * rng.normal(size=x.shape)).astype(np.float32)

    jnm = JNM(jeng.pa, N0, ALTERNATING, dtype=jnp.float32)
    want = jax_round(jeng, jnm, jnp.asarray(x), jnp.asarray(y), 1.0, maxiter)
    nm = teng.make_noisemapper(snr, ALTERNATING)
    got = teng.softening_round(
        nm, math.sqrt(N0), 1.0, maxiter,
        xy=(torch.from_numpy(x), torch.from_numpy(y)),
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want[3] < B          # some frames decode, some fail


def test_run_point_statistically_equals_jax(qc_code):
    B, snr, maxiter, frames = 64, 4.0, 20, 384
    jeng, teng = engines(qc_code, B)
    kw = dict(nmconfig=ALTERNATING, seed=5)
    rj = jeng.run_point("softening", snr, maxiter, frames, 10 ** 9, **kw)
    rt = teng.run_point("softening", snr, maxiter, frames, 10 ** 9, **kw)
    assert rj.frames == rt.frames == frames
    assert rt.bp_iterations > 0
    se_fer = math.sqrt(sum(r.fer * (1 - r.fer) / r.frames for r in (rj, rt)))
    # per-frame error fractions lie in [0, 1], so var <= mean: a
    # conservative BER standard error for frame-clustered bit errors
    se_ber = math.sqrt(sum(r.ber / r.frames for r in (rj, rt)))
    assert 0.05 < rj.fer < 0.95
    assert abs(rt.fer - rj.fer) <= 4 * se_fer, (rt.fer, rj.fer, se_fer)
    assert abs(rt.ber - rj.ber) <= 4 * se_ber, (rt.ber, rj.ber, se_ber)


def test_cli_writes_csv_schema(qc_code, tmp_path):
    base = qc_code[0]
    path, out = str(tmp_path / "code.csv"), str(tmp_path / "out.csv")
    save_qc_csv(path, base, 32)
    res = sim_reconciliation.main([
        path, "--qc", "--snr", "3", "6", "--nsnr", "2", "--simloops", "32",
        "--batch", "16", "--maxiter", "20", "--device", "cpu", "--out", out,
    ])
    assert [r.frames for r in res] == [32, 32]
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["", "EsN0dB", "ber", "fer", "iters"]
    assert [r[0] for r in rows[1:]] == ["0", "1"]
    assert [float(r[1]) for r in rows[1:]] == [3.0, 6.0]
    assert not os.path.exists(out + ".partial.jsonl")
    # --graph-shard runs, on a one-rank mesh here: the z-sharded decoder
    # is bit-equal to the dense one, so the counters are the same
    sharded = sim_reconciliation.main([
        path, "--qc", "--snr", "3", "6", "--nsnr", "2", "--simloops", "32",
        "--batch", "16", "--maxiter", "20", "--device", "cpu", "--out", out,
        "--graph-shard",
    ])
    assert [r.as_tuple() for r in sharded] == [r.as_tuple() for r in res]
    # the per-sample LLR path and the point batch write the same schema
    res = sim_reconciliation.main([
        path, "--qc", "--snr", "3", "6", "--nsnr", "2", "--simloops", "16",
        "--batch", "16", "--maxiter", "5", "--device", "cpu", "--out", out,
        "--llr-mode", "interp", "--point-batch"])
    assert [r.frames for r in res] == [16, 16]
    with open(out) as f:
        assert next(csv.reader(f)) == ["", "EsN0dB", "ber", "fer", "iters"]


def test_port_imports_without_jax_or_pandas():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = sys.modules['pandas'] = None\n"
        "import qamreconciliation_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'qamreconciliation_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'qamreconciliation_tpu' or "
        "k.startswith('qamreconciliation_tpu.') for k in sys.modules)\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 28
