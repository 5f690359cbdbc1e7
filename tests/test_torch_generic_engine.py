"""Port parity: the soft reverse-reconciliation slice on the generic decoder.

* With injected ``(x, y)`` the port's round counters, decoded by the
  generic ``Decoder``, equal the JAX round composed from its public pieces
  with the JAX ``Decoder`` (exact integer counters).
* ``sim_reconciliation`` without ``--qc`` runs an expanded edge CSV and
  writes the CSV schema; ``--lift-qc`` finds the JAX package's lifting, or
  warns and falls back to the generic decoder (a DVB-S2-style deficient
  wrap circulant); the flags that need a QC decoder stop the CLI.
* The DVB-S2 construction copied into the port equals the JAX one.
"""

import csv
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models import dvbs2 as jdvbs2
from qamreconciliation_tpu.models.alphabet import PAMAlphabet as JPAM
from qamreconciliation_tpu.models.decoder import Decoder as JDecoder
from qamreconciliation_tpu.models.matrix import Matrix as JMatrix
from qamreconciliation_tpu.models.noisemapper import NoiseMapper as JNM
from qamreconciliation_tpu.models.qc_decoder import detect_qc as jdetect_qc
from qamreconciliation_tpu.sims.engine import ReconciliationEngine as JEngine
from qamreconciliation_tpu_torch.models import dvbs2
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, detect_qc, make_qc_ira, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.sims import sim_reconciliation
from qamreconciliation_tpu_torch.sims.common import load_decoder
from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine
from qamreconciliation_tpu_torch.utils.edgefile import (
    make_regular_ldpc, save_edge_csv,
)

torch.set_num_threads(1)

ALTERNATING = np.array([0, 1, 0, 1], np.uint8)
CODE = make_regular_ldpc(768, 3, 6, seed=9)


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
def test_round_counters_equal_jax_on_injected_samples(dec_kw):
    vid, cid = CODE
    B, snr, maxiter = 16, 3.0, 30
    jeng = JEngine(JDecoder(vid, cid, dtype=jnp.float32, **dec_kw),
                   JMatrix(vid, cid), JPAM(2, 2.0), batch=B,
                   dtype=jnp.float32)
    dec = Decoder(vid, cid, torch.float32, device="cpu", **dec_kw)
    teng = ReconciliationEngine(dec, Matrix(vid, cid), PAMAlphabet(2, 2.0),
                                batch=B, dtype=torch.float32)
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
    assert dec.iterations_run == maxiter


def test_cli_without_qc_writes_csv_schema(tmp_path):
    path, out = str(tmp_path / "code.csv"), str(tmp_path / "out.csv")
    save_edge_csv(path, *CODE)
    res = sim_reconciliation.main([
        path, "--snr", "3", "6", "--nsnr", "2", "--simloops", "32",
        "--batch", "16", "--maxiter", "20", "--device", "cpu", "--out", out,
        "--check-rule", "minsum",
    ])
    assert [r.frames for r in res] == [32, 32]
    assert all(r.bp_iterations > 0 for r in res)
    assert res[1].fer <= res[0].fer
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["", "EsN0dB", "ber", "fer", "iters"]
    assert [r[0] for r in rows[1:]] == ["0", "1"]
    assert [float(r[1]) for r in rows[1:]] == [3.0, 6.0]
    assert not os.path.exists(out + ".partial.jsonl")


def _args(path, *flags):
    return sim_reconciliation.build_parser().parse_args(
        [path, "--device", "cpu", *flags])


@pytest.mark.parametrize("code", ["regular", "ira"])
def test_lift_qc_finds_the_jax_lifting(code, tmp_path):
    if code == "regular":
        base, vid, cid = make_qc_ldpc(12, 8, 3, 6, seed=3)
    else:
        base, vid, cid = make_qc_ira(8, 4, 8, dv=3, seed=2)
    lifted = detect_qc(vid, cid)
    assert lifted == jdetect_qc(vid, cid)
    assert sorted(lifted[0]) == sorted(base) and lifted[1] == 8
    path = str(tmp_path / "expanded.csv")
    save_edge_csv(path, vid, cid)
    dec, v2, c2 = load_decoder(_args(path, "--lift-qc"))
    assert isinstance(dec, QCDecoder) and dec.z == 8
    np.testing.assert_array_equal(v2, vid)
    np.testing.assert_array_equal(c2, cid)


def test_lift_qc_warns_on_a_deficient_wrap(tmp_path):
    """An accumulator whose wrap circulant lacks one edge, as the exact
    DVB-S2 H does: no lifting, a warning and the generic decoder."""
    base, vid, cid = make_qc_ira(8, 4, 8, dv=3, seed=2)
    base.append((0, 8 + 3, 1))                       # the wrap circulant
    k = np.arange(8)
    vid = np.concatenate([vid, (8 + 3) * 8 + k[:-1]])
    cid = np.concatenate([cid, (k[:-1] + 1) % 8])
    assert detect_qc(vid, cid) is None is jdetect_qc(vid, cid)
    path = str(tmp_path / "deficient.csv")
    save_edge_csv(path, vid, cid)
    with pytest.warns(UserWarning, match="no circulant structure"):
        dec, _, _ = load_decoder(_args(path, "--lift-qc"))
    assert isinstance(dec, Decoder) and dec.graph.ednum == vid.size


@pytest.mark.parametrize("flags", [["--resident"], ["--schedule", "layered"],
                                   ["--sr-messages"]],
                         ids=["resident", "layered", "sr-messages"])
def test_qc_only_flags_stop_the_generic_cli(flags, tmp_path):
    path = str(tmp_path / "code.csv")
    save_edge_csv(path, *CODE)
    with pytest.raises(SystemExit, match="quasi-cyclic decoder"):
        load_decoder(_args(path, *flags))
    with pytest.raises(SystemExit, match="quasi-cyclic decoder"):
        sim_reconciliation.main([path, "--device", "cpu", *flags])


def test_dvbs2_construction_matches_jax():
    t, jt = dvbs2.make_table("1/2", seed=0), jdvbs2.make_table("1/2", seed=0)
    assert (t.n, t.k, t.rows, t.source) == (jt.n, jt.k, jt.rows, jt.source)
    assert t.check_degrees() == {6: 1, 7: 32399}
    for got, want in zip(dvbs2.expanded_edges(t), jdvbs2.expanded_edges(jt)):
        np.testing.assert_array_equal(got, want)
    assert dvbs2.to_qc_base(t, wrap="exact") == jdvbs2.to_qc_base(
        jt, wrap="exact")
    info = np.random.default_rng(0).integers(0, 2, t.k)
    np.testing.assert_array_equal(dvbs2.encode(t, info),
                                  jdvbs2.encode(jt, info))
