"""Port parity: QAM as I/Q PAM (models/qam.py) against the JAX QAMAlphabet.

The cases of tests/test_qam.py, each held to the JAX object on the same
numpy-seeded inputs: constellation and variance, the complex dtypes (a bf16
part raises ``TypeError`` in both, as ``jax.lax.complex`` accepts float32
and float64 parts only), the bit layout, the LLR interleave, the AWGN
split, and an end-to-end 16-QAM softening decode whose words, LLRs and
decodes equal JAX's (words and decisions exactly, float64 LLRs within
1e-9).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models.decoder import Decoder as JDecoder
from qamreconciliation_tpu.models.matrix import Matrix as JMatrix
from qamreconciliation_tpu.models.noisemapper import NoiseMapper as JNM
from qamreconciliation_tpu.models.qam import QAMAlphabet as JQAM
from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
from qamreconciliation_tpu_torch.models.qam import QAMAlphabet
from qamreconciliation_tpu_torch.utils.edgefile import make_regular_ldpc

torch.set_num_threads(1)


def test_rejects_odd_bps():
    with pytest.raises(ValueError):
        QAMAlphabet(3, 2.0)


@pytest.mark.parametrize("bps", [2, 4, 6])
def test_constellation_and_variance_equal_jax(bps):
    qam, jqam = QAMAlphabet(bps, 2.0), JQAM(bps, 2.0)
    assert (qam.order, qam.step, qam.bit_per_symbol) == \
        (jqam.order, jqam.step, jqam.bit_per_symbol)
    assert qam.variance == jqam.variance == 2 * qam.pam.variance
    np.testing.assert_array_equal(qam.pam.constellation,
                                  jqam.pam.constellation)


def test_random_symbols_energy():
    qam = QAMAlphabet(4, 2.0)
    gen = torch.Generator().manual_seed(0)
    iq = qam.random_symbols(gen, (2048,), "cpu")
    assert all(i.shape == (2048,) and int(i.min()) >= 0
               and int(i.max()) < qam.pam.order for i in iq)
    y = qam.index_to_value(iq)
    assert y.dtype == torch.complex64
    es = float(torch.mean(torch.abs(y) ** 2))
    assert es == pytest.approx(qam.variance, rel=0.1)


@pytest.mark.parametrize("name,complex_name", [("float32", "complex64"),
                                               ("float64", "complex128")])
def test_index_to_value_equals_jax(name, complex_name):
    qam, jqam = QAMAlphabet(4, 2.0), JQAM(4, 2.0)
    rng = np.random.default_rng(1)
    i_idx, q_idx = rng.integers(0, 4, (2, 3, 9))
    got = qam.index_to_value((torch.from_numpy(i_idx),
                              torch.from_numpy(q_idx)), getattr(torch, name))
    want = np.asarray(jqam.index_to_value((jnp.asarray(i_idx),
                                           jnp.asarray(q_idx)),
                                          jnp.dtype(name)))
    assert str(got.dtype) == f"torch.{complex_name}" == f"torch.{want.dtype}"
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_parts_raise_as_in_jax():
    """torch has no bf16 complex and jax.lax.complex refuses bf16 parts:
    both index_to_value and awgn raise TypeError for a bf16 dtype."""
    qam, jqam = QAMAlphabet(4, 2.0), JQAM(4, 2.0)
    idx = np.zeros((2, 4), np.int32)
    with pytest.raises(TypeError):
        jqam.index_to_value((jnp.asarray(idx[0]), jnp.asarray(idx[1])),
                            jnp.bfloat16)
    with pytest.raises(TypeError):
        qam.index_to_value((torch.from_numpy(idx[0]),
                            torch.from_numpy(idx[1])), torch.bfloat16)
    with pytest.raises(TypeError):
        jqam.awgn(jax.random.key(0), jnp.zeros(4, jnp.complex64), 0.1,
                  jnp.bfloat16)
    with pytest.raises(TypeError):
        qam.awgn(torch.Generator().manual_seed(0),
                 torch.zeros(4, dtype=torch.complex64), 0.1, torch.bfloat16)


def test_awgn_splits_the_total_variance_over_the_quadratures():
    qam = QAMAlphabet(4, 2.0)
    noise = qam.awgn(torch.Generator().manual_seed(3),
                     torch.zeros(1 << 16, dtype=torch.complex64), 0.5)
    assert noise.dtype == torch.complex64
    re, im = qam.quadrature_streams(noise)
    for part in (re, im):
        assert float(part.var()) == pytest.approx(0.25, rel=0.03)
    assert abs(float(torch.mean(re * im))) < 0.01


def test_bit_layout_equals_jax():
    qam, jqam = QAMAlphabet(4, 2.0), JQAM(4, 2.0)
    i_idx, q_idx = np.array([[0, 1, 2, 3]]), np.array([[3, 2, 1, 0]])
    bits = qam.demap_symbols_to_bits((torch.from_numpy(i_idx),
                                      torch.from_numpy(q_idx))).numpy()
    s2b = qam.pam.s_to_b
    expect = []
    for i, q in zip([0, 1, 2, 3], [3, 2, 1, 0]):
        expect.extend(list(s2b[i]) + list(s2b[q]))
    np.testing.assert_array_equal(bits[0], np.asarray(expect, np.uint8))
    rng = np.random.default_rng(2)
    for bps in (2, 4, 6):
        qam, jqam = QAMAlphabet(bps, 2.0), JQAM(bps, 2.0)
        i_idx, q_idx = rng.integers(0, qam.pam.order, (2, 3, 5))
        got = qam.demap_symbols_to_bits((torch.from_numpy(i_idx),
                                         torch.from_numpy(q_idx)))
        want = jqam.demap_symbols_to_bits((jnp.asarray(i_idx),
                                           jnp.asarray(q_idx)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_interleave_equals_jax():
    qam, jqam = QAMAlphabet(4, 2.0), JQAM(4, 2.0)
    rng = np.random.default_rng(0)
    S = 16
    li, lq = rng.normal(0, 1, (2, 2, S * 2))
    out = qam.interleave_llrs(torch.from_numpy(li), torch.from_numpy(lq))
    assert out.shape == (2, S * 4)
    np.testing.assert_array_equal(out[0, :2].numpy(), li[0, :2])
    np.testing.assert_array_equal(out[0, 2:4].numpy(), lq[0, :2])
    want = jqam.interleave_llrs(jnp.asarray(li), jnp.asarray(lq))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_qam_softening_reconciliation_end_to_end():
    """Full 16-QAM reverse reconciliation via two PAM quadrature pipelines,
    the port and JAX on the same complex samples: Bob's word equals JAX's,
    Alice's interleaved softening LLRs agree within 1e-9 (float64), and
    both decodes succeed on every frame with the word's bits."""
    n = 240
    vid, cid = make_regular_ldpc(n, 3, 6, seed=19)
    qam, jqam = QAMAlphabet(4, 2.0), JQAM(4, 2.0)
    snr_db = 16.0                      # per-symbol Es/N0 (16-QAM needs more)
    N0 = qam.variance * 10 ** (-snr_db / 10) / 2
    B, S = 8, n // qam.bit_per_symbol  # complex symbols per frame
    rng = np.random.default_rng(5)
    iq = rng.integers(0, qam.pam.order, (2, B, S))
    y = (qam.pam.constellation[iq[0]] + 1j * qam.pam.constellation[iq[1]]
         + math.sqrt(N0 / 2) * (rng.normal(size=(B, S))
                                + 1j * rng.normal(size=(B, S))))
    nm = NoiseMapper(qam.pam, N0 / 2, dtype=torch.float64, device="cpu")
    jnm = JNM(jqam.pam, N0 / 2, dtype=jnp.float64)

    def bob_alice(q, m, to, streams):
        yi, yq = streams
        xi_hat, xq_hat = m.hard_decide_index(yi), m.hard_decide_index(yq)
        word = q.demap_symbols_to_bits((xi_hat, xq_hat))
        llrs = []
        for stream, x_hat, sent in ((yi, xi_hat, iq[0]), (yq, xq_hat, iq[1])):
            bits = m._table_llr_bits(m.map_noise(stream, x_hat), to(sent))
            llrs.append(np.stack([np.asarray(b) for b in bits], -1)
                        .reshape(B, -1))
        return np.asarray(word), llrs

    word, (li, lq) = bob_alice(
        qam, nm, torch.from_numpy,
        qam.quadrature_streams(torch.from_numpy(y)))
    jword, (jli, jlq) = bob_alice(
        jqam, jnm, jnp.asarray, jqam.quadrature_streams(jnp.asarray(y)))
    np.testing.assert_array_equal(word, jword)
    lappr = qam.interleave_llrs(torch.from_numpy(li), torch.from_numpy(lq))
    jlappr = np.asarray(jqam.interleave_llrs(jnp.asarray(jli),
                                             jnp.asarray(jlq)))
    np.testing.assert_allclose(lappr.numpy(), jlappr, rtol=1e-9, atol=1e-9)

    synd = Matrix(vid, cid).eval_syndrome(torch.from_numpy(word))
    jsynd = np.asarray(JMatrix(vid, cid).eval_syndrome(jword))
    np.testing.assert_array_equal(synd.numpy(), jsynd)
    success, _, final = Decoder(vid, cid, torch.float64,
                                device="cpu").decode_batch(lappr, synd, 30)
    jsuccess, _, jfinal = JDecoder(vid, cid, dtype=jnp.float64).decode_batch(
        jlappr, jsynd, 30)
    assert bool(success.all()) and bool(jnp.all(jsuccess))
    np.testing.assert_array_equal((final.numpy() < 0).astype(np.uint8), word)
    np.testing.assert_array_equal(np.asarray(jfinal) < 0,
                                  final.numpy() < 0)
