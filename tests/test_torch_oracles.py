"""Port parity: the numpy float64 oracles and the statistical BER tier.

* ``models/decoder_np.DecoderNp`` and ``utils/reference_np`` are numpy
  copies of the JAX package's: on the same inputs they give the same bits
  (the decoder) and the same frames (the softening chain, built on the
  port's ``NoiseMapper`` host tables).
* Three-way parity (tests/test_decoder_np.py): the oracle against the
  port's generic ``Decoder`` and its dense ``QCDecoder``, float64: success
  and iters equal, finals within 1e-6 (tanh form against phi form).
* The numpy-oracle tier of tests/test_qc_decoder.py: the port's float64
  layered QC decode (serial and grouped sweeps) against an independent
  numpy implementation of the serial-C schedule, within 1e-9.
* tests/test_ber_equivalence.py: the port's engine BER (float64, interp
  LLRs) against ``softening_frames_np`` + ``DecoderNp`` within 4 joint
  Monte-Carlo standard errors, taken from the measured per-frame BER
  variance (different RNGs, the same configuration); an undecoded control
  falls outside that limit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models.decoder_np import DecoderNp as JDecoderNp
from qamreconciliation_tpu.models.noisemapper import NoiseMapper as JNM
from qamreconciliation_tpu.models.alphabet import PAMAlphabet as JPAM
from qamreconciliation_tpu.utils.reference_np import (
    softening_chain_np as j_chain, softening_frames_np as j_frames,
)
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.decoder_np import DecoderNp
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, layered_plan, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine
from qamreconciliation_tpu_torch.utils.edgefile import make_regular_ldpc
from qamreconciliation_tpu_torch.utils.reference_np import (
    softening_chain_np, softening_frames_np,
)

torch.set_num_threads(1)

REGULAR = make_regular_ldpc(96, 3, 6, seed=13)


def word_frame(dec, rng, scale, noise):
    """A random word's syndrome and its channel LLRs."""
    word = rng.integers(0, 2, dec.vnum)
    return dec.eval_syndrome(word), \
        (1 - 2 * word) * scale + rng.normal(0, noise, dec.vnum)


def test_decoder_np_is_the_jax_oracle():
    """The port's copy decodes bit for bit as the JAX package's."""
    dec, jdec = DecoderNp(*REGULAR), JDecoderNp(*REGULAR)
    rng = np.random.default_rng(21)
    for _ in range(6):
        synd, llr = word_frame(dec, rng, 3.5, 2.5)
        bits = (llr < 0).astype(np.int64)
        np.testing.assert_array_equal(dec.eval_syndrome(bits),
                                      jdec.eval_syndrome(bits))
        got, want = dec.decode(llr, synd, 25), jdec.decode(llr, synd, 25)
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("which", ["generic", "qc"])
def test_three_way_decoder_parity(which):
    """The oracle (tanh form) against the port's float64 decoders (phi
    form): success and iters equal, finals within 1e-6."""
    if which == "generic":
        vid, cid = REGULAR
        port = Decoder(vid, cid, torch.float64, device="cpu")
    else:
        base, vid, cid = make_qc_ldpc(8, 12, 3, 6, seed=2)
        port = QCDecoder(base, 12, torch.float64, device="cpu")
    oracle = DecoderNp(vid, cid)
    rng = np.random.default_rng(21)
    agree = 0
    for _ in range(8):
        synd, llr = word_frame(oracle, rng, 2.0, 2.0)
        s_np, i_np, f_np = oracle.decode(llr, synd, 25)
        s, i, f = port.decode_batch(torch.from_numpy(llr[None]),
                                    torch.from_numpy(synd[None]), 25)
        assert bool(s[0]) == s_np and int(i[0]) == i_np
        np.testing.assert_allclose(f[0].numpy(), f_np, rtol=1e-6, atol=1e-6)
        agree += s_np
    assert 0 < agree < 8


def test_numpy_decoder_consistency_semantics():
    dec = DecoderNp(*REGULAR)
    rng = np.random.default_rng(5)
    word = rng.integers(0, 2, dec.vnum)
    synd = dec.eval_syndrome(word)
    llr = (1 - 2 * word) * 6.0
    success, iters, final = dec.decode(llr, synd, 10)
    assert success and iters == 0
    np.testing.assert_array_equal(final, llr)
    success, iters, _ = dec.decode(rng.normal(0, 0.5, dec.vnum), synd, 4)
    assert not success and iters == 4
    with pytest.raises(ValueError, match="size"):
        dec.decode(llr[:-1], synd, 4)


def test_first_row_convention():
    vid, cid = REGULAR
    E = vid.size
    dec = DecoderNp(np.concatenate([[E], vid]),
                    np.concatenate([[int(cid.max()) + 1], cid]),
                    num_data_first_row=True)
    assert dec.ednum == E and dec.cnum == int(cid.max()) + 1
    with pytest.raises(ValueError, match="match"):
        DecoderNp(vid, cid[:-1])


@pytest.mark.parametrize("bps,signs", [(2, [0, 1, 0, 1]), (4, None)])
def test_softening_oracle_matches_jax(bps, signs):
    """The port's softening chain on the port's NoiseMapper tables gives the
    JAX chain's frames: the words exactly, the LLRs within 1e-9."""
    snr = 5.0 if bps == 2 else 14.0
    pa, jpa = PAMAlphabet(bps, 2.0), JPAM(bps, 2.0)
    N0 = pa.variance * 10 ** (-snr / 10) / 2
    nm = NoiseMapper(pa, N0, signs, dtype=torch.float64, device="cpu")
    jnm = JNM(jpa, N0, signs, dtype=jnp.float64)
    lappr, word = softening_frames_np(nm, pa, 6, 40, seed=4)
    jl, jw = j_frames(jnm, jpa, 6, 40, seed=4)
    np.testing.assert_array_equal(word, jw)
    np.testing.assert_allclose(lappr, jl, rtol=1e-9, atol=1e-9)
    assert word.shape == (6, 40 * bps) and np.isfinite(lappr).all()
    rng = np.random.default_rng(1)
    x = rng.integers(0, pa.order, (2, 8))
    y = pa.constellation[x] + 0.3 * rng.standard_normal(x.shape)
    got, want = softening_chain_np(nm, pa, x, y), j_chain(jnm, jpa, x, y)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)


# --------------------------------------------- the numpy-oracle QC tier


def layered_np(prior, synd, rows, z, sweeps, rule="sumproduct",
               alpha=0.8125, order=None):
    """Independent numpy float64 oracle of the serial-C layered schedule
    (the one of tests/test_qc_decoder.py): check block cb's row j gathers
    roll(total[vb], s), updates its extrinsics (phi sum-product or
    normalized min-sum) with the syndrome prefactor, and folds the message
    delta into the totals at once; blocks in ``order``, strictly
    serially."""
    total = prior.astype(np.float64).copy()
    c2v = [np.zeros((len(row), z, prior.shape[-1])) for row in rows]
    order = list(range(len(rows))) if order is None else list(order)

    def phi(x):
        return -np.log(np.tanh(np.maximum(x, 1e-30) / 2.0))

    for _ in range(sweeps):
        for cb in order:
            row = rows[cb]
            t = np.stack([np.roll(total[v], s, axis=0) for (v, s) in row])
            v2c = t - c2v[cb]
            if rule == "minsum":
                a = np.abs(v2c)
                min1 = a.min(axis=0, keepdims=True)
                is_min = a == min1
                cnt = is_min.sum(axis=0, keepdims=True)
                min2 = np.where(is_min, 1e30, a).min(axis=0, keepdims=True)
                mag = alpha * np.where(is_min & (cnt == 1), min2, min1)
            else:
                phim = phi(np.abs(v2c))
                mag = phi(phim.sum(axis=0, keepdims=True) - phim)
            neg = (v2c < 0).astype(np.int64)
            parity = neg.sum(axis=0, keepdims=True) & 1
            new = (1 - 2 * (parity ^ neg)) \
                * (1 - 2 * synd[cb].astype(np.int64))[None] * mag
            delta = new - c2v[cb]
            for d, (v, s) in enumerate(row):
                total[v] += np.roll(delta[d], -s, axis=0)
            c2v[cb] = new
    return total


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("rule", ["sumproduct", "minsum"])
def test_layered_matches_numpy_oracle(rule, grouped):
    """Two sweeps of the port's float64 layered decode on frames too noisy
    to converge (so the finals are the totals after the second sweep)
    against the numpy oracle; the grouped sweep against the oracle run in
    its plan's row order (rows of a batch touch disjoint variables)."""
    nb_v, z = (40, 8) if grouped else (12, 16)
    base, vid, cid = make_qc_ldpc(nb_v, z, 3, 6, seed=21 if grouped else 4)
    dec = QCDecoder(base, z, torch.float64, device="cpu", schedule="layered",
                    check_rule=rule, layered_groups=grouped)
    rng = np.random.default_rng(11)
    B = 5
    word = rng.integers(0, 2, (B, dec.vnum))
    synd = Matrix(vid, cid).eval_syndrome(torch.from_numpy(word)).numpy()
    llr = rng.normal(0, 2.0, (B, dec.vnum))
    s, _, f = dec.decode_batch(torch.from_numpy(llr), torch.from_numpy(synd),
                               2)
    assert not bool(s.any())
    order = list(range(dec.nb_c))
    if grouped:
        order = [cb for _, cbs in layered_plan(dec._rows) for cb in cbs]
        assert sorted(order) == list(range(dec.nb_c))
    want = layered_np(llr.T.reshape(dec.nb_v, z, B),
                      synd.T.reshape(dec.nb_c, z, B), dec._rows, z, 2,
                      rule=rule, order=order).reshape(dec.vnum, B)
    np.testing.assert_allclose(f.numpy().T, want, rtol=1e-9, atol=1e-9)


# --------------------------------------------------- BER equivalence


def test_softening_ber_matches_oracle_chain():
    """The port's engine (float64, interp LLRs, 512 frames) and the oracle
    chain (softening_frames_np + DecoderNp, 256 frames, as the JAX test) at
    4 dB on a (3,6) code of 512 bits.  Bit errors correlate within a frame,
    so the standard error of each BER comes from the per-frame BER
    variance measured on the oracle's frames (both sides draw frames of one
    distribution); the BERs agree within 4 standard errors of their
    difference.  A control that does not decode (the hard decisions of
    the oracle frames' LLRs) falls outside that limit."""
    n, snr_db, maxiter = 512, 4.0, 30
    vid, cid = make_regular_ldpc(n, 3, 6, seed=17)
    pa = PAMAlphabet(2, 2.0)
    N0 = pa.variance * 10 ** (-snr_db / 10) / 2
    eng = ReconciliationEngine(
        Decoder(vid, cid, torch.float64, device="cpu"), Matrix(vid, cid),
        pa, batch=64, dtype=torch.float64, llr_mode="interp")
    frames_eng = 512
    r = eng.run_point("softening", snr_db, maxiter, frames_eng, 10 ** 9,
                      nmconfig=np.zeros(4, np.uint8), seed=3)
    K = eng.K
    nm = NoiseMapper(pa, N0, dtype=torch.float64, device="cpu")
    oracle = DecoderNp(vid, cid)
    frames_ora = 128
    lappr, word = softening_frames_np(nm, pa, frames_ora, eng.N_symb,
                                      seed=11)
    ber_frame = np.empty(frames_ora)
    for f in range(frames_ora):
        _, _, final = oracle.decode(lappr[f], oracle.eval_syndrome(word[f]),
                                    maxiter)
        ber_frame[f] = np.mean((final[:K] < 0) != word[f, :K])
    ber_ora = float(ber_frame.mean())
    ber_raw = float(np.mean((lappr[:, :K] < 0) != word[:, :K]))

    se = float(ber_frame.std(ddof=1)) * math.sqrt(1 / frames_eng
                                                  + 1 / frames_ora)
    tol = 4.0 * se
    # engine 0.02866 and oracle 0.02936 against a limit of 0.01647; the
    # undecoded control is 0.1189
    assert abs(r.ber - ber_ora) < tol, (r.ber, ber_ora, tol)
    assert abs(ber_raw - ber_ora) > tol, (ber_raw, ber_ora, tol)
    assert 0.0 < r.ber < 0.4 and 0.0 < ber_ora < 0.4
