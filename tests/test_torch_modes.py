"""Port parity: the hard reverse and soft direct reconciliation modes.

* With injected ``(x, y)`` the port's hard and direct round counters equal
  the JAX round composed from its public pieces (exact integer counters):
  the dense QC decoder (min-sum, f32 sum-product), the generic ``Decoder``
  and the layered schedule (min-sum).
* The bare-LLR table, its lookup and ``demap_symbols_to_bits`` equal JAX's.
* ``run_point("hard" | "direct")`` BER/FER agree with the JAX engine within
  4 Monte-Carlo standard errors; direct beats hard at equal SNR; the
  reference-API wrappers return the run point's tuple.
* The compressed-state min-sum decoder (``compressed=True``) runs both
  modes with counters equal to JAX's on injected samples.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models.alphabet import PAMAlphabet as JPAM
from qamreconciliation_tpu.models.decoder import Decoder as JDecoder
from qamreconciliation_tpu.models.matrix import Matrix as JMatrix
from qamreconciliation_tpu.models.noisemapper import NoiseMapper as JNM
from qamreconciliation_tpu.models.qc_decoder import QCDecoder as JQC
from qamreconciliation_tpu.ops.llr import y_to_lappr_gray_bits as j_gray_bits
from qamreconciliation_tpu.sims.engine import ReconciliationEngine as JEngine
from qamreconciliation_tpu_torch import sims
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine
from qamreconciliation_tpu_torch.utils.edgefile import make_regular_ldpc

torch.set_num_threads(1)

QC = make_qc_ldpc(24, 32, 3, 6, seed=3)            # N = 768, z = 32
REGULAR = make_regular_ldpc(768, 3, 6, seed=9)
# an operating point of each mode where some frames decode and some fail
SNR = {"hard": 5.5, "direct": 4.0}

DECODERS = {
    "qc-minsum": (lambda: JQC(QC[0], 32, dtype=jnp.float32, use_pallas=False,
                              check_rule="minsum"),
                  lambda: QCDecoder(QC[0], 32, torch.float32, device="cpu",
                                    check_rule="minsum"), QC[1:]),
    "qc-sumproduct": (lambda: JQC(QC[0], 32, dtype=jnp.float32,
                                  use_pallas=False),
                      lambda: QCDecoder(QC[0], 32, torch.float32,
                                        device="cpu"), QC[1:]),
    "generic": (lambda: JDecoder(*REGULAR, dtype=jnp.float32),
                lambda: Decoder(*REGULAR, torch.float32, device="cpu"),
                REGULAR),
    "qc-compressed": (lambda: JQC(QC[0], 32, dtype=jnp.float32,
                                  check_rule="minsum", compressed=True),
                      lambda: QCDecoder(QC[0], 32, torch.float32,
                                        device="cpu", check_rule="minsum",
                                        compressed=True), QC[1:]),
    "layered-minsum": (lambda: JQC(QC[0], 32, dtype=jnp.float32,
                                   schedule="layered", layered_chunk=3,
                                   check_rule="minsum"),
                       lambda: QCDecoder(QC[0], 32, torch.float32,
                                         device="cpu", schedule="layered",
                                         layered_chunk=3,
                                         check_rule="minsum"), QC[1:]),
}


_ENGINES = {}


def engines(name, B):
    """The (JAX, port) engine pair on decoder ``name``, built once per
    module (the JAX decoder compiles its decode once for both modes)."""
    if (name, B) not in _ENGINES:
        jdec, tdec, (vid, cid) = DECODERS[name]
        jeng = JEngine(jdec(), JMatrix(vid, cid), JPAM(2, 2.0), batch=B,
                       dtype=jnp.float32)
        teng = ReconciliationEngine(tdec(), Matrix(vid, cid),
                                    PAMAlphabet(2, 2.0), batch=B,
                                    dtype=torch.float32)
        _ENGINES[name, B] = jeng, teng
    return _ENGINES[name, B]


def jax_round(eng, mode, nm, x, y, sigma, maxiter):
    """The JAX hard or direct round body composed from its public pieces,
    with (x, y) injected in place of its sampler."""
    s2b = jnp.asarray(eng.pa.s_to_b.astype(np.int32))
    if mode == "hard":
        x_hat = nm.hard_decide_index(y)
        word = eng._bits_nb(lambda b, idx: s2b[:, b][idx], x_hat)
        lappr = eng._bits_nb(lambda b, _: nm._bare_llr[:, b][x], x_hat)
    else:
        word = eng._bits_nb(lambda b, idx: s2b[:, b][idx], x)
        two_var = 2.0 * jnp.asarray(sigma, eng.dtype) ** 2
        llr_bits = j_gray_bits(y, eng.pa.constellation, two_var, eng.dtype)
        lappr = eng._bits_nb(lambda b, _: llr_bits[b], x)
    return np.asarray(
        eng._decode_and_count_nb(lappr, word, jnp.int32(maxiter))
    )


@pytest.mark.parametrize("mode", ["hard", "direct"])
@pytest.mark.parametrize("name", DECODERS)
def test_round_counters_equal_jax_on_injected_samples(name, mode):
    B, maxiter = 16, 20
    jeng, teng = engines(name, B)
    snr = SNR[mode]
    N0 = teng.noise_var(snr)
    sigma = math.sqrt(N0)
    rng = np.random.default_rng(11)
    x = rng.integers(0, 4, (teng.N_symb, B)).astype(np.int32)
    y = (teng.pa.constellation[x]
         + sigma * rng.normal(size=x.shape)).astype(np.float32)
    jnm = JNM(jeng.pa, N0, None, dtype=jnp.float32) if mode == "hard" \
        else None
    want = jax_round(jeng, mode, jnm, jnp.asarray(x), jnp.asarray(y), sigma,
                     maxiter)
    nm = NoiseMapper(teng.pa, N0, None, dtype=torch.float32, device="cpu") \
        if mode == "hard" else None
    got = teng.round(mode, nm, sigma, 1.0, maxiter,
                     xy=(torch.from_numpy(x), torch.from_numpy(y))).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want[3] < B          # some frames decode, some fail


def test_hard_round_reads_the_bare_llr_of_the_sent_symbol():
    """The hard round's LLRs are the table's rows of Alice's sent symbols,
    not of Bob's decisions: on samples where they differ, swapping the two
    changes the LLRs."""
    _, teng = engines("qc-minsum", 4)
    N0 = teng.noise_var(2.0)
    nm = NoiseMapper(teng.pa, N0, None, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 4, (teng.N_symb, 4)))
    y = torch.from_numpy(teng.pa.constellation[x.numpy()]
                         + math.sqrt(N0) * rng.normal(size=x.shape)).float()
    lappr, _ = teng._hard_inputs(nm, x, y)
    x_hat = nm.hard_decide_index(y)
    assert bool((x_hat != x.int()).any())
    want = teng._bits_nb(lambda b, _: nm._bare_llr[:, b][x.long()], x)
    wrong = teng._bits_nb(lambda b, _: nm._bare_llr[:, b][x_hat.long()], x)
    assert torch.equal(lappr, want) and not torch.equal(lappr, wrong)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bps", [1, 2, 3, 4])
def test_bare_llr_table_and_lookup_equal_jax(bps, dtype):
    pa, jpa = PAMAlphabet(bps, 2.0), JPAM(bps, 2.0)
    N0 = pa.variance * 10 ** (-6.0 / 10) / 2
    nm = NoiseMapper(pa, N0, None, dtype=dtype, device="cpu")
    jnm = JNM(jpa, N0, None, dtype=jnp.dtype(dtype))
    np.testing.assert_array_equal(nm.bare_llr_table, jnm.bare_llr_table)
    symb = np.random.default_rng(bps).integers(0, pa.order, (3, 10))
    got = nm.bare_llr(torch.from_numpy(symb))
    want = np.asarray(jnm.bare_llr(jnp.asarray(symb)).astype(jnp.float32))
    assert got.dtype == nm.dtype and got.shape == (3, 10 * bps)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        nm._bare_llr.float().numpy(),
        np.asarray(jnm._bare_llr.astype(jnp.float32)))


@pytest.mark.parametrize("bps", [1, 2, 3, 4])
def test_demap_symbols_to_bits_equals_jax(bps):
    symb = np.random.default_rng(bps).integers(0, 1 << bps, (5, 7))
    got = PAMAlphabet(bps, 2.0).demap_symbols_to_bits(torch.from_numpy(symb))
    want = np.asarray(JPAM(bps, 2.0).demap_symbols_to_bits(
        jnp.asarray(symb)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["hard", "direct"])
def test_run_point_statistically_equals_jax(mode):
    B, maxiter, frames = 64, 20, 384
    jeng, teng = engines("qc-sumproduct", B)
    snr = SNR[mode]
    rj = jeng.run_point(mode, snr, maxiter, frames, 10 ** 9, seed=5)
    rt = teng.run_point(mode, snr, maxiter, frames, 10 ** 9, seed=5)
    assert rj.frames == rt.frames == frames
    assert rt.bp_iterations > 0
    se_fer = math.sqrt(sum(r.fer * (1 - r.fer) / r.frames for r in (rj, rt)))
    # per-frame error fractions lie in [0, 1], so var <= mean: a
    # conservative BER standard error for frame-clustered bit errors
    se_ber = math.sqrt(sum(r.ber / r.frames for r in (rj, rt)))
    assert 0.05 < rj.fer < 0.95
    assert abs(rt.fer - rj.fer) <= 4 * se_fer, (rt.fer, rj.fer, se_fer)
    assert abs(rt.ber - rj.ber) <= 4 * se_ber, (rt.ber, rj.ber, se_ber)


def test_direct_beats_hard_at_equal_snr():
    _, teng = engines("qc-sumproduct", 64)
    r_direct = teng.run_point("direct", 5.0, 20, 256, 10 ** 9, seed=2)
    r_hard = teng.run_point("hard", 5.0, 20, 256, 10 ** 9, seed=2)
    assert 0.0 <= r_direct.ber <= 1.0 and 0.0 <= r_hard.ber <= 1.0
    assert r_hard.fer > 0.05
    assert r_direct.fer < r_hard.fer and r_direct.ber < r_hard.ber


@pytest.mark.parametrize("mode", ["softening", "hard", "direct"])
def test_reference_api_wrappers(mode):
    vid, cid = QC[1:]
    args = dict(decoder_iterations=10, simulation_loops=32,
                ferr_count_min=10 ** 9)

    def dec():
        return QCDecoder(QC[0], 32, torch.float32, device="cpu",
                         check_rule="minsum")

    mat, pa = Matrix(vid, cid), PAMAlphabet(2, 2.0)
    kw = dict(batch=16)
    if mode == "softening":
        cfg = np.array([0, 1, 0, 1], np.uint8)
        got = sims.simulate_softening_snr_dB(4.5, dec(), mat, pa, cfg,
                                             alpha=1.0, **args, **kw)
        want = ReconciliationEngine(dec(), mat, pa, **kw).run_point(
            mode, 4.5, 10, 32, 10 ** 9, nmconfig=cfg)
    else:
        fn = {"hard": sims.simulate_hard_reverse_snr_dB,
              "direct": sims.simulate_direct_snr_dB}[mode]
        got = fn(4.5, dec(), mat, pa, **args, **kw)
        want = ReconciliationEngine(dec(), mat, pa, **kw).run_point(
            mode, 4.5, 10, 32, 10 ** 9)
    assert isinstance(got, tuple) and len(got) == 4 and got[0] == 4.5
    assert got == want.as_tuple()
    assert sims.y_to_lappr_grey_array is sims.y_to_lappr_gray


def test_unknown_mode_raises():
    _, teng = engines("qc-minsum", 16)
    with pytest.raises(ValueError, match="mode"):
        teng.run_point("bogus", 4.0, 5, 16, 1)


