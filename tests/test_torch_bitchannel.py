"""Port parity: the bit-channel engine (sims/bitchannel.py) and its CLIs.

* On injected words, flips and noise, the BSC and BI-AWGN (soft and hard)
  LLRs equal the JAX formulas element for element and the round counters
  equal the JAX round composed from its public pieces (exact integer
  counters), on the dense QC decoder (min-sum f32 and bf16, f32
  sum-product) and the generic ``Decoder``; a bf16 sample that rounds to
  exactly 0 gets the LLR 0 (``sign(0)``) in both.
* Run points agree with the JAX engine within 4 Monte-Carlo standard
  errors.
* The three stopping rules on scripted counters; the int32 guard.
* ``sim_bsc``, ``sim_decode`` and ``sim_direct`` write the JAX CSV headers
  with ``--qc``, ``--lift-qc`` and the expanded edge list (``--device
  cpu``), and resume from their journal.
"""

import csv
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models.decoder import Decoder as JDecoder
from qamreconciliation_tpu.models.matrix import Matrix as JMatrix
from qamreconciliation_tpu.models.qc_decoder import QCDecoder as JQC
from qamreconciliation_tpu.sims.bitchannel import BitChannelEngine as JBC
from qamreconciliation_tpu.sims.engine import _decode_inline
from qamreconciliation_tpu.utils.scalar import count_errors_from_lappr
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc, save_qc_csv,
)
from qamreconciliation_tpu_torch.sims import sim_bsc, sim_decode, sim_direct
from qamreconciliation_tpu_torch.sims.bitchannel import BitChannelEngine
from qamreconciliation_tpu_torch.sims.common import load_decoder
from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine
from qamreconciliation_tpu_torch.utils.checkpoint import SweepState
from qamreconciliation_tpu_torch.utils.edgefile import (
    make_regular_ldpc, save_edge_csv,
)

torch.set_num_threads(1)

QC = make_qc_ldpc(24, 32, 3, 6, seed=3)            # N = 768, z = 32
REGULAR = make_regular_ldpc(768, 3, 6, seed=9)
B = 16

DECODERS = {
    "qc-minsum": (lambda: JQC(QC[0], 32, dtype=jnp.float32, use_pallas=False,
                              check_rule="minsum"),
                  lambda: QCDecoder(QC[0], 32, torch.float32, device="cpu",
                                    check_rule="minsum"), QC[1:], "float32"),
    "qc-minsum-bf16": (lambda: JQC(QC[0], 32, dtype=jnp.bfloat16,
                                   use_pallas=False, check_rule="minsum"),
                       lambda: QCDecoder(QC[0], 32, torch.bfloat16,
                                         device="cpu", check_rule="minsum"),
                       QC[1:], "bfloat16"),
    "qc-sumproduct": (lambda: JQC(QC[0], 32, dtype=jnp.float32,
                                  use_pallas=False),
                      lambda: QCDecoder(QC[0], 32, torch.float32,
                                        device="cpu"), QC[1:], "float32"),
    "generic": (lambda: JDecoder(*REGULAR, dtype=jnp.float32),
                lambda: Decoder(*REGULAR, torch.float32, device="cpu"),
                REGULAR, "float32"),
}
# (channel, point) where some frames of the small codes decode, some fail
CHANNELS = {"bsc": 0.07, "biawgn-soft": -1.5, "biawgn-hard": 0.5}
_ENGINES = {}


def engines(name, batch=B):
    """The (JAX, port) bit-channel engines on decoder ``name``, built once
    (the JAX decoder compiles its decode once for every channel)."""
    if (name, batch) not in _ENGINES:
        jdec, tdec, (vid, cid), dtype = DECODERS[name]
        _ENGINES[name, batch] = (
            JBC(jdec(), JMatrix(vid, cid), batch=batch,
                dtype=jnp.dtype(dtype)),
            BitChannelEngine(tdec(), Matrix(vid, cid), batch=batch,
                             dtype=dtype))
    return _ENGINES[name, batch]


def jax_llrs(jeng, channel, point, word_bn, second_bn):
    """The JAX rounds' LLR formulas ([B, N]) on injected inputs."""
    dt = jeng.dtype
    word = jnp.asarray(word_bn, jnp.int32)
    if channel == "bsc":
        rx = word ^ jnp.asarray(second_bn, jnp.int32)
        llr0 = math.log2(1.0 - point) - math.log2(point)
        return jnp.asarray(llr0, dt) * (1.0 - 2.0 * rx).astype(dt)
    from scipy.special import erfc

    v = (10.0 ** (-point / 10.0)) / 2.0
    tx = (1.0 - 2.0 * word).astype(dt)
    rx = tx + jnp.asarray(math.sqrt(v), dt) * jnp.asarray(second_bn, dt)
    if channel == "biawgn-hard":
        p = 0.5 * erfc(1.0 / (math.sqrt(2.0) * math.sqrt(v)))
        return jnp.asarray(float(np.log((1.0 - p) / p)), dt) * jnp.sign(rx)
    return jnp.asarray(2.0 / v, dt) * rx


def jax_round(jeng, channel, point, word_bn, second_bn, maxiter):
    """The JAX bit-channel round composed from its public pieces."""
    word = jnp.asarray(word_bn, jnp.int32)
    synd = jeng._synd_vb(word.T).T
    lappr = jax_llrs(jeng, channel, point, word_bn, second_bn)
    success, iters, final = _decode_inline(jeng.dec, lappr, synd,
                                           jnp.int32(maxiter))
    span = jeng.N if channel == "bsc" else jeng.K
    errors = count_errors_from_lappr(final[:, :span], word[:, :span])
    return np.asarray(jnp.stack([
        jnp.sum(errors), jnp.sum(errors > 0),
        jnp.sum(jnp.where(success, iters, 0)), jnp.sum(success),
    ]))


def inputs(channel, N, dtype, seed):
    """A word [B, N] and its flips (BSC) or standard normal noise, the
    noise rounded to the dtype."""
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 2, (B, N)).astype(np.int32)
    if channel == "bsc":
        return word, (rng.random((B, N)) < CHANNELS["bsc"]).astype(np.int32)
    noise = torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32))
    return word, noise.to(dtype).float().numpy()


def port_inputs(word, second, teng):
    dt = torch.int32 if second.dtype == np.int32 else teng.dtype
    return (torch.from_numpy(word.T.copy()),
            torch.from_numpy(second.T.copy()).to(dt))


@pytest.mark.parametrize("channel", CHANNELS)
@pytest.mark.parametrize("name", DECODERS)
def test_round_counters_equal_jax_on_injected_inputs(name, channel):
    maxiter, point = 20, CHANNELS[channel]
    jeng, teng = engines(name)
    word, second = inputs(channel, teng.N, teng.dtype, seed=17)
    want = jax_round(jeng, channel, point, word, second, maxiter)
    if channel == "bsc":
        got = teng.bsc_round(point, maxiter,
                             inputs=port_inputs(word, second, teng))
    else:
        got = teng.biawgn_round(point, maxiter,
                                hard=channel == "biawgn-hard",
                                inputs=port_inputs(word, second, teng))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want[3] < B          # some frames decode, some fail


@pytest.mark.parametrize("channel", CHANNELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_llrs_equal_jax(dtype, channel):
    jeng, teng = engines("qc-minsum" if dtype == "float32"
                         else "qc-minsum-bf16")
    point = CHANNELS[channel]
    word, second = inputs(channel, teng.N, teng.dtype, seed=3)
    want = np.asarray(jax_llrs(jeng, channel, point, word, second)
                      .astype(jnp.float32))
    w, s = port_inputs(word, second, teng)
    if channel == "bsc":
        got = teng.bsc_llrs(w, s, point)
    else:
        got = teng.biawgn_llrs(w, s, point, hard=channel == "biawgn-hard")
    assert got.dtype == teng.dtype
    np.testing.assert_array_equal(got.float().numpy().T, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hard_llr_of_a_sample_rounding_to_zero_is_zero(dtype):
    """At v = 1/4 (Eb/N0 = 10 log10 2) a bit-0 sample with noise -2 is
    exactly 0: sign(0) = 0, so its hard LLR is 0, in JAX and in the port."""
    jeng, teng = engines("qc-minsum" if dtype == "float32"
                         else "qc-minsum-bf16")
    point = 10 * math.log10(2.0)
    word = np.zeros((B, teng.N), np.int32)
    noise = np.full((B, teng.N), 0.5, np.float32)
    noise[:, ::7] = -2.0
    want = np.asarray(jax_llrs(jeng, "biawgn-hard", point, word, noise)
                      .astype(jnp.float32))
    got = teng.biawgn_llrs(*port_inputs(word, noise, teng), point,
                           hard=True).float().numpy().T
    assert (want[:, ::7] == 0).all() and (got[:, ::7] == 0).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channel", CHANNELS)
def test_run_point_statistically_equals_jax(channel):
    maxiter, frames, point = 20, 384, CHANNELS[channel]
    jeng, teng = engines("qc-sumproduct", 64)
    if channel == "bsc":
        rj = jeng.run_bsc_point(point, maxiter, frames, 10 ** 9)
        rt = teng.run_bsc_point(point, maxiter, frames, 10 ** 9)
    else:
        hard = channel == "biawgn-hard"
        rj = jeng.run_biawgn_point(point, maxiter, frames, 10 ** 9,
                                   hard=hard)
        rt = teng.run_biawgn_point(point, maxiter, frames, 10 ** 9,
                                   hard=hard)
    assert rj.frames == rt.frames == frames
    assert rt.bp_iterations > 0
    se_fer = math.sqrt(sum(r.fer * (1 - r.fer) / r.frames for r in (rj, rt)))
    # per-frame error fractions lie in [0, 1], so var <= mean: a
    # conservative BER standard error for frame-clustered bit errors
    se_ber = math.sqrt(sum(r.ber / r.frames for r in (rj, rt)))
    assert 0.05 < rj.fer < 0.95
    assert abs(rt.fer - rj.fer) <= 4 * se_fer, (rt.fer, rj.fer, se_fer)
    assert abs(rt.ber - rj.ber) <= 4 * se_ber, (rt.ber, rj.ber, se_ber)


# per-round scripted counters [bit errors, frame errors, iterations of
# successes, successes]: the 20 bit errors of round 3 meet ">= 20" but not
# "> 20"; the frame errors reach 20 in round 1
SCRIPT = [(0, 10, 0, 6), (0, 10, 0, 6), (0, 0, 0, 16), (20, 0, 32, 16),
          (20, 0, 32, 16)] + [(0, 0, 16, 16)] * 20


@pytest.mark.parametrize("rule,frames", [
    ("bsc", 96),            # err > 20 at round 4 (and frames > 20), +1 issued
    ("biawgn", 80),         # err >= 20 at round 3 (and frames > 32), +1
    ("reconciliation", 64),  # frame errors >= 20 at round 1, frames > 32 at 2
])
def test_stopping_rules_on_scripted_counters(rule, frames):
    """Each rule stops on the counters of the rounds read so far, one round
    late (the round already issued is counted); BSC divides the BER by N,
    the others by K."""
    simloops, minerr = 640, 20
    script = iter(torch.tensor(c) for c in SCRIPT)
    if rule == "reconciliation":
        eng = ReconciliationEngine(
            QCDecoder(QC[0], 32, device="cpu"), Matrix(*QC[1:]),
            PAMAlphabet(2, 2.0), batch=B)
        eng.round = lambda *a, **k: next(script)
        r = eng.run_point("direct", 4.0, 10, simloops, minerr)
        span = eng.K
    else:
        eng = BitChannelEngine(QCDecoder(QC[0], 32, device="cpu"),
                               Matrix(*QC[1:]), batch=B)
        if rule == "bsc":
            eng.bsc_round = lambda *a, **k: next(script)
            r = eng.run_bsc_point(0.05, 10, simloops, minerr)
            span = eng.N
        else:
            eng.biawgn_round = lambda *a, **k: next(script)
            r = eng.run_biawgn_point(1.0, 10, simloops, minerr)
            span = eng.K
    rounds = SCRIPT[:frames // B]
    assert r.frames == frames
    assert r.ber == sum(c[0] for c in rounds) / (frames * span)
    assert r.fer == sum(c[1] for c in rounds) / frames
    assert r.iters == (sum(c[2] for c in rounds)
                       / sum(c[3] for c in rounds))


def test_int32_guard():
    dec = QCDecoder(QC[0], 32, device="cpu")
    mat = Matrix(*QC[1:])
    limit = 2 ** 31 // mat.vnum                   # batch * N < 2^31
    BitChannelEngine(dec, mat, batch=limit - 1)
    with pytest.raises(ValueError, match="2\\^31"):
        BitChannelEngine(dec, mat, batch=limit + 1)


# --------------------------------------------------------------------- CLIs

@pytest.fixture(scope="module")
def codes(tmp_path_factory):
    d = tmp_path_factory.mktemp("codes")
    edge, qc, expanded = (str(d / n) for n in ("edge.csv", "qc.csv",
                                               "expanded.csv"))
    save_edge_csv(edge, *make_regular_ldpc(120, 3, 6, seed=9))
    base, vid, cid = make_qc_ldpc(12, 8, dv=3, dc=6, seed=3)
    save_qc_csv(qc, base, 8)
    save_edge_csv(expanded, vid, cid)
    return dict(edge=edge, qc=qc, expanded=expanded)


def read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


COMMON = ["--maxiter", "10", "--simloops", "64", "--batch", "32",
          "--device", "cpu"]


@pytest.mark.parametrize("code,flags", [
    ("edge", ["--dtype", "float64"]), ("qc", ["--qc"]),
    ("expanded", ["--lift-qc"]), ("edge", ["--dtype", "bfloat16"]),
])
def test_sim_bsc_writes_the_csv_schema(codes, code, flags, tmp_path):
    out = str(tmp_path / "bsc.csv")
    res = sim_bsc.main([codes[code], "--out", out, "--rber", "0.01", "0.02",
                        "--rpoints", "2", *COMMON, *flags])
    rows = read_csv(out)
    assert rows[0] == ["", "f", "ber", "fer", "iters"]
    assert [float(r[1]) for r in rows[1:]] == [0.01, 0.02]
    assert [r.frames for r in res] == [64, 64]
    assert all(0 <= r.ber <= 1 and r.bp_iterations > 0 for r in res)
    assert not os.path.exists(out + ".partial.jsonl")


def test_lift_qc_engages_the_qc_decoder(codes):
    dec, _, _ = load_decoder(sim_bsc.build_parser().parse_args(
        [codes["expanded"], "--lift-qc", "--device", "cpu"]))
    assert isinstance(dec, QCDecoder) and dec.z == 8


@pytest.mark.parametrize("cli,column", [(sim_decode, "EbN0dB"),
                                        (sim_direct, "EsN0dB")])
@pytest.mark.parametrize("code,flags", [
    ("edge", ["--dtype", "float64"]), ("qc", ["--qc", "--hard"]),
    ("edge", ["--hard", "--first_row"]),
])
def test_sim_decode_and_direct_write_the_csv_schema(codes, cli, column,
                                                    code, flags, tmp_path):
    out = str(tmp_path / "dec.csv")
    res = cli.main([codes[code], "--out", out, "--snr", "3", "3", "--nsnr",
                    "1", *COMMON, *flags])
    rows = read_csv(out)
    # sim_direct's point column is EsN0dB, the reference's quirk
    assert rows[0] == ["", column, "ber", "fer", "iters"]
    assert len(rows) == 2 and float(rows[1][1]) == 3.0
    assert len(res) == 1 and res[0].frames == 64


def test_sim_bsc_resumes_from_its_journal(codes, tmp_path):
    out = str(tmp_path / "resume.csv")
    SweepState(out).record(0.01, dict(ber=0.123, fer=0.5, iters=1.0))
    res = sim_bsc.main([codes["edge"], "--out", out, "--rber", "0.01",
                        "0.02", "--rpoints", "2", "--resume", *COMMON])
    assert res[0].ber == 0.123 and res[1].frames == 64
    assert float(read_csv(out)[1][2]) == 0.123
    assert not os.path.exists(out + ".partial.jsonl")


@pytest.mark.parametrize("cli", [sim_bsc, sim_decode, sim_direct])
def test_clis_default_to_the_card(cli):
    args = cli.build_parser().parse_args(["code.csv"])
    assert args.device == "cuda" and args.first_row is True
