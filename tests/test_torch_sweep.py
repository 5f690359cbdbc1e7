"""Port parity: the sweep plumbing, the per-sample softening round and the
entry round.

* The ``[B, N]`` softening round of ``llr_mode`` "interp"/"search" (the JAX
  package's ``demap_lappr_array`` round): with injected ``(x, y)`` the
  port's counters equal the JAX round composed from its public pieces,
  exactly, for QC min-sum in float32 and QC sum-product in float64.
* ``rounds_per_dispatch``: a dispatch of R rounds draws exactly the frames
  of R single rounds, so an R = 3 run equals an R = 1 run exactly with early
  exit off, in the reconciliation and the bit-channel engines; the ``2^31``
  guards refuse a dispatch whose bit-error sum could pass int32.
* ``run_sweep_batched`` equals the sequential sweep per point, exactly with
  early exit off (dense, layered and generic decoders), and with early exit
  on too (a finished point leaves the batch after the dispatch already
  issued, as ``run_point`` counts it); the CLI's ``--point-batch`` honours
  the resume journal.
* ``run_point``'s ``timer``; ``--profile-dir`` writes a Chrome trace.
* Each new ``sim_reconciliation`` flag agrees with the JAX CLI's BER/FER
  within 4 Monte-Carlo standard errors on a small code (the two draw
  different random streams); ``--rounds-per-dispatch`` on ``sim_bsc``,
  ``sim_decode`` and ``sim_direct`` writes the rows of R = 1.
* ``entry(device="cpu")`` runs one round and its counters lie in range.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models.alphabet import PAMAlphabet as JPAM
from qamreconciliation_tpu.models.matrix import Matrix as JMatrix
from qamreconciliation_tpu.models.noisemapper import NoiseMapper as JNM
from qamreconciliation_tpu.models.qc_decoder import QCDecoder as JQC
from qamreconciliation_tpu.sims import (
    sim_reconciliation as jsim_reconciliation,
)
from qamreconciliation_tpu.sims.engine import ReconciliationEngine as JEngine
from qamreconciliation_tpu_torch import entry as entry_module
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc, save_qc_csv,
)
from qamreconciliation_tpu_torch.sims import (
    sim_bsc, sim_decode, sim_direct, sim_reconciliation,
)
from qamreconciliation_tpu_torch.sims.bitchannel import BitChannelEngine
from qamreconciliation_tpu_torch.sims.engine import (
    ReconciliationEngine, dispatched, point_seed, round_generator,
)
from qamreconciliation_tpu_torch.utils.edgefile import make_regular_ldpc

torch.set_num_threads(1)

QC = make_qc_ldpc(24, 32, 3, 6, seed=3)            # N = 768, z = 32
REGULAR = make_regular_ldpc(768, 3, 6, seed=9)
ALTERNATING = np.array([0, 1, 0, 1], np.uint8)
NO_EXIT = 10 ** 9                                  # ferr_count_min / minerr

# port decoders on the small codes, with their expanded edge lists
DECODERS = {
    "dense": (lambda: QCDecoder(QC[0], 32, torch.float32, device="cpu"),
              QC[1:]),
    "layered": (lambda: QCDecoder(QC[0], 32, torch.float32, device="cpu",
                                  schedule="layered", layered_chunk=3,
                                  check_rule="minsum"), QC[1:]),
    "generic": (lambda: Decoder(*REGULAR, torch.float32, device="cpu"),
                REGULAR),
}


def engine(name="dense", **kw):
    make, (vid, cid) = DECODERS[name]
    return ReconciliationEngine(make(), Matrix(vid, cid), PAMAlphabet(2, 2.0),
                                **kw)


def rows(results):
    return [(r.snr_dB, r.ber, r.fer, r.iters, r.frames) for r in results]


# ---------------------------------------------------------------------------
# The [B, N] softening round


def jax_bn_round(eng, nm, x, y, alpha, maxiter):
    """The JAX package's interp/search softening round body
    (``engine.py:318-333``) with ``(x, y)`` ([B, S]) injected in place of
    its sampler."""
    x_hat = nm.hard_decide_index(y)
    n_hat = nm.map_noise(y, x_hat)
    word = eng.pa.demap_symbols_to_bits(x_hat)
    lappr = jnp.asarray(alpha, eng.dtype) * nm.demap_lappr_array(
        n_hat, x, mode=eng.llr_mode)
    return np.asarray(eng._decode_and_count(lappr, word, jnp.int32(maxiter)))


@pytest.mark.parametrize("llr_mode", ["interp", "search"])
@pytest.mark.parametrize("case", ["minsum-float32", "sumproduct-float64"])
def test_bn_round_counters_equal_jax(case, llr_mode):
    """Exact counters: float32 min-sum with x64 off (the JAX package's
    float32 rules as on an accelerator), float64 sum-product with x64 on."""
    rule, dt = case.split("-")
    B, snr, maxiter = 16, 3.0, 30
    with jax.enable_x64(dt == "float64"):
        jeng = JEngine(JQC(QC[0], 32, dtype=jnp.dtype(dt), use_pallas=False,
                           check_rule=rule),
                       JMatrix(*QC[1:]), JPAM(2, 2.0), batch=B,
                       dtype=jnp.dtype(dt), llr_mode=llr_mode)
        teng = ReconciliationEngine(
            QCDecoder(QC[0], 32, dt, device="cpu", check_rule=rule),
            Matrix(*QC[1:]), PAMAlphabet(2, 2.0), batch=B, dtype=dt,
            llr_mode=llr_mode)
        N0 = teng.noise_var(snr)
        rng = np.random.default_rng(7)
        x = rng.integers(0, 4, (teng.N_symb, B)).astype(np.int32)
        y = (teng.pa.constellation[x] + math.sqrt(N0)
             * rng.normal(size=x.shape)).astype(dt)
        jnm = JNM(jeng.pa, N0, ALTERNATING, dtype=jnp.dtype(dt))
        want = jax_bn_round(jeng, jnm, jnp.asarray(x.T), jnp.asarray(y.T),
                            1.0, maxiter)
        nm = teng.make_noisemapper(snr, ALTERNATING)
        got = teng.softening_round(
            nm, math.sqrt(N0), 1.0, maxiter,
            xy=(torch.from_numpy(x), torch.from_numpy(y))).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want[3] < B          # some frames decode, some fail


def test_bn_round_llrs_are_the_per_sample_llrs_transposed():
    """The round's [N, B] LLRs are ``alpha * demap_lappr_array`` of the
    [B, S] samples, transposed: per-symbol bit blocks along N."""
    teng = engine(batch=8, llr_mode="interp")
    nm = teng.make_noisemapper(3.5, ALTERNATING)
    x, y = teng._sample_sb(round_generator(3, 0, "cpu"),
                           math.sqrt(teng.noise_var(3.5)))
    lappr, word = teng._softening_inputs(nm, x, y, 0.5)
    x_hat = nm.hard_decide_index(y)
    want = 0.5 * nm.demap_lappr_array(nm.map_noise(y, x_hat).T, x.T,
                                      mode="interp")
    assert lappr.shape == (teng.N, 8)
    torch.testing.assert_close(lappr, want.T, rtol=0, atol=0)
    np.testing.assert_array_equal(
        word.T.numpy(), teng.pa.demap_symbols_to_bits(x_hat.T).numpy())


# ---------------------------------------------------------------------------
# Rounds per dispatch


def test_dispatch_sums_its_rounds():
    calls = []

    def round_fn(r):
        calls.append(r)
        return torch.tensor([r, 1, 2 * r, 3])

    out = dispatched(round_fn, 3)(2)
    assert calls == [6, 7, 8]
    assert out.tolist() == [21, 3, 42, 9]
    assert dispatched(round_fn, 1) is round_fn


@pytest.mark.parametrize("mode", ["softening", "hard", "direct"])
def test_rounds_per_dispatch_draws_the_frames_of_single_rounds(mode):
    """R = 3 against R = 1 over 6 rounds, early exit off: the same counters
    exactly; with early exit on, frames stop at a multiple of R * B."""
    B = 16
    one, three = engine(batch=B), engine(batch=B, rounds_per_dispatch=3)
    assert three.frames_per_round == 3 * B
    args = (mode, 4.0, 20, 6 * B, NO_EXIT)
    kw = dict(nmconfig=ALTERNATING if mode == "softening" else None, seed=4)
    r1, r3 = one.run_point(*args, **kw), three.run_point(*args, **kw)
    assert rows([r1]) == rows([r3])
    assert r1.frames == 6 * B
    early = three.run_point(mode, 2.0, 5, 30 * B, 1, **kw)
    assert early.frames % (3 * B) == 0 and early.frames < 30 * B


@pytest.mark.parametrize("channel", ["bsc", "biawgn"])
def test_bit_channel_rounds_per_dispatch(channel):
    make, (vid, cid) = DECODERS["dense"]
    mat = Matrix(vid, cid)
    one = BitChannelEngine(make(), mat, batch=16)
    two = BitChannelEngine(make(), mat, batch=16, rounds_per_dispatch=2)
    if channel == "bsc":
        r1, r2 = (e.run_bsc_point(0.06, 20, 64, NO_EXIT) for e in (one, two))
    else:
        r1, r2 = (e.run_biawgn_point(1.0, 20, 64, NO_EXIT)
                  for e in (one, two))
    assert rows([r1]) == rows([r2]) and r1.frames == 64


def test_int32_guards():
    """``R * batch * K`` (reconciliation) and ``R * batch * N`` (bit
    channels) must stay below 2^31; one frame less passes."""
    make, (vid, cid) = DECODERS["dense"]
    mat, pa = Matrix(vid, cid), PAMAlphabet(2, 2.0)
    K, N, R = mat.vnum - mat.cnum, mat.vnum, 4
    over = -(-2 ** 31 // (R * K))              # batch with R*batch*K >= 2^31
    with pytest.raises(ValueError, match="2\\^31"):
        ReconciliationEngine(make(), mat, pa, batch=over,
                             rounds_per_dispatch=R)
    ReconciliationEngine(make(), mat, pa, batch=(2 ** 31 - 1) // (R * K),
                         rounds_per_dispatch=R)
    over = -(-2 ** 31 // (R * N))
    with pytest.raises(ValueError, match="2\\^31"):
        BitChannelEngine(make(), mat, batch=over, rounds_per_dispatch=R)
    BitChannelEngine(make(), mat, batch=(2 ** 31 - 1) // (R * N),
                     rounds_per_dispatch=R)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="rounds_per_dispatch"):
            ReconciliationEngine(make(), mat, pa, rounds_per_dispatch=bad)
        with pytest.raises(ValueError, match="rounds_per_dispatch"):
            BitChannelEngine(make(), mat, rounds_per_dispatch=bad)


def test_timer_gets_the_points_seconds():
    eng = engine(batch=16)
    timer = []
    r = eng.run_point("softening", 4.0, 10, 32, NO_EXIT,
                      nmconfig=ALTERNATING, timer=timer)
    eng.run_point("direct", 4.0, 10, 16, NO_EXIT, timer=timer)
    assert len(timer) == 2 and all(t > 0 for t in timer)
    assert r.frames_per_s == pytest.approx(r.frames / timer[0])


# ---------------------------------------------------------------------------
# Point batching


@pytest.mark.parametrize("name,llr_mode", [("dense", "poly"),
                                           ("dense", "interp"),
                                           ("layered", "poly"),
                                           ("generic", "poly")])
def test_batched_sweep_equals_the_sequential_sweep(name, llr_mode):
    """Per point: ber, fer, iters and frames equal ``run_point`` with the
    point's CLI seed, exactly, early exit off (R = 2 dispatches)."""
    B, snrs, seed = 16, [3.0, 4.0, 5.0], 11
    eng = engine(name, batch=B, llr_mode=llr_mode, rounds_per_dispatch=2)
    kw = dict(nmconfig=ALTERNATING)
    batched = eng.run_sweep_batched("softening", snrs, 20, 4 * B, NO_EXIT,
                                    seed=seed, **kw)
    seq = [eng.run_point("softening", s, 20, 4 * B, NO_EXIT,
                         seed=point_seed(seed, i), **kw)
           for i, s in enumerate(snrs)]
    assert rows(batched) == rows(seq)
    assert len({r.frames_per_s for r in batched}) == 1      # the grid's
    assert batched[0].fer > batched[2].fer


def test_batched_sweep_early_exit_matches_run_point():
    """With early exit on, a finished point leaves the batch; its frames
    and counters are ``run_point``'s (the dispatch already issued counts)."""
    B, snrs = 16, [2.0, 10.0]              # every frame fails / decodes
    eng = engine(batch=B)
    batched = eng.run_sweep_batched("hard", snrs, 10, 20 * B, 5, seed=3)
    seq = [eng.run_point("hard", s, 10, 20 * B, 5, seed=point_seed(3, i))
           for i, s in enumerate(snrs)]
    assert rows(batched) == rows(seq)
    assert batched[0].frames < batched[1].frames == 20 * B


def test_batched_sweep_decodes_all_points_at_once():
    """One decode call per round over the pending points' frames."""
    B = 8
    eng = engine(batch=B)
    widths = []
    decode = eng.dec._build_decode()

    def spy(lappr, synd, maxiter):
        widths.append(lappr.shape[1])
        return decode(lappr, synd, maxiter)

    eng.dec._build_decode = lambda: spy
    eng.run_sweep_batched("direct", [3.0, 3.5, 4.0], 5, 2 * B, NO_EXIT)
    assert widths == [3 * B, 3 * B]
    with pytest.raises(ValueError, match="one seed per SNR point"):
        eng.run_sweep_batched("direct", [3.0, 4.0], 5, B, NO_EXIT,
                              seeds=[1])


@pytest.fixture(scope="module")
def code_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("code") / "code.csv")
    save_qc_csv(path, QC[0], 32)
    return path


def cli(module, path, out, *flags):
    return module.main([path, "--qc", "--device", "cpu", "--out", out,
                        "--maxiter", "20", *flags])


def csv_rows(path):
    with open(path) as f:
        return f.read().splitlines()


def test_point_batch_cli_equals_the_sequential_cli(code_path, tmp_path):
    flags = ["--snr", "3", "5", "--nsnr", "3", "--simloops", "32",
             "--batch", "16", "--ferr-count-min", str(NO_EXIT)]
    seq = cli(sim_reconciliation, code_path, str(tmp_path / "s.csv"), *flags)
    bat = cli(sim_reconciliation, code_path, str(tmp_path / "b.csv"), *flags,
              "--point-batch")
    assert rows(bat) == rows(seq)
    assert csv_rows(tmp_path / "s.csv") == csv_rows(tmp_path / "b.csv")


def test_point_batch_honours_the_resume_journal(code_path, tmp_path):
    """Only the pending points enter the batch; journaled rows are kept."""
    from qamreconciliation_tpu_torch.utils.checkpoint import SweepState

    out = str(tmp_path / "out.csv")
    state = SweepState(out, resume=False)
    state.record(4.0, dict(ber=0.125, fer=0.5, iters=7.0, frames=99,
                           frames_per_s=1.0))
    flags = ["--snr", "3", "5", "--nsnr", "3", "--simloops", "16",
             "--batch", "16", "--resume", "--point-batch"]
    res = cli(sim_reconciliation, code_path, out, *flags)
    assert [r.frames for r in res] == [16, 99, 16]
    assert (res[1].ber, res[1].fer, res[1].iters) == (0.125, 0.5, 7.0)
    assert not os.path.exists(out + ".partial.jsonl")
    fresh = cli(sim_reconciliation, code_path, str(tmp_path / "f.csv"),
                "--snr", "3", "5", "--nsnr", "3", "--simloops", "16",
                "--batch", "16")
    assert rows([res[0], res[2]]) == rows([fresh[0], fresh[2]])


def test_point_batch_guards(code_path, tmp_path):
    out = str(tmp_path / "out.csv")
    for extra in (["--resident"], ["--graph-shard"]):
        with pytest.raises(SystemExit):
            cli(sim_reconciliation, code_path, out, "--point-batch", *extra)


# ---------------------------------------------------------------------------
# Profiling


@pytest.mark.parametrize("module,flags", [
    (sim_reconciliation, ["--snr", "3", "4", "--nsnr", "2"]),
    (sim_reconciliation, ["--snr", "3", "4", "--nsnr", "2",
                          "--point-batch"]),
    (sim_bsc, ["--rber", "0.04", "0.05", "--rpoints", "2"]),
], ids=["sequential", "point-batch", "sim_bsc"])
def test_profile_dir_writes_a_chrome_trace(code_path, tmp_path, module,
                                           flags):
    prof = tmp_path / "prof"
    res = cli(module, code_path, str(tmp_path / "out.csv"), *flags,
              "--simloops", "16", "--batch", "16", "--profile-dir",
              str(prof))
    assert len(res) == 2
    with open(prof / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


# ---------------------------------------------------------------------------
# The CLI flags against the JAX CLI


NEW_FLAGS = {
    "llr-exact": ["--llr-exact"],
    "llr-mode-interp": ["--llr-mode", "interp"],
    "llr-mode-search": ["--llr-mode", "search"],
    "fy-mode-erf_flat": ["--fy-mode", "erf_flat"],
    "fy-mode-poly": ["--fy-mode", "poly"],
    "rounds-per-dispatch": ["--rounds-per-dispatch", "3"],
    "point-batch": ["--point-batch"],
}


@pytest.mark.parametrize("flag", NEW_FLAGS)
def test_new_flags_agree_with_the_jax_cli(code_path, tmp_path, flag):
    """BER and FER within 4 standard errors of the JAX CLI's, 192 frames a
    point at 3.5 and 4.0 dB, early exit off (the JAX CLI on the CPU, its
    decoder without Pallas)."""
    common = ["--qc", "--snr", "3.5", "4.0", "--nsnr", "2", "--simloops",
              "192", "--batch", "64", "--maxiter", "20", "--ferr-count-min",
              str(NO_EXIT), *NEW_FLAGS[flag]]
    res = sim_reconciliation.main([code_path, "--device", "cpu", "--out",
                                   str(tmp_path / "t.csv"), *common])
    with jax.enable_x64(False):
        df = jsim_reconciliation.main([code_path, "--out",
                                       str(tmp_path / "j.csv"), *common])
    for r, (_, jrow) in zip(res, df.iterrows()):
        assert r.frames == 192
        jf, jb = float(jrow["fer"]), float(jrow["ber"])
        se_fer = math.sqrt((r.fer * (1 - r.fer) + jf * (1 - jf)) / 192)
        # per-frame error fractions lie in [0, 1], so var <= mean: a
        # conservative BER standard error for frame-clustered bit errors
        se_ber = math.sqrt((r.ber + jb) / 192)
        assert abs(r.fer - jf) <= 4 * se_fer + 1e-12, (r.fer, jf)
        assert abs(r.ber - jb) <= 4 * se_ber + 1e-12, (r.ber, jb)
    assert 0.05 < res[0].fer


@pytest.mark.parametrize("module,flags", [
    (sim_bsc, ["--rber", "0.05", "0.07", "--rpoints", "2"]),
    (sim_decode, ["--snr", "0.5", "1.5", "--nsnr", "2"]),
    (sim_direct, ["--snr", "0.5", "1.5", "--nsnr", "2", "--hard"]),
], ids=["sim_bsc", "sim_decode", "sim_direct"])
def test_bit_channel_clis_take_rounds_per_dispatch(code_path, tmp_path,
                                                   module, flags):
    """R = 3 writes the rows of R = 1 (early exit off)."""
    common = [*flags, "--simloops", "48", "--batch", "16", "--minerr",
              str(NO_EXIT)]
    one = cli(module, code_path, str(tmp_path / "1.csv"), *common)
    three = cli(module, code_path, str(tmp_path / "3.csv"), *common,
                "--rounds-per-dispatch", "3")
    assert rows(one) == rows(three) and one[0].frames == 48
    assert csv_rows(tmp_path / "1.csv") == csv_rows(tmp_path / "3.csv")


# ---------------------------------------------------------------------------
# The entry round


def test_entry_runs_one_round_on_the_cpu(capsys):
    fn, (gen,) = entry_module.entry(device="cpu")
    out = fn(gen)
    assert out.shape == (4,) and out.dtype == torch.int64
    errs, ferrs, iters, succ = out.tolist()
    K = 512                                 # rate-1/2 code of length 1024
    assert 0 <= errs <= 32 * K and 0 <= ferrs <= 32
    assert 0 < succ <= 32 and 0 <= iters <= 50 * succ
    assert (ferrs > 0) == (errs > 0)
    again = entry_module.main(["--device", "cpu"])
    assert again == out.tolist()            # the same generator seed
    assert "frame_errors" in capsys.readouterr().out
