"""Port parity: block-streamed reconciliation (``sims/streaming.py``).

Every case of ``tests/test_streaming.py`` runs through both packages on the
same numpy-seeded ``(x, y)`` streams: the JAX ``StreamReconciler`` on the
CPU against the port's (``device="cpu"``, the kernels' plain versions).

Tiers:
* exact: Bob's words and syndromes, ``success``, ``iterations``, the
  decoded words, ``bit_errors``, ``decode_dispatches`` and the frames each
  call returns, for every driver (split immediate, split deferred, handoff,
  fused) on the generic ``Decoder`` (float64, as the JAX file runs it) and
  the dense, resident and layered ``QCDecoder`` (z = 16; float64 sum-product
  and bf16 min-sum);
* tolerance: Bob's softening metric ``n_hat`` within 64 float64 ulps of 1
  (the two libms' erf differ by an ulp, and ``(F - lo) / dF`` divides by an
  interval mass of ~0.25).

The bf16 cases build and run the JAX side with x64 off (the tests'
conftest turns it on, which makes JAX's bf16 ``F_Y`` float64).  The JAX
mesh case runs on a one-rank mesh here; ``tests/test_torch_parallel.py``
runs it on two ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu import Decoder as JDecoder
from qamreconciliation_tpu import Matrix as JMatrix
from qamreconciliation_tpu import PAMAlphabet as JPAM
from qamreconciliation_tpu.models import qc_decoder as jqc
from qamreconciliation_tpu.models.noisemapper import NoiseMapper as JNM
from qamreconciliation_tpu.sims import streaming as jstream
from qamreconciliation_tpu.utils import make_regular_ldpc
from qamreconciliation_tpu_torch.models import qc_decoder as tqc
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
from qamreconciliation_tpu_torch.sims import streaming as tstream

torch.set_num_threads(1)

SNR = 9.0
NHAT_ATOL = 64 * np.finfo(np.float64).eps


class Chain:
    """(dec, mat, pa, nm) of one package, with the stream's sigma."""

    def __init__(self, pkg, dec, mat, pa, nm, sigma):
        self.pkg, self.dec, self.mat, self.pa, self.nm = pkg, dec, mat, pa, nm
        self.sigma = sigma

    def reconciler(self, **kw):
        mod = jstream if self.pkg == "jax" else tstream
        return mod.StreamReconciler(self.dec, self.mat, self.pa, self.nm,
                                    **kw)


def noise_var(pa, snr=SNR):
    return pa.variance * 10 ** (-snr / 10) / 2


@pytest.fixture(scope="module")
def chains():
    """The JAX file's chain in both packages: a (3,6)-regular code of 240
    bits, 4-PAM, 9 dB, float64 generic decoder and mapper."""
    vid, cid = make_regular_ldpc(240, 3, 6, seed=9)
    jpa, tpa = JPAM(2, 2.0), PAMAlphabet(2, 2.0)
    N0 = noise_var(jpa)
    return {
        "jax": Chain("jax", JDecoder(vid, cid, dtype=jnp.float64),
                     JMatrix(vid, cid), jpa,
                     JNM(jpa, N0, dtype=jnp.float64), np.sqrt(N0)),
        "torch": Chain("torch", Decoder(vid, cid, dtype=torch.float64,
                                        device="cpu"),
                       Matrix(vid, cid), tpa,
                       NoiseMapper(tpa, N0, dtype=torch.float64,
                                   device="cpu"), np.sqrt(N0)),
    }


def stream(chain, n_frames, seed, S=None):
    """numpy-seeded (x, y) of ``n_frames`` frames (the JAX file's draw)."""
    pa = chain.pa
    S = S or chain.mat.vnum // pa.bit_per_symbol
    rng = np.random.default_rng(seed)
    x = rng.integers(0, pa.order, n_frames * S)
    y = pa.constellation[x] + chain.sigma * rng.standard_normal(x.size)
    return x, y


def irregular_chunks(total):
    """Chunk sizes deliberately misaligned with the frame length."""
    sizes = []
    left = total
    k = 17
    while left > 0:
        sz = min(left, k)
        sizes.append(sz)
        left -= sz
        k = (k * 7) % 97 + 11
    return sizes


def assert_results_equal(got, want):
    """Two StreamResults (or lists of them, call by call) identical."""
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_results_equal(g, w)
        return
    assert got.frames == want.frames
    assert got.success == want.success
    assert got.iterations == want.iterations
    assert got.bit_errors == want.bit_errors
    assert len(got.decoded_words) == len(want.decoded_words)
    for g, w in zip(got.decoded_words, want.decoded_words):
        np.testing.assert_array_equal(np.asarray(g, np.uint8),
                                      np.asarray(w, np.uint8))


def assert_bob_equal(got, want):
    """Bob's (words, synd, n_hat): words and syndromes exact, n_hat within
    NHAT_ATOL (float64)."""
    (gw, gs, gn), (ww, ws, wn) = got, want
    np.testing.assert_array_equal(gw, np.asarray(ww))
    np.testing.assert_array_equal(gs, np.asarray(ws))
    assert gw.dtype == gs.dtype == np.uint8
    np.testing.assert_allclose(gn, np.asarray(wn, np.float64), rtol=0,
                               atol=NHAT_ATOL)


def run_stream(chain, chunk_sizes, n_frames=7, batch=3, seed=0):
    """The JAX file's ``_run_stream``: Bob fed in chunks, Alice in one
    call.  Returns (reconciler, Bob's outputs, frames per Bob call,
    Alice's result)."""
    sr = chain.reconciler(batch=batch)
    x, y = stream(chain, n_frames, seed)
    outs, per_call = [], []
    pos = 0
    for sz in chunk_sizes(x.size):
        out = sr.bob_process(y[pos:pos + sz])
        per_call.append(out[0].shape[0])
        if out[0].shape[0]:
            outs.append(out)
        pos += sz
    bob = tuple(np.concatenate([np.asarray(o[i]) for o in outs])
                for i in range(3))
    assert bob[0].shape[0] == n_frames
    res = sr.alice_process(bob[2], x, bob[1], max_iterations=30)
    return sr, bob, per_call, res


@pytest.fixture(scope="module")
def split_runs(chains):
    """run_stream of both packages, both chunkings, two seeds."""
    out = {}
    for pkg, chain in chains.items():
        for name, chunks in (("irregular", irregular_chunks),
                             ("single", lambda total: [total])):
            for seed in (0, 4):
                out[pkg, name, seed] = run_stream(chain, chunks, seed=seed)
    return out


@pytest.mark.parametrize("chunking", ["irregular", "single"])
@pytest.mark.parametrize("seed", [0, 4])
def test_stream_misaligned_chunks_decode(split_runs, chunking, seed):
    _, bob, per_call, res = split_runs["torch", chunking, seed]
    _, jbob, jper_call, jres = split_runs["jax", chunking, seed]
    assert_bob_equal(bob, jbob)
    assert per_call == jper_call
    assert_results_equal(res, jres)
    assert res.frames == bob[0].shape[0]
    # high SNR: every frame decodes to Bob's word
    assert all(res.success)
    for got, expect in zip(res.decoded_words, bob[0]):
        np.testing.assert_array_equal(got, expect)


def test_stream_matches_single_shot(split_runs):
    """Streamed processing == one-shot processing of the same samples."""
    for pkg in ("torch", "jax"):
        _, bob_a, _, res_a = split_runs[pkg, "irregular", 4]
        _, bob_b, _, res_b = split_runs[pkg, "single", 4]
        np.testing.assert_array_equal(bob_a[0], bob_b[0])
        assert res_a.success == res_b.success
        assert res_a.iterations == res_b.iterations


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_stream_carry_preserved(chains, pkg):
    chain = chains[pkg]
    sr = chain.reconciler(batch=2)
    S = sr.N_symb
    rng = np.random.default_rng(2)
    y = rng.normal(0, 2, S + 5)
    w, s, nh = sr.bob_process(y[: S // 2])          # less than one frame
    assert w.shape[0] == 0
    w, s, nh = sr.bob_process(y[S // 2:])           # completes frame 1
    assert w.shape[0] == 1
    assert sr._carry_y.size == 5                     # tail carried


def test_stream_result_fer():
    r = tstream.StreamResult()
    assert r.fer == 0.0
    r.success = [True, False, True, True]
    assert r.fer == pytest.approx(0.25)


def test_every_decode_sees_the_fixed_batch(chains):
    """Two chunkings, the split, handoff and fused drivers: every Bob round
    and every decode sees exactly ``batch`` frames (the fixed shape of the
    JAX package's one compiled program), the tails padded."""
    chain = chains["torch"]
    x, y = stream(chain, 7, 7)
    S = chain.mat.vnum // chain.pa.bit_per_symbol

    def recorded(sr):
        shapes = []
        bob, dec = sr._bob_round, sr._decode_fn

        def bob_round(yb):
            shapes.append(("bob", tuple(yb.shape)))
            return bob(yb)

        def decode(lappr, synd, it):
            shapes.append(("decode", tuple(lappr.shape), tuple(synd.shape)))
            return dec(lappr, synd, it)

        sr._bob_round, sr._decode_fn = bob_round, decode
        return shapes

    runs = []
    for chunks in (irregular_chunks(x.size), [x.size]):
        sr = chain.reconciler(batch=3)
        shapes = recorded(sr)
        pos, outs = 0, []
        for sz in chunks:
            outs.append(sr.bob_process(y[pos:pos + sz]))
            pos += sz
        w, s, nh = (np.concatenate([o[i] for o in outs]) for i in range(3))
        sr.alice_process(nh, x, s, 30)
        h = sr.bob_step(y[:0])
        assert h.frames == 0
        sr2 = chain.reconciler(batch=3)
        shapes2 = recorded(sr2)
        sr2.stream_fused([y[a:a + 500] for a in range(0, y.size, 500)], x, 30)
        sr3 = chain.reconciler(batch=3)
        shapes3 = recorded(sr3)
        hands = [sr3.bob_step(y), sr3.bob_step_flush()]
        for hd, xs in zip(hands, (x, np.empty(0, np.int64))):
            sr3.alice_step(hd, xs, 30)
        runs.append(shapes + shapes2 + shapes3)
    for shapes in runs:
        assert shapes
        for entry in shapes:
            if entry[0] == "bob":
                assert entry[1] == (3, S)
            else:
                assert entry[1] == (chain.mat.vnum, 3)
                assert entry[2] == (chain.mat.cnum, 3)


def run_defer(chain, defer, seed=11, n_frames=7, batch=3):
    """The JAX file's defer comparison: Bob and Alice fed chunk by chunk;
    returns (reconciler, frames of each call, words, merged result,
    per-call results)."""
    x, y = stream(chain, n_frames, seed)
    chunks = irregular_chunks(x.size)
    sr = chain.reconciler(batch=batch, defer=defer)
    words, res, per_call = [], [], []
    pos = 0
    for sz in chunks:
        w, s, nh = sr.bob_process(y[pos:pos + sz])
        words.append(np.asarray(w))
        r = sr.alice_process(nh, x[pos:pos + sz], s, max_iterations=30)
        res.append(r)
        per_call.append((w.shape[0], r.frames))
        pos += sz
    if defer:
        w, s, nh = sr.bob_flush()
        words.append(np.asarray(w))
        res.append(sr.alice_process(nh, np.empty(0, np.int64), s, 30))
        res.append(sr.alice_flush(30))
        per_call.append((w.shape[0], res[-2].frames, res[-1].frames))
    all_words = np.concatenate([w for w in words if w.shape[0]])
    out = tstream.StreamResult()
    for r in res:
        out.frames += r.frames
        out.decoded_words.extend(r.decoded_words)
        out.success.extend(r.success)
        out.iterations.extend(r.iterations)
    return sr, per_call, all_words, out, res


@pytest.fixture(scope="module")
def defer_runs(chains):
    return {(pkg, defer): run_defer(chains[pkg], defer)
            for pkg in ("torch", "jax") for defer in (False, True)}


@pytest.mark.parametrize("defer", [False, True])
def test_stream_defer_matches_jax_call_by_call(defer_runs, defer):
    """What every call returns, and the dispatch count, equal JAX's."""
    sr, per_call, words, out, res = defer_runs["torch", defer]
    jsr, jper_call, jwords, jout, jres = defer_runs["jax", defer]
    assert per_call == jper_call
    np.testing.assert_array_equal(words, jwords)
    assert_results_equal(res, jres)
    assert sr.decode_dispatches == jsr.decode_dispatches


def test_stream_defer_matches_immediate_with_fewer_dispatches(defer_runs):
    """defer=True: identical decoded output to emit-immediately mode on
    the same stream (after flush), with ceil(frames / batch) dispatches."""
    sr_i, _, words_i, out_i, _ = defer_runs["torch", False]
    sr_d, _, words_d, out_d, _ = defer_runs["torch", True]
    assert out_i.frames == out_d.frames == 7
    np.testing.assert_array_equal(words_i, words_d)
    assert out_i.success == out_d.success
    assert out_i.iterations == out_d.iterations
    for a, b in zip(out_i.decoded_words, out_d.decoded_words):
        np.testing.assert_array_equal(a, b)
    assert sr_d.decode_dispatches == -(-7 // 3)
    assert sr_d.decode_dispatches < sr_i.decode_dispatches


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_defer_rejects_mid_stream_accounting_start(chains, pkg):
    """Starting bob_words accounting after rows were queued without it
    would misalign the words queue with the frame queue's front."""
    chain = chains[pkg]
    sr = chain.reconciler(batch=2, defer=True)
    rng = np.random.default_rng(3)
    S = sr.N_symb
    x = rng.integers(0, chain.pa.order, 2 * S)
    y = chain.pa.constellation[x] + chain.sigma * rng.standard_normal(x.size)
    words, synd, nhat = sr.bob_process(y)
    # the pending slot holds the first batch; flush to read it back
    if words.shape[0] == 0:
        words, synd, nhat = sr.bob_flush()
    assert words.shape[0] == 2
    sr.alice_process(nhat, x, synd, max_iterations=4)
    x2 = rng.integers(0, chain.pa.order, 2 * S)
    y2 = chain.pa.constellation[x2] + chain.sigma * rng.standard_normal(
        x2.size)
    words2, synd2, nhat2 = sr.bob_process(y2)
    if words2.shape[0] == 0:
        words2, synd2, nhat2 = sr.bob_flush()
    with pytest.raises(ValueError, match="every deferred"):
        sr.alice_process(nhat2, x2, synd2, max_iterations=4,
                         bob_words=words2)


def fused_split_cuts(S, F):
    return [0, int(1.4 * S), int(3.7 * S), int(4.1 * S), F * S]


def run_fused_and_split(chain, F=7, seed=11, batch=3, maxiter=8):
    """The JAX file's fused-versus-split case: (split result, fused
    result, fused reconciler)."""
    x, y = stream(chain, F, seed)
    S = chain.mat.vnum // chain.pa.bit_per_symbol
    cuts = fused_split_cuts(S, F)
    y_chunks = [y[a:b] for a, b in zip(cuts, cuts[1:])]
    x_chunks = [x[a:b] for a, b in zip(cuts, cuts[1:])]
    sr1 = chain.reconciler(batch=batch)
    outs = [sr1.bob_process(yc) for yc in y_chunks]
    w, s, nh = (np.concatenate([np.asarray(o[i]) for o in outs])
                for i in range(3))
    split = sr1.alice_process(nh, x, s, max_iterations=maxiter, bob_words=w)
    sr2 = chain.reconciler(batch=batch)
    fused = sr2.stream_fused(y_chunks, x_chunks, max_iterations=maxiter)
    return split, fused, sr2


@pytest.fixture(scope="module")
def fused_runs(chains):
    return {pkg: run_fused_and_split(chains[pkg]) for pkg in chains}


def test_stream_fused_matches_split_api(fused_runs):
    """The fused driver gives exactly the split API's results on the same
    streams, in both packages, and the port's equal JAX's."""
    for pkg in ("torch", "jax"):
        split, fused, _ = fused_runs[pkg]
        assert fused.frames == split.frames == 7
        assert_results_equal(fused, split)
    assert_results_equal(fused_runs["torch"][1], fused_runs["jax"][1])
    assert (fused_runs["torch"][2].decode_dispatches
            == fused_runs["jax"][2].decode_dispatches)


def test_stream_fused_tail_and_uneven_streams(chains):
    """A tail shorter than a batch is padded once; the shorter stream
    bounds the decodable frames."""
    out = {}
    for pkg, chain in chains.items():
        S = chain.mat.vnum // chain.pa.bit_per_symbol
        rng = np.random.default_rng(12)
        x = rng.integers(0, chain.pa.order, 5 * S + S // 2)   # 5.5 frames
        y = chain.pa.constellation[x[: 5 * S]] \
            + chain.sigma * rng.standard_normal(5 * S)        # 5 frames
        sr = chain.reconciler(batch=4)
        r = sr.stream_fused(y, x, max_iterations=8)
        assert r.frames == 5 and len(r.decoded_words) == 5
        assert all(wd.shape == (chain.mat.vnum,) for wd in r.decoded_words)
        out[pkg] = (r, sr.decode_dispatches)
    assert_results_equal(out["torch"][0], out["jax"][0])
    assert out["torch"][1] == out["jax"][1] == 2


def test_frame_sharded_fused_driver_is_not_ported(chains):
    """The JAX package's mesh-sharded stream_fused (``mesh_axis``) is
    ported (the Multi-GPU slice): on a one-rank mesh it equals the
    single-device driver; a batch the mesh's ranks do not divide, or a
    code length the bits per symbol do not divide, raises as in JAX
    (``tests/test_torch_parallel.py`` runs two ranks)."""
    from qamreconciliation_tpu_torch.parallel.mesh import Mesh, make_mesh

    c = chains["torch"]
    x, y = stream(c, 5, seed=12)
    mesh = make_mesh(1, "sdp", device="cpu")
    results = []
    for kw in ({}, dict(mesh_axis=(mesh, "sdp"))):
        sr = c.reconciler(batch=4, **kw)
        results.append((sr.stream_fused(y, x, max_iterations=8),
                        sr.decode_dispatches))
    assert_results_equal(results[1][0], results[0][0])
    assert results[1][1] == results[0][1] == 2
    two_ranks = Mesh(None, 0, 2, "cpu", "sdp", "gloo")
    with pytest.raises(ValueError, match="must divide"):
        tstream.StreamReconciler(c.dec, c.mat, c.pa, c.nm, batch=3,
                                 mesh_axis=(two_ranks, "sdp"))
    with pytest.raises(ValueError, match="divisible"):
        tstream.StreamReconciler(c.dec, Matrix([0, 1, 2], [0, 0, 0]),
                                 c.pa, c.nm, mesh_axis=(two_ranks, "sdp"))


def run_handoff(chain, n_frames=7, batch=3, seed=21):
    """The JAX file's handoff case: (split result, per-call handoff
    results, handle frame counts, reconciler)."""
    x, y = stream(chain, n_frames, seed)
    sr1 = chain.reconciler(batch=batch)
    S = sr1.N_symb
    w, s, nh = sr1.bob_process(y)
    r_split = sr1.alice_process(nh, x, s, max_iterations=30, bob_words=w)
    sr2 = chain.reconciler(batch=batch)
    h1 = sr2.bob_step(y[: 2 * S + 7])
    h2 = sr2.bob_step(y[2 * S + 7:])
    frames = [h1.frames, h2.frames]
    r1 = sr2.alice_step(h1, x[: 2 * S + 7], max_iterations=30)
    r2 = sr2.alice_step(h2, x[2 * S + 7:], max_iterations=30)
    h3 = sr2.bob_step_flush()
    frames.append(h3.frames)
    r3 = sr2.alice_step(h3, np.empty(0, np.int64), max_iterations=30)
    assert not h2.batches and not h3.batches      # device memory released
    return r_split, [r1, r2, r3], frames, sr2


@pytest.fixture(scope="module")
def handoff_runs(chains):
    return {pkg: run_handoff(chains[pkg]) for pkg in chains}


def test_handoff_matches_split_api(handoff_runs):
    """bob_step/alice_step produce exactly the split API's results (bit
    errors counted on the device, words downloaded packed), call by call
    equal to JAX's."""
    r_split, parts, frames, sr = handoff_runs["torch"]
    assert frames == [0, 6, 1]
    merged = tstream.StreamResult()
    for r in parts:
        merged.frames += r.frames
        merged.success += r.success
        merged.iterations += r.iterations
        merged.bit_errors += r.bit_errors
        merged.decoded_words += r.decoded_words
    assert merged.frames == r_split.frames == 7
    assert_results_equal(merged, r_split)
    jr_split, jparts, jframes, jsr = handoff_runs["jax"]
    assert frames == jframes
    assert_results_equal(parts, jparts)
    assert_results_equal(r_split, jr_split)
    assert sr.decode_dispatches == jsr.decode_dispatches


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_handoff_validation(chains, pkg):
    """defer mode refuses the handoff pair; alice_step refuses an x stream
    that cannot cover the handle's frames."""
    chain = chains[pkg]
    sr = chain.reconciler(batch=2, defer=True)
    with pytest.raises(ValueError, match="defer"):
        sr.bob_step(np.zeros(10))
    sr = chain.reconciler(batch=2)
    x, y = stream(chain, 2, 3)
    S = sr.N_symb
    h = sr.bob_step(y)
    assert h.frames == 2
    with pytest.raises(ValueError, match="handoff carries"):
        sr.alice_step(h, x[: S // 2], max_iterations=8)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_handoff_mixing_and_recovery_guards(chains, pkg):
    """bob_process(defer=False) refuses to run past frames queued by
    bob_step, and the alice_step x-shortfall error absorbs x_block into the
    carry so a retry with the missing tail resumes the aligned stream."""
    chain = chains[pkg]
    sr = chain.reconciler(batch=2)
    S = sr.N_symb
    x, y = stream(chain, 2, 5)
    sr.bob_step(y[:S])                  # 1 frame queued (< batch)
    with pytest.raises(ValueError, match="bob_step_flush"):
        sr.bob_process(y[S:])
    sr2 = chain.reconciler(batch=2)
    h = sr2.bob_step(y)                 # full batch of 2
    with pytest.raises(ValueError, match="handoff carries"):
        sr2.alice_step(h, x[: S + 3], max_iterations=8)
    r = sr2.alice_step(h, x[S + 3:], max_iterations=8)
    assert r.frames == 2 and all(r.success)


# ----------------------------------------------------------- QCDecoder

QC_Z = 16
# (label, dtype, decoder keywords shared by both packages)
QC_VARIANTS = [
    ("dense-f64-sumproduct", "float64", dict()),
    ("dense-bf16-minsum", "bfloat16", dict(check_rule="minsum")),
    ("resident-bf16-minsum", "bfloat16",
     dict(check_rule="minsum", resident=True, resident_chunk=4)),
    ("layered-bf16-minsum", "bfloat16",
     dict(check_rule="minsum", schedule="layered")),
    ("layered-resident-bf16-minsum", "bfloat16",
     dict(check_rule="minsum", schedule="layered", resident=True)),
]


def qc_chain(pkg, dtype, kw, snr):
    base, vid, cid = jqc.make_qc_ldpc(12, QC_Z, dv=3, dc=6, seed=4)
    if pkg == "jax":
        pa = JPAM(2, 2.0)
        N0 = noise_var(pa, snr)
        dt = jnp.dtype(dtype)
        return Chain(pkg, jqc.QCDecoder(base, QC_Z, dtype=dt, **kw),
                     JMatrix(vid, cid), pa, JNM(pa, N0, dtype=dt),
                     np.sqrt(N0))
    pa = PAMAlphabet(2, 2.0)
    N0 = noise_var(pa, snr)
    return Chain(pkg, tqc.QCDecoder(base, QC_Z, dtype=dtype, device="cpu",
                                    **kw),
                 Matrix(vid, cid), pa,
                 NoiseMapper(pa, N0, dtype=dtype, device="cpu"), np.sqrt(N0))


def qc_drivers(chain, x, y, maxiter):
    """The fused driver over misaligned chunks, and (port only) the split
    immediate, split deferred and handoff drivers on the same streams."""
    S = chain.mat.vnum // chain.pa.bit_per_symbol
    F = x.size // S
    cuts = fused_split_cuts(S, F)
    y_chunks = [y[a:b] for a, b in zip(cuts, cuts[1:])]
    x_chunks = [x[a:b] for a, b in zip(cuts, cuts[1:])]
    out = {"fused": chain.reconciler(batch=3).stream_fused(
        y_chunks, x_chunks, max_iterations=maxiter)}
    if chain.pkg == "jax":
        return out
    sr = chain.reconciler(batch=3)
    w, s, nh = sr.bob_process(y)
    out["split"] = sr.alice_process(nh, x, s, maxiter, bob_words=w)
    sr = chain.reconciler(batch=3, defer=True)
    parts = []
    for yc, xc in zip(y_chunks, x_chunks):
        w, s, nh = sr.bob_process(yc)
        parts.append(sr.alice_process(nh, xc, s, maxiter, bob_words=w))
    w, s, nh = sr.bob_flush()
    parts.append(sr.alice_process(nh, np.empty(0, np.int64), s, maxiter,
                                  bob_words=w))
    parts.append(sr.alice_flush(maxiter))
    merged = tstream.StreamResult()
    for r in parts:
        merged.frames += r.frames
        merged.success += r.success
        merged.iterations += r.iterations
        merged.bit_errors += r.bit_errors
        merged.decoded_words += r.decoded_words
    out["deferred"] = merged
    sr = chain.reconciler(batch=3)
    parts = []
    for yc, xc in zip(y_chunks, x_chunks):
        parts.append(sr.alice_step(sr.bob_step(yc), xc, maxiter))
    parts.append(sr.alice_step(sr.bob_step_flush(), np.empty(0, np.int64),
                               maxiter))
    merged = tstream.StreamResult()
    for r in parts:
        merged.frames += r.frames
        merged.success += r.success
        merged.iterations += r.iterations
        merged.bit_errors += r.bit_errors
        merged.decoded_words += r.decoded_words
    out["handoff"] = merged
    return out


@pytest.mark.parametrize("label,dtype,kw", QC_VARIANTS,
                         ids=[v[0] for v in QC_VARIANTS])
def test_stream_with_qc_decoder(label, dtype, kw):
    """The QCDecoder duck-typed in through ``_build_decode``: every driver
    of the port equals the JAX fused driver on the same streams (7 frames at
    a z = 16 code's knee, so some frames fail)."""
    snr, maxiter = 5.0, 12
    with jax.enable_x64(dtype == "float64"):
        jchain = qc_chain("jax", dtype, kw, snr)
        x, y = stream(jchain, 7, 1)
        want = qc_drivers(jchain, x, y, maxiter)["fused"]
    got = qc_drivers(qc_chain("torch", dtype, kw, snr), x, y, maxiter)
    assert want.frames == 7 and max(want.iterations) > 0
    for driver, res in got.items():
        assert_results_equal(res, want)


def test_qc_stream_reaches_every_schedule():
    """The z = 16 streams above decode some frames and fail others under
    the dense min-sum decoder, so success and iterations are held on both
    outcomes."""
    with jax.enable_x64(False):
        jchain = qc_chain("jax", "bfloat16", dict(check_rule="minsum"), 5.0)
        x, y = stream(jchain, 7, 1)
    got = qc_drivers(qc_chain("torch", "bfloat16",
                              dict(check_rule="minsum"), 5.0), x, y, 12)
    s = got["fused"].success
    assert 0 < sum(s) < len(s), s


# ------------------------------------------------------ host plumbing


def test_pack_bits_round_trips_through_unpackbits():
    rng = np.random.default_rng(3)
    for N in (8, 240, 243):
        bits = rng.integers(0, 2, (5, N))
        packed = tstream._make_pack_bits(N)(torch.from_numpy(bits))
        assert packed.dtype == torch.uint8
        assert packed.shape == (5, -(-N // 8))
        back = np.unpackbits(packed.numpy(), axis=1, bitorder="little")
        np.testing.assert_array_equal(back[:, :N], bits)


def test_host_cast_to_bf16_matches_jax():
    """float64 samples rounded to bf16 on the host value for value as
    ``jnp.asarray(y, jnp.bfloat16)``, on values where rounding through
    float32 and rounding once differ (ties of bf16 moved by 2^-30)."""
    one = 1.0 + 2.0 ** -8
    v = np.array([one + 2.0 ** -30, one - 2.0 ** -30, -(one + 2.0 ** -30),
                  1.0 + 3 * 2.0 ** -8 + 2.0 ** -30, 3.0000001, 1e-40,
                  -2.5, 65504.5, np.pi], np.float64)
    rng = np.random.default_rng(0)
    v = np.concatenate([v, rng.normal(0, 3, 4096)])
    got = tstream._upload(v, torch.bfloat16, "cpu").float().numpy()
    want = np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)


def test_queue_is_the_concatenated_stream():
    """The host queues (the fused driver's carry, the frame queues) equal
    concatenating what was appended, whatever the chunk and take sizes."""
    rng = np.random.default_rng(1)
    for row in ((), (3,)):
        q = tstream._Queue(np.float64, row)
        ref = np.empty((0, *row))
        for _ in range(60):
            rows = rng.normal(size=(int(rng.integers(0, 900)), *row))
            q.append(rows)
            ref = np.concatenate([ref, rows])
            n = int(rng.integers(0, len(q) + 1))
            np.testing.assert_array_equal(q.take(n), ref[:n])
            ref = ref[n:]
            assert len(q) == len(ref)
