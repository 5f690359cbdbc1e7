"""Port parity: the generic Tanner-graph decoder and the parity matrix.

* ``TannerGraph``'s index arrays equal the JAX ones element for element on
  a regular and an irregular code (both padding masks in use).
* ``Decoder.decode_batch`` (torch, CPU: the check phase runs its plain
  version) against the JAX ``Decoder``: in f32 against its XLA check phase
  (the default), in bf16 against its Pallas kernel in interpret mode
  (``use_pallas=True``), whose semantics (v2c formed in f32) the port's
  kernel keeps.  Success and iters are identical and min-sum totals
  bit-exact.  Sum-product totals agree within rtol/atol 2e-4 in f32 (one
  libm ulp per phi call, compounded over up to 30 iterations; measured
  5e-5) and 2^-4 in bf16 (an ulp of f32 difference can flip a bf16
  rounding, and that compounds; measured 2e-2).
* The per-node API against the reference's truth tables (as
  tests/test_decoder.py holds the JAX decoder), and the float64 decode
  against the C++ scalar oracle (as tests/test_graphcore.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models import decoder as jdec
from qamreconciliation_tpu.models.matrix import Matrix as JMatrix
from qamreconciliation_tpu.models.qc_decoder import make_qc_ira
from qamreconciliation_tpu_torch.models.decoder import Decoder, TannerGraph
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.ops.boxplus import (
    box_plus, check_node_update, phi_llr,
)
from qamreconciliation_tpu_torch.utils import edgefile
from qamreconciliation_tpu_torch.utils.scalar import (
    count_errors_from_lappr, dist_cut,
)

torch.set_num_threads(1)

HAMMING_CSV = os.path.join(os.path.dirname(__file__), "data",
                           "hamming_7-4.csv")
CODES = {
    "regular": edgefile.make_regular_ldpc(512, 3, 6, seed=2),
    # expanded QC-IRA, z = 16: check degrees 7-12, variable degrees 2-3
    "irregular": make_qc_ira(12, 6, 16, dv=3, seed=1)[1:],
}


def frames(vid, cid, B=24, seed=3):
    """Words, syndromes and LLRs with per-frame noise 1.0-3.2, so some
    frames decode at once, some within a few iterations, some never."""
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 2, (B, mat.vnum))
    synd = mat.eval_syndrome(torch.from_numpy(word)).numpy()
    llr = ((1 - 2 * word) * 2.5 + rng.normal(0, 2.0, word.shape)
           * np.linspace(0.5, 1.6, B)[:, None]).astype(np.float32)
    return word, synd, llr


@pytest.mark.parametrize("name", list(CODES))
def test_tanner_graph_matches_jax(name):
    vid, cid = CODES[name]
    jg, tg = jdec.TannerGraph(vid, cid), TannerGraph(vid, cid)
    for attr in ("vnum", "cnum", "ednum", "dv_max", "dc_max"):
        assert getattr(tg, attr) == getattr(jg, attr)
    irregular = len(set(tg.dc.tolist())) > 1 and len(set(tg.dv.tolist())) > 1
    assert irregular == (name == "irregular")
    for attr in ("dv", "dc", "e_to_v", "e_to_c", "var_slot_of_edge",
                 "chk_slot_of_edge", "_v_mask_np", "_c_mask_np",
                 "_c_mask_T_np", "_v_mask_T_np", "_c_from_v", "_v_from_c",
                 "_c_vids", "_c_vids_T", "_v_from_c_T"):
        np.testing.assert_array_equal(getattr(tg, attr),
                                      np.asarray(getattr(jg, attr)))
    # the int32 forms (the check mask, gather 2's slot table and degrees)
    int32 = {"c_mask_T_i": tg._c_mask_T_np, "v_from_c_T_i": tg._v_from_c_T,
             "dv_i": tg.dv}
    for name, idx in tg.on("cpu").items():
        if name in int32:
            assert idx.dtype == torch.int32
            np.testing.assert_array_equal(idx.numpy(), int32[name])
        else:
            np.testing.assert_array_equal(idx.numpy(),
                                          getattr(tg, "_" + name))
    rng = np.random.default_rng(1)
    flat_v = rng.normal(size=(tg.vnum * tg.dv_max, 3))
    np.testing.assert_array_equal(
        tg.permute_v_to_c(torch.from_numpy(flat_v)).numpy(),
        np.asarray(jg.permute_v_to_c(jnp.asarray(flat_v))))
    flat_c = rng.normal(size=(tg.cnum * tg.dc_max, 3))
    np.testing.assert_array_equal(
        tg.permute_c_to_v(torch.from_numpy(flat_c)).numpy(),
        np.asarray(jg.permute_c_to_v(jnp.asarray(flat_c))))
    bits = rng.integers(0, 2, (tg.vnum, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        tg.syndrome_from_bits(torch.from_numpy(bits)).numpy(),
        np.asarray(jg.syndrome_from_bits(jnp.asarray(bits))))
    word = rng.integers(0, 2, (2, 3, tg.vnum))
    got = Matrix(vid, cid).eval_syndrome(torch.from_numpy(word))
    assert got.dtype == torch.uint8 and got.shape == (2, 3, tg.cnum)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JMatrix(vid, cid).eval_syndrome(word)))


DECODES = [  # (decoder kwargs, port dtype, JAX use_pallas)
    (dict(check_rule="minsum"), torch.float32, False),
    (dict(check_rule="minsum", minsum_alpha=1.0, minsum_beta=0.3),
     torch.float32, False),
    (dict(), torch.float32, False),
    (dict(check_phi="tanhfb"), torch.float32, False),
    (dict(check_rule="minsum"), torch.bfloat16, True),
    (dict(), torch.bfloat16, True),
]


def _ids(case):
    kw, dtype, _ = case
    rule = ("offset-minsum" if "minsum_beta" in kw
            else kw.get("check_rule", kw.get("check_phi", "phi")))
    return f"{rule}-{str(dtype)[6:]}"


@pytest.mark.parametrize("name", list(CODES))
@pytest.mark.parametrize("case", DECODES, ids=[_ids(c) for c in DECODES])
def test_decode_batch_matches_jax(case, name):
    kw, dtype, use_pallas = case
    vid, cid = CODES[name]
    _, synd, llr = frames(vid, cid)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    js, ji, jf = jdec.Decoder(vid, cid, dtype=jdt, use_pallas=use_pallas,
                              **kw).decode_batch(llr, synd, 30)
    dec = Decoder(vid, cid, dtype, device="cpu", **kw)
    ts, ti, tf = dec.decode_batch(torch.from_numpy(llr),
                                  torch.from_numpy(synd), 30)
    assert ts.dtype == torch.bool and ti.dtype == torch.int32
    assert tf.dtype == dtype and tuple(tf.shape) == llr.shape
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert 0 < int(ts.sum()) < len(llr)
    assert dec.iterations_run == 30       # a failing frame runs them all
    want = np.asarray(jf.astype(jnp.float32))
    got = tf.float().numpy()
    if kw.get("check_rule") == "minsum":
        np.testing.assert_array_equal(got, want)
    else:
        tol = 2 ** -4 if dtype == torch.bfloat16 else 2e-4
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("maxiter", [0, 1, 2])
def test_decode_short_budgets_match_jax(maxiter):
    """Small budgets: the post-loop consistency tail decides frames that
    converge on the last update (min-sum, bit-exact)."""
    vid, cid = CODES["irregular"]
    _, synd, llr = frames(vid, cid, B=16, seed=8)
    want = jdec.Decoder(vid, cid, dtype=jnp.float32,
                        check_rule="minsum").decode_batch(llr, synd, maxiter)
    dec = Decoder(vid, cid, torch.float32, device="cpu", check_rule="minsum")
    got = dec.decode_batch(torch.from_numpy(llr), torch.from_numpy(synd),
                           maxiter)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert dec.iterations_run <= maxiter


@pytest.mark.parametrize("kw", [
    dict(check_rule="bogus"), dict(check_phi="bogus"),
    dict(minsum_beta=-1.0), dict(dtype="float16"),
])
def test_constructor_validation(kw):
    vid, cid = CODES["regular"]
    with pytest.raises(ValueError):
        Decoder(vid, cid, device="cpu", **kw)
    with pytest.raises(ValueError, match="Sizes"):
        TannerGraph(vid, cid[:-1])


def test_scalar_utils_match_jax():
    from qamreconciliation_tpu.utils import scalar as jscalar

    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 1.0, (4, 9))
    np.testing.assert_array_equal(dist_cut(torch.from_numpy(x)).numpy(),
                                  np.asarray(jscalar.dist_cut(x)))
    word = rng.integers(0, 2, (4, 9))
    np.testing.assert_array_equal(
        count_errors_from_lappr(torch.from_numpy(x),
                                torch.from_numpy(word)).numpy(),
        np.asarray(jscalar.count_errors_from_lappr(jnp.asarray(x),
                                                   jnp.asarray(word))))


# ------------------------------------------- truth tables (per-node API)


@pytest.fixture
def small_decoder():
    # 3 vars, 2 checks, 4 edges
    return Decoder([0, 1, 1, 2], [0, 0, 1, 1], torch.float64, device="cpu")


def test_counts(small_decoder):
    d = small_decoder
    assert (d.cnum, d.vnum, d.ednum) == (2, 3, 4)


def test_check_synd_node(small_decoder):
    d = small_decoder
    synd0, synd1 = [1, 1], [0, 1]
    for w in ([1, 0, 1], [0, 1, 0]):
        assert d.check_synd_node(0, w, synd0)
        assert d.check_synd_node(1, w, synd0)
        assert not d.check_synd_node(0, w, synd1)
        assert d.check_synd_node(1, w, synd1)
    for w in ([0, 0, 1], [1, 1, 0]):
        assert d.check_synd_node(0, w, synd1)
        assert d.check_synd_node(1, w, synd1)
        assert not d.check_synd_node(0, w, synd0)
        assert d.check_synd_node(1, w, synd0)
    with pytest.raises(ValueError, match="word"):
        d.check_synd_node(0, [1, 0], synd0)


def test_check_word(small_decoder):
    d = small_decoder
    assert d.check_word([1, 0, 1], [1, 1])
    assert d.check_word([0, 1, 0], [1, 1])
    assert d.check_word([0, 0, 1], [0, 1])
    assert not d.check_word([1, 0, 1], [0, 1])
    assert not d.check_word([0, 0, 1], [1, 1])


def test_check_lappr(small_decoder):
    d = small_decoder
    assert d.check_lappr(np.array([-3.4, 0.8, -0.1]), [1, 1])
    assert not d.check_lappr(np.array([-3.4, 0.8, -0.1]), [0, 1])
    assert d.check_lappr(np.array([-0.77, -0.8, 0.98]), [0, 1])
    assert not d.check_lappr(np.array([-0.77, -0.8, 0.98]), [1, 1])


@pytest.fixture
def proc_decoder():
    # 5 vars, 3 checks, 8 edges
    cid = np.array([0, 0, 0, 1, 1, 2, 2, 2])
    vid = np.array([0, 1, 3, 1, 2, 1, 3, 4])
    return Decoder(vid, cid, torch.float64, device="cpu")


def test_process_var_node(proc_decoder):
    rng = np.random.default_rng(1)
    d = proc_decoder
    c2v, v2c = rng.standard_normal(d.ednum), rng.standard_normal(d.ednum)
    prior = rng.standard_normal(d.vnum)
    upd = np.empty(d.vnum)
    v2c1, upd1 = d.process_var_node(1, prior, c2v, v2c, upd)   # degree 3
    t = prior[1] + c2v[1] + c2v[3] + c2v[5]
    np.testing.assert_allclose(upd1[1], t, rtol=1e-12)
    for e in (1, 3, 5):
        np.testing.assert_allclose(v2c1[e], t - c2v[e], rtol=1e-12)
    v2c2, upd2 = d.process_var_node(2, prior, c2v, v2c, upd)   # degree 1
    np.testing.assert_allclose(v2c2[4], prior[2], rtol=1e-12)
    np.testing.assert_allclose(upd2[2], prior[2] + c2v[4], rtol=1e-12)
    v2c3, _ = d.process_var_node(3, prior, c2v, v2c, upd)      # degree 2
    np.testing.assert_allclose(v2c3[2], prior[3] + c2v[6], rtol=1e-12)
    np.testing.assert_allclose(v2c3[6], prior[3] + c2v[2], rtol=1e-12)


def test_process_check_node_vs_tanh(proc_decoder):
    rng = np.random.default_rng(2)
    d = proc_decoder
    c2v, v2c = rng.standard_normal(d.ednum), rng.standard_normal(d.ednum)
    s = np.array([1, 0, 1])
    out = d.process_check_node(1, s, c2v, v2c)                 # degree 2
    pre = -2.0 if s[1] else 2.0
    np.testing.assert_allclose(out[3], pre * v2c[4] / 2, rtol=1e-6)
    np.testing.assert_allclose(out[4], pre * v2c[3] / 2, rtol=1e-6)
    out = d.process_check_node(2, s, c2v, v2c)                 # degree 3
    pre = -2.0 if s[2] else 2.0
    np.testing.assert_allclose(
        out[5], pre * np.arctanh(np.tanh(v2c[6] / 2) * np.tanh(v2c[7] / 2)),
        rtol=1e-6)
    np.testing.assert_allclose(
        out[6], pre * np.arctanh(np.tanh(v2c[5] / 2) * np.tanh(v2c[7] / 2)),
        rtol=1e-6)


def test_phi_is_involution():
    x = torch.linspace(1e-6, 40.0, 1000, dtype=torch.float64)
    torch.testing.assert_close(phi_llr(phi_llr(x)), x, rtol=1e-7, atol=1e-9)


def test_phi_check_update_equals_box_plus():
    """The check-major phi update through the graph's permutation equals the
    per-node float64 box-plus update for a degree-4 check."""
    rng = np.random.default_rng(4)
    d = Decoder(np.arange(4), np.zeros(4, int), torch.float64, device="cpu")
    v2c = rng.standard_normal(4)
    g = d.graph
    for synd_bit in (0, 1):
        want = d.process_check_node(0, np.array([synd_bit]), np.zeros(4), v2c)
        v2c_c = g.permute_v_to_c(torch.from_numpy(v2c).reshape(-1, 1))
        _, c_mask = g._masks(torch.float64)
        out = check_node_update(v2c_c, torch.full((1, 1), synd_bit), c_mask)
        got = out.reshape(4).numpy()[np.argsort(g.chk_slot_of_edge)]
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert float(box_plus(torch.tensor(1.0), torch.tensor(-2.0))) < 0


@pytest.fixture
def hamming_decoder():
    vid, cid = edgefile.load_edge_csv(HAMMING_CSV)
    return Decoder(vid, cid, torch.float64, device="cpu")


def test_decode_consistent_input_passthrough(hamming_decoder):
    lappr = np.array([1.2, -0.8, -1.3, 1.1, -0.4, 0.5, 1.9])
    success, iters, final = hamming_decoder.decode(
        lappr, np.array([1, 1, 0], np.uint8), 20)
    assert success and iters == 0
    np.testing.assert_array_equal(final, lappr)


def test_decode_corrects_one_unreliable_bit(hamming_decoder):
    lappr = np.array([1.05, -1.075, -1.0, 1.1, -0.4, 0.4, -0.2])
    success, iters, final = hamming_decoder.decode(
        lappr, np.array([1, 1, 0], np.uint8), 20)
    assert success and 1 <= iters <= 20
    np.testing.assert_array_equal((final < 0).astype(int),
                                  [0, 1, 1, 0, 1, 0, 0])


def test_decode_failure_semantics(hamming_decoder):
    lappr = np.array([1.05, -1.075, -1.0, 1.1, -0.4, 0.4, -0.2])
    success, iters, _ = hamming_decoder.decode(
        lappr, np.array([1, 1, 0], np.uint8), 0)
    assert not success and iters == 0


def test_batch_matches_single(hamming_decoder):
    rng = np.random.default_rng(5)
    lappr = rng.standard_normal((16, 7))
    synd = rng.integers(0, 2, size=(16, 3)).astype(np.uint8)
    succ, iters, final = hamming_decoder.decode_batch(
        torch.from_numpy(lappr), torch.from_numpy(synd), 20)
    for b in range(16):
        s, it, fin = hamming_decoder.decode(lappr[b], synd[b], 20)
        assert (bool(succ[b]), int(iters[b])) == (s, it)
        np.testing.assert_allclose(final[b].numpy(), fin, rtol=1e-10)


def test_edge_csv_roundtrip_matches_jax(tmp_path):
    from qamreconciliation_tpu.utils import edgefile as jedge

    vid, cid = CODES["irregular"]
    path = str(tmp_path / "code.csv")
    edgefile.save_edge_csv(path, vid, cid)
    for got, want in zip(edgefile.load_edge_csv(path),
                         jedge.load_edge_csv(path)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(edgefile.load_edge_csv(path)[0], vid)
    for got, want in zip(edgefile.make_regular_ldpc(96, 3, 6, seed=4),
                         jedge.make_regular_ldpc(96, 3, 6, seed=4)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------- the C++ scalar oracle


def test_f64_decode_matches_cpp_oracle():
    graphcore = pytest.importorskip(
        "qamreconciliation_tpu._graphcore",
        reason="no C++ toolchain on this host",
    )
    vid, cid = edgefile.make_regular_ldpc(256, dv=3, dc=6, seed=3)
    sd = graphcore.ScalarDecoder(vid, cid)
    dec = Decoder(vid, cid, torch.float64, device="cpu")
    rng = np.random.default_rng(7)
    n_match = 0
    for _ in range(10):
        word = rng.integers(0, 2, sd.vnum).astype(np.uint8)
        synd = sd.eval_syndrome(word)
        np.testing.assert_array_equal(
            Matrix(vid, cid).eval_syndrome(torch.from_numpy(word)).numpy(),
            synd)
        llr = (1 - 2 * word.astype(np.float64)) * 4.0 + rng.normal(
            0, 3.0, sd.vnum)
        s_c, i_c, f_c = sd.decode(llr, synd, 30)
        s_t, i_t, f_t = dec.decode(llr, synd, 30)
        assert (s_c, i_c) == (s_t, i_t)
        np.testing.assert_allclose(f_t, f_c, rtol=1e-8, atol=1e-8)
        n_match += s_c
    assert 0 < n_match < 10
