"""Port parity: the compressed-state min-sum QC decoder (``compressed=True``).

The port's compressed loop (``QCDecoder._decode_compressed``: per check two
magnitudes and a packed argmin/sign word in place of the dense messages)
against the JAX package's ``_build_compressed`` and against the port's own
dense min-sum decode (the plain version of kernel 1 on the CPU, whose
arithmetic the card's kernel equals bit for bit): success, iters and finals
bit-identical, in bf16 and f32, normalized and offset min-sum, on a regular
and an irregular (QC-IRA) code.  The counterpart of
tests/test_qc_compressed.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models import qc_decoder as jqc
from qamreconciliation_tpu_torch.models import qc_decoder as tqc
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine

torch.set_num_threads(1)

_J = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
_T = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CODES = {
    "regular": lambda: (tqc.make_qc_ldpc(12, 16, 3, 6, seed=4)[0], 16),
    "ira": lambda: (tqc.make_qc_ira(8, 4, 16, dv=3, seed=2)[0], 16),
}
MINSUM = {"normalized": {}, "offset": dict(minsum_alpha=1.0,
                                           minsum_beta=0.3)}


def frames(base, z, B, seed, noise=2.0):
    """numpy-seeded LLRs [B, V] and syndromes [B, C] of random words."""
    mat = Matrix(*tqc._expand(base, z))
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 2, (B, mat.vnum))
    synd = mat.eval_syndrome(torch.from_numpy(word)).numpy()
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, noise, word.shape)
    return llr, synd


def decode(dec, llr, synd, maxiter=30):
    s, i, f = dec.decode_batch(torch.from_numpy(llr), torch.from_numpy(synd),
                               maxiter)
    return s.numpy(), i.numpy(), f.float().numpy()


@pytest.mark.parametrize("ms", list(MINSUM))
@pytest.mark.parametrize("dtype", list(_T))
@pytest.mark.parametrize("name", list(CODES))
def test_compressed_matches_jax_compressed_and_dense(name, dtype, ms):
    """Bit for bit against the JAX compressed decode and the port's dense
    min-sum decode, on frames of which some converge at different
    iterations and some fail."""
    base, z = CODES[name]()
    llr, synd = frames(base, z, 12, 1, noise=2.4)
    jdec = jqc.QCDecoder(base, z, dtype=_J[dtype], check_rule="minsum",
                         compressed=True, **MINSUM[ms])
    js, ji, jf = (np.asarray(a, np.float32)
                  for a in jdec.decode_batch(llr, synd, 30))
    got = decode(tqc.QCDecoder(base, z, _T[dtype], device="cpu",
                               check_rule="minsum", compressed=True,
                               **MINSUM[ms]), llr, synd)
    dense = decode(tqc.QCDecoder(base, z, _T[dtype], device="cpu",
                                 check_rule="minsum", **MINSUM[ms]),
                   llr, synd)
    for g, d, w in zip(got, dense, (js, ji, jf)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, d)
    assert 0 < js.sum() < 12 and len(set(ji[js > 0])) > 1


def test_compressed_consistent_input_passthrough():
    """iters == 0 and the LLRs passed through for consistent inputs
    (reference: qamreconciliation/decoder.pyx:402-405)."""
    base, z = CODES["regular"]()
    llr, synd = frames(base, z, 4, 2, noise=0.0)
    s, i, f = decode(tqc.QCDecoder(base, z, torch.float32, device="cpu",
                                   check_rule="minsum", compressed=True),
                     llr, synd)
    assert s.all() and (i == 0).all()
    np.testing.assert_array_equal(f, llr.astype(np.float32))


def test_compressed_iteration_count_and_maxiter_zero():
    """The loop runs one check pass an iteration and stops when every frame
    is done; maxiter 0 leaves the consistency tail alone, as the dense
    loop does."""
    base, z = CODES["regular"]()
    llr, synd = frames(base, z, 6, 3, noise=2.4)
    for maxiter in (0, 1, 7):
        comp = tqc.QCDecoder(base, z, torch.float32, device="cpu",
                             check_rule="minsum", compressed=True)
        dense = tqc.QCDecoder(base, z, torch.float32, device="cpu",
                              check_rule="minsum")
        for g, d in zip(decode(comp, llr, synd, maxiter),
                        decode(dense, llr, synd, maxiter)):
            np.testing.assert_array_equal(g, d)
        assert comp.iterations_run == dense.iterations_run <= maxiter


@pytest.mark.parametrize("kw,match", [
    (dict(check_rule="sumproduct"), "minsum"),
    (dict(check_rule="minsum", schedule="layered"), "flooding"),
    (dict(check_rule="minsum", resident=True), "resident"),
    (dict(check_rule="minsum", sr_messages=True, dtype=torch.bfloat16),
     "dense flooding"),
])
def test_compressed_rejects_what_jax_rejects(kw, match):
    base, z = CODES["regular"]()
    with pytest.raises(ValueError, match=match):
        tqc.QCDecoder(base, z, device="cpu", compressed=True, **kw)


def test_compressed_rejects_rows_wider_than_the_meta_word():
    """A check row of 27 slots: its signs no longer fit the int32 meta."""
    base = [(0, v, v % 4) for v in range(27)] + [(1, v, 0) for v in range(27)]
    with pytest.raises(ValueError, match="26"):
        tqc.QCDecoder(base, 4, device="cpu", check_rule="minsum",
                      compressed=True)


def test_compressed_engine_drop_in():
    """The compressed decoder drives the reconciliation engine end to end,
    with the same counters as the dense min-sum decoder on the same
    seed."""
    base, vid, cid = tqc.make_qc_ldpc(12, 16, 3, 6, seed=4)
    mat, pa = Matrix(vid, cid), PAMAlphabet(2, 2.0)
    res = []
    for compressed in (True, False):
        dec = tqc.QCDecoder(base, 16, device="cpu", check_rule="minsum",
                            compressed=compressed)
        eng = ReconciliationEngine(dec, mat, pa, batch=8)
        res.append(eng.run_point("softening", 4.5, 20, 16, 10 ** 9,
                                 nmconfig=np.zeros(4, np.uint8), seed=5))
    assert res[0].as_tuple() == res[1].as_tuple()
    assert 0.0 <= res[0].ber <= 1.0 and res[0].frames == 16
