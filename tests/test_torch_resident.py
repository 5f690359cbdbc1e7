"""Port parity: the resident flooding decoder.

``QCDecoder(resident=True)`` (torch, CPU: the multi-iteration kernel's plain
version) against the JAX resident decoder, whose Pallas kernel runs in
interpret mode, on numpy-seeded frames: (success, iters) identical, min-sum
totals bit-exact, f32 sum-product totals within rtol/atol 2e-4 (the two
sides sum and round in different orders and libms), bf16 tanh-F/B totals
within 2^-6 (a one-ulp message difference moves a bf16 total by a few ulps).
Also the chunk overrun, the ``iters == 0`` pass-through, the port's own
resident == dense tier and the constructor's validation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models import qc_decoder as jqc
from qamreconciliation_tpu_torch.models import qc_decoder as tqc
from qamreconciliation_tpu_torch.models.matrix import Matrix

torch.set_num_threads(1)

Z, B = 16, 8


@pytest.fixture(scope="module")
def qc():
    return tqc.make_qc_ldpc(12, Z, 3, 6, seed=4)


@pytest.fixture(scope="module")
def ira():
    return jqc.make_qc_ira(nb_info=8, nb_acc=4, z=Z, dv=3, seed=2)


def frames(code, seed, noise=2.0, scale=3.0):
    base, vid, cid = code
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 2, (B, mat.vnum))
    synd = mat.eval_syndrome(torch.from_numpy(word)).numpy()
    llr = (1 - 2 * word) * scale + rng.normal(0, noise, word.shape)
    return llr, synd


def decode_torch(dec, llr, synd, maxiter):
    s, i, f = dec.decode_batch(torch.from_numpy(llr), torch.from_numpy(synd),
                               maxiter)
    return s.numpy(), i.numpy(), f.float().numpy()


def decode_jax(dec, llr, synd, maxiter):
    s, i, f = dec.decode_batch(llr, synd, maxiter)
    return np.asarray(s), np.asarray(i), np.asarray(f.astype(jnp.float32))


VARIANTS = [
    # (label, dtype, decoder keywords shared by both sides)
    ("minsum-f32", "float32", dict(check_rule="minsum")),
    ("minsum-bf16", "bfloat16", dict(check_rule="minsum")),
    ("phi-f32", "float32", dict()),
    ("tanhfb-bf16", "bfloat16", dict(resident_phi="tanhfb")),
    ("f32totals-minsum-bf16", "bfloat16",
     dict(check_rule="minsum", totals_dtype="float32")),
]


@pytest.mark.parametrize("label,dtype,kw", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_resident_matches_jax_resident(qc, label, dtype, kw):
    base = qc[0]
    llr, synd = frames(qc, seed=1)
    jdec = jqc.QCDecoder(base, Z, dtype=jnp.dtype(dtype), resident=True,
                         resident_chunk=4, **kw)
    tdec = tqc.QCDecoder(base, Z, dtype=dtype, device="cpu", resident=True,
                         resident_chunk=4, **kw)
    s0, i0, f0 = decode_jax(jdec, llr, synd, 25)
    s1, i1, f1 = decode_torch(tdec, llr, synd, 25)
    np.testing.assert_array_equal(s1, s0)
    np.testing.assert_array_equal(i1, i0)
    assert 0 < s0.sum() and i0.max() > 0
    assert tdec.iterations_run > 0
    if "minsum" in label:
        np.testing.assert_array_equal(f1, f0)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(f1, f0, rtol=2 ** -6, atol=2 ** -6)
    else:
        np.testing.assert_allclose(f1, f0, rtol=2e-4, atol=2e-4)


def test_resident_chunk_overrun_and_passthrough(qc):
    """maxiter not a multiple of the chunk: iterations past maxiter never
    run, so failed frames' finals stop exactly at maxiter; a consistent
    input passes through with iters == 0."""
    base, vid, cid = qc
    jdec = jqc.QCDecoder(base, Z, dtype=jnp.float32, check_rule="minsum",
                         resident=True, resident_chunk=4)
    tdec = tqc.QCDecoder(base, Z, device="cpu", check_rule="minsum",
                         resident=True, resident_chunk=4)
    llr, synd = frames(qc, seed=7, noise=3.0)
    for maxiter in (0, 1, 7):
        n0 = tdec.iterations_run
        want = decode_jax(jdec, llr, synd, maxiter)
        got = decode_torch(tdec, llr, synd, maxiter)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # iterations actually run on the device: the chunk is cut at maxiter
        assert tdec.iterations_run - n0 == maxiter
    word = (llr < 0).astype(np.int64)
    synd_ok = Matrix(vid, cid).eval_syndrome(torch.from_numpy(word)).numpy()
    s, i, f = decode_torch(tdec, llr, synd_ok, 10)
    assert s.all()
    np.testing.assert_array_equal(i, 0)
    np.testing.assert_array_equal(f, llr.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("code", ["qc", "ira"])
def test_resident_equals_dense_minsum(request, code, dtype):
    """The port's resident and dense paths: bit-identical min-sum."""
    noise = {"qc": 2.0, "ira": 1.2}[code]
    code = request.getfixturevalue(code)
    base = code[0]
    llr, synd = frames(code, seed=5, noise=noise)
    dense = tqc.QCDecoder(base, Z, dtype=dtype, device="cpu",
                          check_rule="minsum")
    res = tqc.QCDecoder(base, Z, dtype=dtype, device="cpu",
                        check_rule="minsum", resident=True, resident_chunk=3)
    want = decode_torch(dense, llr, synd, 20)
    got = decode_torch(res, llr, synd, 20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < want[0].sum()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("check_phi", ["phi", "tanhfb"])
@pytest.mark.parametrize("resident_phi", ["auto", "phi", "tanhfb"])
def test_resident_phi_resolution_matches_jax(qc, dtype, check_phi,
                                             resident_phi):
    base = qc[0]
    jdec = jqc.QCDecoder(base, Z, dtype=jnp.dtype(dtype), resident=True,
                         check_phi=check_phi, resident_phi=resident_phi)
    jdec._build()                 # resolves the attribute
    tdec = tqc.QCDecoder(base, Z, dtype=dtype, device="cpu", resident=True,
                         check_phi=check_phi, resident_phi=resident_phi)
    assert tdec._resident_phi_resolved == jdec._resident_phi_resolved
    assert tdec._resident_layout(B) == jdec._resident_layout(B)


@pytest.mark.parametrize("kw", [
    dict(resident=True, compressed=True, check_rule="minsum"),
    dict(resident_chunk=0), dict(resident_phi="bogus"),
    dict(resident=True, resident_rowgroup=1), dict(layered_chunk=0),
    dict(schedule="layered", compressed=True, check_rule="minsum"),
])
def test_resident_option_validation_matches_jax(qc, kw):
    base = qc[0]
    with pytest.raises(ValueError):
        jqc.QCDecoder(base, Z, **kw)
    with pytest.raises(ValueError):
        tqc.QCDecoder(base, Z, device="cpu", **kw)


def test_tpu_layout_options_are_accepted_without_effect(qc):
    base = qc[0]
    llr, synd = frames(qc, seed=2)
    plain = tqc.QCDecoder(base, Z, device="cpu", check_rule="minsum",
                          resident=True)
    tpu = tqc.QCDecoder(base, Z, device="cpu", check_rule="minsum",
                        resident=True, resident_double=True,
                        resident_zchunk=8, resident_rowgroup=3)
    for g, w in zip(decode_torch(tpu, llr, synd, 10),
                    decode_torch(plain, llr, synd, 10)):
        np.testing.assert_array_equal(g, w)
