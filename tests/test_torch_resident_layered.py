"""Port parity: the resident layered decoder.

``QCDecoder(schedule="layered", resident=True)`` (torch, CPU: the
multi-sweep kernel's plain version) against the JAX resident layered
decoder, whose Pallas kernel runs in interpret mode, and against the port's
serial plain layered loop: (success, iters) identical, min-sum totals
bit-exact, f32 sum-product within rtol/atol 2e-4 (the phi sums fold in
another order).  Also the ``iters == 0`` pass-through of a consistent prior
and the float64 guard (the kernel's totals are float32).
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
    return tqc.make_qc_ira(nb_info=8, nb_acc=4, z=Z, dv=3, seed=2)


def frames(code, seed, noise=2.4):
    base, vid, cid = code
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 2, (B, mat.vnum))
    synd = mat.eval_syndrome(torch.from_numpy(word)).numpy()
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, noise, word.shape)
    return llr, synd


def decode_torch(dec, llr, synd, maxiter):
    s, i, f = dec.decode_batch(torch.from_numpy(llr), torch.from_numpy(synd),
                               maxiter)
    return s.numpy(), i.numpy(), f.float().numpy()


def decode_jax(dec, llr, synd, maxiter):
    s, i, f = dec.decode_batch(llr, synd, maxiter)
    return np.asarray(s), np.asarray(i), np.asarray(f.astype(jnp.float32))


def assert_same(got, want, exact):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if exact:
        np.testing.assert_array_equal(got[2], want[2])
    else:
        np.testing.assert_allclose(got[2], want[2], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("rule,kw", [
    ("minsum-f32", dict(check_rule="minsum")),
    ("minsum-bf16", dict(check_rule="minsum", dtype="bfloat16")),
    ("phi-f32", dict()),
    ("tanhfb-f32", dict(check_phi="tanhfb")),
])
def test_resident_layered_matches_jax_resident_layered(qc, rule, kw):
    base = qc[0]
    kw = dict(kw)
    dtype = kw.pop("dtype", "float32")
    llr, synd = frames(qc, seed=17)
    jdec = jqc.QCDecoder(base, Z, dtype=jnp.dtype(dtype), schedule="layered",
                         resident=True, layered_chunk=3, **kw)
    tdec = tqc.QCDecoder(base, Z, dtype=dtype, device="cpu",
                         schedule="layered", resident=True, layered_chunk=3,
                         **kw)
    want = decode_jax(jdec, llr, synd, 25)
    assert_same(decode_torch(tdec, llr, synd, 25), want,
                exact="minsum" in rule)
    assert 0 < want[0].sum() and tdec.iterations_run > 0


@pytest.mark.parametrize("code", ["qc", "ira"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resident_layered_equals_serial_plain_loop(request, code, dtype):
    noise = {"qc": 2.4, "ira": 1.2}[code]
    code = request.getfixturevalue(code)
    base = code[0]
    llr, synd = frames(code, seed=9, noise=noise)
    plain = tqc.QCDecoder(base, Z, dtype=dtype, device="cpu",
                          schedule="layered", check_rule="minsum",
                          layered_groups=False)
    res = tqc.QCDecoder(base, Z, dtype=dtype, device="cpu",
                        schedule="layered", check_rule="minsum",
                        resident=True)
    want = decode_torch(plain, llr, synd, 20)
    assert_same(decode_torch(res, llr, synd, 20), want, True)
    assert 0 < want[0].sum()


def test_resident_layered_passthrough_and_float64_guard(qc):
    base, vid, cid = qc
    res = tqc.QCDecoder(base, Z, device="cpu", schedule="layered",
                        check_rule="minsum", resident=True)
    rng = np.random.default_rng(3)
    word = rng.integers(0, 2, (4, res.vnum))
    synd = Matrix(vid, cid).eval_syndrome(torch.from_numpy(word)).numpy()
    clean = (1 - 2 * word) * 5.0
    s, i, f = decode_torch(res, clean, synd, 20)
    assert s.all()
    np.testing.assert_array_equal(i, 0)
    np.testing.assert_array_equal(f, clean)
    assert res.iterations_run == 0
    with pytest.raises(ValueError, match="float64"):
        tqc.QCDecoder(base, Z, dtype="float64", device="cpu",
                      schedule="layered", resident=True)
    with pytest.raises(ValueError, match="float64"):
        jqc.QCDecoder(base, Z, dtype=jnp.float64, schedule="layered",
                      resident=True).decode_batch(clean, synd, 5)
