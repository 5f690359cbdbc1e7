"""Port parity: the layered schedule's plain loop.

* The port's layered loop (plain PyTorch) against the JAX package's XLA
  layered loop, serial (``layered_groups=False``) and grouped (``True``):
  (success, iters) identical, min-sum totals bit-exact for any
  ``layered_chunk``, f32 sum-product within rtol/atol 2e-4 (the phi sums
  fold in another order), float64 within 1e-9.
* ``color_disjoint_rows`` / ``layered_plan`` equal to the JAX package's.

The resident layered decoder is in test_torch_resident_layered.py.
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


@pytest.mark.parametrize("rule,kw,groups", [
    ("minsum-f32", dict(check_rule="minsum"), False),
    ("minsum-f32", dict(check_rule="minsum"), True),
    ("minsum-bf16", dict(check_rule="minsum", dtype="bfloat16"), True),
    ("phi-f32", dict(), False),
], ids=["minsum-f32-serial", "minsum-f32-grouped", "minsum-bf16-grouped",
        "phi-f32-serial"])
def test_layered_matches_jax_xla_loop(qc, rule, kw, groups):
    base = qc[0]
    kw = dict(kw)
    dtype = kw.pop("dtype", "float32")
    llr, synd = frames(qc, seed=17)
    jdec = jqc.QCDecoder(base, Z, dtype=jnp.dtype(dtype), schedule="layered",
                         layered_chunk=3, layered_groups=groups, **kw)
    want = decode_jax(jdec, llr, synd, 25)
    assert 0 < want[0].sum() < B
    for chunk in (3, 1, 5):
        tdec = tqc.QCDecoder(base, Z, dtype=dtype, device="cpu",
                             schedule="layered", layered_chunk=chunk,
                             layered_groups=groups, **kw)
        assert_same(decode_torch(tdec, llr, synd, 25), want,
                    exact="minsum" in rule)


def test_layered_irregular_and_maxiter_snapshot_match_jax(ira):
    """The IRA code (I + P^1 cells: a repeated variable block per row);
    maxiter 0 (prior passes through), 2 (failed frames snapshot at the
    maxiter sweep inside a chunk of 3) and 30."""
    base = ira[0]
    llr, synd = frames(ira, seed=3, noise=1.2)
    jdec = jqc.QCDecoder(base, Z, dtype=jnp.float32, schedule="layered",
                         check_rule="minsum", layered_chunk=3)
    tdec = tqc.QCDecoder(base, Z, device="cpu", schedule="layered",
                         check_rule="minsum", layered_chunk=3)
    for maxiter in (0, 2, 30):
        n0 = tdec.iterations_run
        want = decode_jax(jdec, llr, synd, maxiter)
        assert_same(decode_torch(tdec, llr, synd, maxiter), want, True)
        assert tdec.iterations_run - n0 <= maxiter
    assert 0 < want[0].sum()


def test_layered_float64_matches_jax(qc):
    """float64 parity runs keep f64 totals end to end (CPU only)."""
    base = qc[0]
    llr, synd = frames(qc, seed=4)
    jdec = jqc.QCDecoder(base, Z, dtype=jnp.float64, schedule="layered")
    tdec = tqc.QCDecoder(base, Z, dtype="float64", device="cpu",
                         schedule="layered")
    s, i, f = tdec.decode_batch(torch.from_numpy(llr),
                                torch.from_numpy(synd), 20)
    assert f.dtype == torch.float64
    js, ji, jf = jdec.decode_batch(llr, synd, 20)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-9,
                               atol=1e-9)


def test_make_qc_ira_matches_jax():
    base, vid, cid = tqc.make_qc_ira(8, 4, Z, dv=3, seed=2)
    jbase, jvid, jcid = jqc.make_qc_ira(8, 4, Z, dv=3, seed=2)
    assert base == jbase
    np.testing.assert_array_equal(vid, jvid)
    np.testing.assert_array_equal(cid, jcid)


@pytest.mark.parametrize("name", ["regular", "ira", "headline"])
def test_layered_plans_match_jax(name):
    base = {
        "regular": lambda: tqc.make_qc_ldpc(12, Z, 3, 6, seed=4)[0],
        "ira": lambda: tqc.make_qc_ira(8, 4, Z, dv=3, seed=2)[0],
        "headline": lambda: tqc.make_qc_ldpc(180, 360, 3, 6, seed=12345)[0],
    }[name]()
    rows = [[] for _ in range(max(c for c, _, _ in base) + 1)]
    for c, v, s in base:
        rows[c].append((v, s))
    assert tqc.color_disjoint_rows(rows) == jqc.color_disjoint_rows(rows)
    assert tqc.layered_plan(rows) == jqc.layered_plan(rows)
