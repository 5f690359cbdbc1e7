"""Port parity: QC code construction, syndrome and the dense flooding decode.

The port's ``QCDecoder`` (torch, CPU: the check phase runs its plain
version) against the JAX ``QCDecoder`` dense path, with the XLA check phase
(``use_pallas=False``) and with the Pallas kernel in interpret mode
(``use_pallas=True``).  Success and iters are identical; min-sum totals are
bit-exact.  f32 sum-product totals agree within rtol/atol 1e-4: the two
sides use different libms, whose one-ulp differences compound over up to 25
iterations (measured up to 2.8e-5 relative; the JAX package's own f32
QC-vs-generic decode test allows 2e-4).
bf16 storage follows the kernel's semantics (v2c formed in f32), so it is
held against ``use_pallas=True``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models import qc_decoder as jqc
from qamreconciliation_tpu_torch.models import qc_decoder as tqc
from qamreconciliation_tpu_torch.models.matrix import Matrix

torch.set_num_threads(1)

CODES = {
    "z16": dict(nb_v=6, z=16, seed=5),
    "z32": dict(nb_v=12, z=32, seed=7),
}


def code(name):
    p = CODES[name]
    return tqc.make_qc_ldpc(p["nb_v"], p["z"], 3, 6, seed=p["seed"]), p["z"]


def channel(vnum, cnum_mat, B, seed, snr_scale=2.5, noise=2.2):
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 2, (B, vnum))
    synd = cnum_mat.eval_syndrome(torch.from_numpy(word)).numpy()
    llr = (1 - 2 * word) * snr_scale + rng.normal(0, noise, word.shape)
    return word, synd, llr


@pytest.mark.parametrize("name", list(CODES))
def test_make_qc_ldpc_and_csv_match_jax(name, tmp_path):
    p = CODES[name]
    (base, vid, cid), z = code(name)
    jbase, jvid, jcid = jqc.make_qc_ldpc(p["nb_v"], z, 3, 6, seed=p["seed"])
    assert base == jbase
    np.testing.assert_array_equal(vid, jvid)
    np.testing.assert_array_equal(cid, jcid)
    path = str(tmp_path / "code.csv")
    tqc.save_qc_csv(path, base, z)
    assert jqc.load_qc_csv(path) == tqc.load_qc_csv(path) == (base, z)


@pytest.mark.parametrize("irregular", [False, True])
def test_syndrome_from_bits_exact(irregular):
    if irregular:
        base, vid, cid = jqc.make_qc_ira(nb_info=8, nb_acc=4, z=16, dv=3,
                                         seed=2)
        z = 16
    else:
        (base, vid, cid), z = code("z32")
    dec = tqc.QCDecoder(base, z, device="cpu")
    bits = np.random.default_rng(3).integers(0, 2, (dec.vnum, 5))
    got = dec.syndrome_from_bits(torch.from_numpy(bits)).numpy()
    want = np.asarray(jqc.QCDecoder(base, z).syndrome_from_bits(bits))
    np.testing.assert_array_equal(got, want)
    mat_synd = Matrix(vid, cid).eval_syndrome(torch.from_numpy(bits.T))
    np.testing.assert_array_equal(mat_synd.numpy().T, want)


def _decode_pair(base, z, B, seed, jax_kw, torch_kw, maxiter=25,
                 noise=2.2, mixed=True):
    """Decode one numpy-seeded batch on both sides; at the default noise
    some frames converge and some fail, so both branches are compared."""
    mat = Matrix(*tqc._expand(base, z))
    _, synd, llr = channel(mat.vnum, mat, B, seed, noise=noise)
    jdec = jqc.QCDecoder(base, z, **jax_kw)
    tdec = tqc.QCDecoder(base, z, device="cpu", **torch_kw)
    s0, i0, f0 = jdec.decode_batch(llr, synd, maxiter)
    s1, i1, f1 = tdec.decode_batch(llr, synd, maxiter)
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s0))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))
    assert 0 < int(np.asarray(s0).sum()) < B or not mixed
    return np.asarray(f0.astype(jnp.float32)), f1.float().numpy()


def assert_sumproduct_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


F32_VARIANTS = [
    ("phi", dict(), dict()),
    ("tanhfb", dict(check_phi="tanhfb"), dict(check_phi="tanhfb")),
    ("minsum", dict(check_rule="minsum"), dict(check_rule="minsum")),
    ("offset-minsum",
     dict(check_rule="minsum", minsum_alpha=1.0, minsum_beta=0.3),
     dict(check_rule="minsum", minsum_alpha=1.0, minsum_beta=0.3)),
]


@pytest.mark.parametrize("name", list(CODES))
@pytest.mark.parametrize("label,jkw,tkw", F32_VARIANTS,
                         ids=[v[0] for v in F32_VARIANTS])
def test_decode_f32_matches_jax_xla_path(name, label, jkw, tkw):
    (base, _, _), z = code(name)
    want, got = _decode_pair(base, z, 12, 21, dict(dtype=jnp.float32,
                                                   use_pallas=False, **jkw),
                             dict(dtype=torch.float32, **tkw))
    if "minsum" in label:
        np.testing.assert_array_equal(got, want)
    else:
        assert_sumproduct_close(got, want)


@pytest.mark.parametrize("label,dtype,jkw,tkw", [
    ("f32-phi", "float32", dict(), dict()),
    ("bf16-phi", "bfloat16", dict(), dict()),
    ("bf16-minsum", "bfloat16", dict(check_rule="minsum"),
     dict(check_rule="minsum")),
    ("f32totals-bf16-minsum", "bfloat16",
     dict(check_rule="minsum", totals_dtype="float32"),
     dict(check_rule="minsum", totals_dtype="float32")),
])
def test_decode_matches_jax_pallas_interpret(label, dtype, jkw, tkw):
    (base, _, _), z = code("z16")
    want, got = _decode_pair(
        base, z, 8, 22,
        dict(dtype=jnp.dtype(dtype), use_pallas=True, **jkw),
        dict(dtype=dtype, **tkw),
    )
    if "minsum" in label:
        np.testing.assert_array_equal(got, want)
    elif dtype == "bfloat16":
        # totals are bf16: a one-ulp message difference moves a total by at
        # most a few ulps
        np.testing.assert_allclose(got, want, rtol=2 ** -6, atol=2 ** -6)
    else:
        assert_sumproduct_close(got, want)


@pytest.mark.parametrize("rule", ["sumproduct", "minsum"])
def test_decode_irregular_matches_jax(rule):
    """Mixed check degrees + parallel circulants: the +1e30 padded slots."""
    base, _, _ = jqc.make_qc_ira(nb_info=8, nb_acc=4, z=16, dv=3, seed=2)
    want, got = _decode_pair(base, 16, 6, 9,
                             dict(dtype=jnp.float32, use_pallas=False,
                                  check_rule=rule),
                             dict(dtype=torch.float32, check_rule=rule),
                             noise=1.7)
    if rule == "minsum":
        np.testing.assert_array_equal(got, want)
    else:
        assert_sumproduct_close(got, want)


def test_decode_zero_iterations_and_iters_semantics():
    """maxiter 0 and 1: the post-loop consistency tail alone decides."""
    (base, _, _), z = code("z16")
    for maxiter in (0, 1):
        want, got = _decode_pair(base, z, 6, 4, dict(dtype=jnp.float32),
                                 dict(dtype=torch.float32), maxiter=maxiter,
                                 mixed=False)
        assert_sumproduct_close(got, want)


@pytest.mark.parametrize("path", ["compressed", "sr_messages"])
def test_compressed_and_sr_paths_run_and_match_jax(path):
    """The two paths the JAX decoder has beside the dense, resident and
    layered loops run in the port (tests/test_torch_qc_compressed.py and
    test_torch_sr.py hold them in depth): the compressed min-sum decode is
    bit-identical to the JAX compressed decode (success, iters, finals);
    the stochastically rounded bf16 decode converges on the frames the JAX
    SR decode converges on (their random bits differ)."""
    (base, _, _), z = code("z32")
    if path == "compressed":
        want, got = _decode_pair(
            base, z, 12, 21,
            dict(dtype=jnp.bfloat16, check_rule="minsum", compressed=True),
            dict(dtype=torch.bfloat16, check_rule="minsum",
                 compressed=True))
        np.testing.assert_array_equal(got, want)
    else:
        _decode_pair(base, z, 12, 23,
                     dict(dtype=jnp.bfloat16, use_pallas=False,
                          sr_messages=True),
                     dict(dtype=torch.bfloat16, sr_messages=True),
                     noise=1.0, mixed=False)


@pytest.mark.parametrize("kw", [
    dict(check_rule="bogus"), dict(check_phi="bogus"),
    dict(totals_dtype="bogus"), dict(minsum_beta=-1.0),
    dict(dtype="float16"),
])
def test_constructor_validation(kw):
    (base, _, _), z = code("z16")
    with pytest.raises(ValueError):
        tqc.QCDecoder(base, z, device="cpu", **kw)
