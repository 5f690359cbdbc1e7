"""Port parity: the fused QC check phase.

``bp_check_phase_qc_ref`` (torch, CPU) against the JAX Pallas kernel
``bp_check_phase_qc`` run in interpret mode, on numpy-seeded inputs at
nb_c=3, dc=6, z=24, B=8: the convergence mask is exact, min-sum is
bit-exact, and phi/tanhfb are within atol 1e-6 (plus rtol 1e-6 for the
magnitudes near phi's ~69 saturation) in f32 or one bf16 ulp with bf16
message storage.  The CUDA kernel against the plain version is in
test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.ops.pallas_kernels import (
    bp_check_phase_qc as jax_check_phase,
)
from qamreconciliation_tpu_torch.ops.kernels import bp_check_phase_qc

torch.set_num_threads(1)

NB_C, DC, Z, B = 3, 6, 24, 8
RULES = [
    ("sumproduct", {}),
    ("tanhfb", {}),
    ("minsum", {}),
    ("minsum", dict(ms_alpha=1.0, ms_beta=0.3)),
]
DTYPES = [  # (t, c2v) storage pairs
    ("float32", "float32"),
    ("bfloat16", "bfloat16"),
    ("float32", "bfloat16"),
]
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_inputs(seed, irregular=False, shape=(NB_C, DC, Z, B)):
    """numpy (t, c2v, synd); with ``irregular`` short rows carry the +1e30
    padded-slot sentinel in t, as the decoder's gather writes it."""
    nb_c, dc, z, b = shape
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 3, shape).astype(np.float32)
    c2v = rng.normal(0, 1, shape).astype(np.float32)
    synd = rng.integers(0, 2, (nb_c, z, b)).astype(np.int32)
    if irregular:
        for cb, deg in enumerate([dc - 2, dc, dc - 1][:nb_c]):
            t[cb, deg:] = 1e30
    return t, c2v, synd


def bf16_ulp(x):
    """One bf16 ulp at |x| (8-bit significand)."""
    a = np.abs(x.astype(np.float32))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 2.0 ** -133)


def assert_close(got, want, rule, m_dtype):
    if rule == "minsum":
        np.testing.assert_array_equal(got, want)
    elif m_dtype == "bfloat16":
        assert np.all(np.abs(got - want) <= bf16_ulp(want)), \
            np.max(np.abs(got - want))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def run_both(t, c2v, synd, t_dtype, m_dtype, rule, kw):
    jo, jviol = jax_check_phase(
        jnp.asarray(t, _J[t_dtype]), jnp.asarray(c2v, _J[m_dtype]),
        jnp.asarray(synd), block_z=8, interpret=True, rule=rule, **kw,
    )
    want = np.asarray(jo.astype(jnp.float32))
    want_conv = np.asarray(jnp.sum(jviol, axis=(0, 1)) == 0)
    to, tviol = bp_check_phase_qc(
        torch.from_numpy(t).to(_T[t_dtype]),
        torch.from_numpy(c2v).to(_T[m_dtype]),
        torch.from_numpy(synd), rule=rule, **kw,
    )
    assert to.dtype == _T[m_dtype] and tviol.dtype == torch.int32
    assert tuple(tviol.shape) == (t.shape[0], t.shape[-1])
    return want, want_conv, to.float().numpy(), (tviol.sum(0) == 0).numpy()


@pytest.mark.parametrize("t_dtype,m_dtype", DTYPES)
@pytest.mark.parametrize("rule,kw", RULES)
def test_check_phase_matches_jax_kernel(rule, kw, t_dtype, m_dtype):
    t, c2v, synd = make_inputs(11)
    # a few frames that satisfy their syndrome, so both mask values occur
    par = (np.sum(t < 0, axis=1) & 1).astype(np.int32)
    synd[..., :3] = par[..., :3]
    want, want_conv, got, got_conv = run_both(t, c2v, synd, t_dtype,
                                              m_dtype, rule, kw)
    np.testing.assert_array_equal(got_conv, want_conv)
    assert want_conv[:3].all() and not want_conv[3:].all()
    assert_close(got, want, rule, m_dtype)


@pytest.mark.parametrize("rule,kw", RULES)
def test_check_phase_irregular_sentinel_matches_jax(rule, kw):
    t, c2v, synd = make_inputs(12, irregular=True)
    want, want_conv, got, got_conv = run_both(t, c2v, synd, "float32",
                                              "float32", rule, kw)
    np.testing.assert_array_equal(got_conv, want_conv)
    assert np.isfinite(got).all()
    assert_close(got, want, rule, "float32")


def test_check_phase_rejects_bad_shapes():
    t = torch.zeros(NB_C, DC, Z, B)
    with pytest.raises(ValueError, match="synd"):
        bp_check_phase_qc(t, t, torch.zeros(NB_C, Z, B + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="rule"):
        bp_check_phase_qc(t, t, torch.zeros(NB_C, Z, B, dtype=torch.int32),
                          rule="bogus")
