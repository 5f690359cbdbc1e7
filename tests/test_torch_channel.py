"""The port's bf16 channel draw against ``jax.random.normal`` in bf16.

JAX draws a bf16 normal from 7 random mantissa bits (a bf16 uniform on
[nextafter(-1, 0), 1), then ``sqrt(2) * erf_inv(u)``), so it takes 128
distinct values.  The port's ``bf16_normal`` must take the same 128 values,
value for value, each about as often: each value's count is held within 5
binomial standard errors of its JAX count's difference (both draws are
uniform over the 7 bits).  The float32 draw stays ``torch.randn``, and the
symbol draw is float32 uniforms in every dtype, as in the JAX package.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.sims.engine import (
    ReconciliationEngine, bf16_normal, round_generator,
)

torch.set_num_threads(1)

N = 1 << 21


def test_bf16_draw_takes_jax_values_at_jax_frequencies():
    jx = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (N,),
                                      jnp.bfloat16).astype(jnp.float32))
    gen = torch.Generator().manual_seed(0)
    tx = bf16_normal(gen, (N,), "cpu")
    assert tx.dtype == torch.bfloat16
    jv, jc = np.unique(jx, return_counts=True)
    tv, tc = np.unique(tx.float().numpy(), return_counts=True)
    assert len(jv) == len(tv) == 128
    np.testing.assert_array_equal(tv, jv)        # value for value, no ulp off
    p = 1.0 / 128
    se = math.sqrt(2 * N * p * (1 - p))
    assert np.abs(tc - jc).max() <= 5 * se, (np.abs(tc - jc).max(), se)
    # the moments of the reference table
    assert abs(float(tx.float().var()) - float(jx.var())) < 5e-3
    assert float(tx.float().abs().max()) == float(np.abs(jx).max()) == 2.890625


def test_engine_draws_bf16_noise_by_the_jax_rule_and_f32_by_randn():
    base, vid, cid = make_qc_ldpc(12, 32, 3, 6, seed=7)
    dec = QCDecoder(base, 32, device="cpu")
    pa = PAMAlphabet(2, 2.0)
    table = set(np.unique(np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (1 << 16,), jnp.bfloat16).astype(
            jnp.float32))).tolist())
    sigma = 0.5
    for dtype in (torch.bfloat16, torch.float32):
        eng = ReconciliationEngine(dec, Matrix(vid, cid), pa, batch=16,
                                   dtype=dtype)
        x, y = eng._sample_sb(round_generator(3, 0, "cpu"), sigma)
        assert y.dtype == dtype and x.shape == y.shape
        # the symbols: float32 uniforms whatever the dtype
        ref = round_generator(3, 0, "cpu")
        assert torch.equal(x, pa.random_symbols(ref, x.shape, "cpu"))
        s = torch.tensor(sigma, dtype=dtype)
        noise = (y - pa.index_to_value(x, dtype)) / s
        if dtype == torch.bfloat16:
            want = bf16_normal(ref, x.shape, "cpu")
            assert torch.equal(y, pa.index_to_value(x, dtype) + s * want)
            assert set(want.float().unique().tolist()) <= table
        else:
            want = torch.randn(x.shape, generator=ref, dtype=dtype)
            torch.testing.assert_close(noise, want)
