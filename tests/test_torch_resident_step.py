"""Port parity: one step of the multi-iteration flooding kernel.

``bp_decode_rounds_qc_ref`` (torch, CPU; the CUDA kernel's plain version)
against the JAX Pallas kernel ``bp_decode_rounds_qc`` run in interpret mode,
K = 3 iterations from a mid-decode state (one flooding iteration from
numpy-seeded channel LLRs, so frames converge inside the step; frame 0 is
marked done before it, so it is frozen throughout).  Min-sum is bit-equal on (total, c2v, done, iters);
sum-product within rtol/atol 2e-4 with done and iters equal (the kernel
folds the phi sum left to right, XLA's reduction may not).  The JAX step
carries done/iters as [8, B] sublane copies: row 0 is the mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models.qc_decoder import make_qc_ira
from qamreconciliation_tpu.ops.pallas_kernels import (
    bp_decode_rounds_qc as jax_rounds,
)
from qamreconciliation_tpu_torch.models.qc_decoder import make_qc_ldpc
from qamreconciliation_tpu_torch.ops.kernels import (
    QCTables, bp_decode_rounds_qc, bp_decode_rounds_qc_ref,
)

torch.set_num_threads(1)

Z, B, K = 16, 8, 3
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# per-frame channel noise of each code: low-noise frames converge early,
# noisy ones stay undecided (the rate-2/3 IRA code needs less noise)
NOISE = {"regular": np.linspace(1.5, 3.5, B), "ira": np.linspace(0.8, 2.4, B)}


def rows_of(base):
    nb_c = max(c for c, _, _ in base) + 1
    rows = [[] for _ in range(nb_c)]
    for c, v, s in base:
        rows[c].append((v, s))
    return rows


CODES = {
    # regular (3,6) code; rows 1, 2 and 5 hold a repeated variable block
    "regular": rows_of(make_qc_ldpc(12, Z, 3, 6, seed=4)[0]),
    # irregular QC-IRA code with I + P^1 cells
    "ira": rows_of(make_qc_ira(nb_info=8, nb_acc=4, z=Z, dv=3, seed=2)[0]),
}


def mid_decode_state(tables, m_dtype, t_dtype, rule, seed, noise,
                     warm=1):
    """State after ``warm`` flooding iterations of the plain step from
    numpy-seeded channel LLRs (scale 3, per-frame ``noise``) of a random word and
    its syndrome; frame 0 is then marked done (frozen)."""
    rng = np.random.default_rng(seed)
    shape = (tables.nb_v, Z, B)
    word = rng.integers(0, 2, shape)
    prior = torch.from_numpy(
        ((1 - 2 * word) * 3.0 + rng.normal(0, 1.0, shape) * noise).astype(np.float32)
    ).to(m_dtype)
    synd = np.zeros((tables.nb_c, Z, B), np.int8)
    for cb, row in enumerate(tables.rows):
        for v, s in row:
            synd[cb] ^= np.roll(word[v], s, axis=0).astype(np.int8)
    state = [prior.to(t_dtype, copy=True),
             torch.zeros((tables.E, Z, B), dtype=m_dtype), prior,
             torch.from_numpy(synd), torch.zeros(B, dtype=torch.int32),
             torch.zeros(B, dtype=torch.int32)]
    bp_decode_rounds_qc_ref(tables, 0, 50, *state, rule=rule, k_rounds=warm)
    state[4][0] = 1
    return state


def jax_step(rows, rule, phi_impl, totals_f32, it0, state):
    total, c2v, prior, synd, done, iters = state
    step = jax_rounds(rows, Z, rule="minsum" if rule == "minsum"
                      else "sumproduct", k_rounds=K, interpret=True,
                      phi_impl=phi_impl, totals_f32=totals_f32)

    def j(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy(), jnp.bfloat16)
        return jnp.asarray(x.numpy())

    out = step(jnp.full((1, 1), it0, jnp.int32),
               jnp.full((1, 1), 50, jnp.int32), j(total), j(c2v), j(prior),
               j(synd), jnp.broadcast_to(j(done), (8, B)),
               jnp.broadcast_to(j(iters), (8, B)))
    return [np.asarray(o.astype(jnp.float32)) if o.dtype != jnp.int32
            else np.asarray(o) for o in out]


CASES = [
    # (code, rule, message dtype, totals dtype)
    ("regular", "minsum", "float32", "float32"),
    ("regular", "minsum", "bfloat16", "bfloat16"),
    ("regular", "minsum", "bfloat16", "float32"),
    ("regular", "sumproduct", "float32", "float32"),
    ("regular", "tanhfb", "bfloat16", "bfloat16"),
    ("ira", "minsum", "float32", "float32"),
    ("ira", "sumproduct", "float32", "float32"),
]


@pytest.mark.parametrize("code,rule,m_dtype,t_dtype", CASES)
def test_rounds_step_matches_jax_kernel(code, rule, m_dtype, t_dtype):
    rows = CODES[code]
    tables = QCTables(rows, Z)
    state = mid_decode_state(tables, _T[m_dtype], _T[t_dtype], rule,
                             seed=len(rule) + len(code),
                             noise=NOISE[code])
    frozen0 = state[4].clone()
    want = jax_step(rows, rule, "tanhfb" if rule == "tanhfb" else "phi",
                    t_dtype != m_dtype, 1, [x.clone() for x in state])
    got = bp_decode_rounds_qc(tables, 1, 50, *state, rule=rule, k_rounds=K)
    assert got[0] is state[0] and got[1] is state[1]     # in place
    np.testing.assert_array_equal(got[2].numpy(), want[2][0])
    np.testing.assert_array_equal(got[3].numpy(), want[3][0])
    # frames converge inside the step, others stay undecided
    assert bool(frozen0[0]) and int(frozen0.sum()) < int(got[2].sum()) < B
    for g, w in ((got[0], want[0]), (got[1], want[1])):
        g = g.float().numpy()
        if rule == "minsum":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


def test_rounds_step_past_maxiter_is_a_no_op():
    tables = QCTables(CODES["regular"], Z)
    state = mid_decode_state(tables, torch.float32, torch.float32, "minsum",
                             seed=3, noise=NOISE["regular"])
    before = [x.clone() for x in state]
    bp_decode_rounds_qc(tables, 50, 50, *state, rule="minsum", k_rounds=K)
    assert all(torch.equal(a, b) for a, b in zip(before, state))
    # maxiter - it0 = 1 < K: exactly one iteration runs
    one = [x.clone() for x in before]
    bp_decode_rounds_qc(tables, 2, 3, *one, rule="minsum", k_rounds=K)
    ref = [x.clone() for x in before]
    bp_decode_rounds_qc_ref(tables, 2, 50, *ref, rule="minsum", k_rounds=1)
    assert all(torch.equal(a, b) for a, b in zip(one, ref))


def test_rounds_step_rejects_bad_state():
    tables = QCTables(CODES["regular"], Z)
    state = mid_decode_state(tables, torch.float32, torch.float32, "minsum",
                             seed=4, noise=NOISE["regular"])
    with pytest.raises(ValueError, match="rule"):
        bp_decode_rounds_qc(tables, 0, 5, *state, rule="bogus")
    bad = list(state)
    bad[1] = bad[1][:-1]
    with pytest.raises(ValueError, match="c2v"):
        bp_decode_rounds_qc(tables, 0, 5, *bad)
