"""Port parity: one step of the multi-sweep layered kernel.

``bp_layered_sweeps_qc_ref`` (torch, CPU; the CUDA kernel's plain version)
against the JAX Pallas kernel ``bp_layered_sweeps_qc`` run in interpret
mode, K = 3 sweeps from a mid-decode state (one sweep from numpy-seeded
channel LLRs, so frames converge inside the step; frame 0 is marked done
before it, so it is frozen throughout).  The codes hold rows with a
repeated variable block, whose deltas the kernel applies in a second phase.
Min-sum is bit-equal on (total, c2v, done, iters); sum-product within
rtol/atol 2e-4 with done and iters equal.  The JAX step carries done/iters
as [8, B] sublane copies: row 0 is the mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models.qc_decoder import make_qc_ira
from qamreconciliation_tpu.ops.pallas_kernels import (
    bp_layered_sweeps_qc as jax_sweeps,
)
from qamreconciliation_tpu_torch.models.qc_decoder import make_qc_ldpc
from qamreconciliation_tpu_torch.ops.kernels import (
    QCTables, bp_layered_sweeps_qc, bp_layered_sweeps_qc_ref, layered_levels,
)

torch.set_num_threads(1)

Z, B, K = 16, 8, 3
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


def mid_decode_state(tables, m_dtype, rule, seed, noise, warm=1):
    """State after ``warm`` sweeps of the plain step from numpy-seeded
    channel LLRs (scale 3, per-frame ``noise``) of a random word and its
    syndrome;
    frame 0 is then marked done (frozen)."""
    rng = np.random.default_rng(seed)
    shape = (tables.nb_v, Z, B)
    word = rng.integers(0, 2, shape)
    total = torch.from_numpy(
        ((1 - 2 * word) * 3.0 + rng.normal(0, 1.0, shape) * noise).astype(np.float32))
    synd = np.zeros((tables.nb_c, Z, B), np.int8)
    for cb, row in enumerate(tables.rows):
        for v, s in row:
            synd[cb] ^= np.roll(word[v], s, axis=0).astype(np.int8)
    state = [total, torch.zeros((tables.E, Z, B), dtype=m_dtype),
             torch.from_numpy(synd), torch.zeros(B, dtype=torch.int32),
             torch.zeros(B, dtype=torch.int32)]
    bp_layered_sweeps_qc_ref(tables, 0, 50, *state, rule=rule,
                             k_sweeps=warm)
    state[3][0] = 1
    return state


def jax_step(rows, rule, it0, state):
    total, c2v, synd, done, iters = state
    step = jax_sweeps(rows, Z, rule="minsum" if rule == "minsum"
                      else "sumproduct", k_sweeps=K, interpret=True,
                      phi_impl="tanhfb" if rule == "tanhfb" else "phi")

    def j(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy(), jnp.bfloat16)
        return jnp.asarray(x.numpy())

    out = step(jnp.full((1, 1), it0, jnp.int32),
               jnp.full((1, 1), 50, jnp.int32), j(total), j(c2v), j(synd),
               jnp.broadcast_to(j(done), (8, B)),
               jnp.broadcast_to(j(iters), (8, B)))
    return [np.asarray(o.astype(jnp.float32)) if o.dtype != jnp.int32
            else np.asarray(o) for o in out]


CASES = [
    # (code, rule, message dtype)
    ("regular", "minsum", "float32"),
    ("regular", "minsum", "bfloat16"),
    ("regular", "sumproduct", "float32"),
    ("regular", "tanhfb", "bfloat16"),
    ("ira", "minsum", "float32"),
    ("ira", "tanhfb", "float32"),
]


@pytest.mark.parametrize("code,rule,m_dtype", CASES)
def test_sweeps_step_matches_jax_kernel(code, rule, m_dtype):
    rows = CODES[code]
    tables = QCTables(rows, Z)
    assert tables.n_defer_slots > 0         # a repeated-variable-block row
    state = mid_decode_state(tables, _T[m_dtype], rule,
                             seed=len(rule) + len(code),
                             noise=NOISE[code])
    frozen0 = state[3].clone()
    want = jax_step(rows, rule, 1, [x.clone() for x in state])
    got = bp_layered_sweeps_qc(tables, 1, 50, *state, rule=rule, k_sweeps=K)
    assert got[0] is state[0] and got[1] is state[1]     # in place
    np.testing.assert_array_equal(got[2].numpy(), want[2][0])
    np.testing.assert_array_equal(got[3].numpy(), want[3][0])
    assert bool(frozen0[0]) and int(frozen0.sum()) < int(got[2].sum()) < B
    for g, w in ((got[0], want[0]), (got[1], want[1])):
        g = g.float().numpy()
        if rule == "minsum":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


def test_levels_are_an_exact_serial_order():
    """Rows of a level touch disjoint variable blocks; along every variable
    block the levels of its rows increase with the row index."""
    for rows in CODES.values():
        levels = layered_levels(rows)
        assert sorted(cb for lev in levels for cb in lev) == \
            list(range(len(rows)))
        level_of = {cb: i for i, lev in enumerate(levels) for cb in lev}
        for lev in levels:
            vbs = [v for cb in lev for v in {v for v, _ in rows[cb]}]
            assert len(vbs) == len(set(vbs))
        seen = {}
        for cb, row in enumerate(rows):
            for v, _ in row:
                assert level_of[cb] > seen.get(v, -1) or seen[v] == \
                    level_of[cb]
            for v, _ in row:
                seen[v] = level_of[cb]
    assert layered_levels([[(0, 0), (1, 1)], [(1, 0)], [(2, 3)],
                           [(0, 2), (2, 1)]]) == [[0, 2], [1, 3]]


def test_deferred_tables_list_each_repeated_row_by_block():
    tables = QCTables([[(0, 1), (1, 2), (0, 5)], [(2, 0), (1, 3)]], 8)
    assert tables.levels == [[0], [1]]
    assert tables.defer_base.tolist() == [0, -1]
    assert tables.n_defer_slots == 3
    # row 0: block 0 gets slots 0 and 2 (in slot order), block 1 slot 1
    assert tables.app_vb.tolist() == [0, 1]
    assert tables.app_off.tolist() == [0, 2, 3]
    assert tables.app_e.tolist() == [0, 2, 1]
    assert tables.app_s.tolist() == [1, 5, 2]
    assert tables.app_level_off.tolist() == [0, 2, 2]


def test_sweeps_step_past_maxiter_is_a_no_op_and_rejects_bad_state():
    tables = QCTables(CODES["regular"], Z)
    state = mid_decode_state(tables, torch.float32, "minsum", seed=3,
                             noise=NOISE["regular"])
    before = [x.clone() for x in state]
    bp_layered_sweeps_qc(tables, 20, 20, *state, rule="minsum", k_sweeps=K)
    assert all(torch.equal(a, b) for a, b in zip(before, state))
    with pytest.raises(ValueError, match="rule"):
        bp_layered_sweeps_qc(tables, 0, 5, *state, rule="bogus")
    with pytest.raises(ValueError, match="synd"):
        bp_layered_sweeps_qc(tables, 0, 5, state[0], state[1],
                             state[2][:, :-1], state[3], state[4])
