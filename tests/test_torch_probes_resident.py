"""Kernel 9's plain version against the JAX package's
``scripts/probe_resident_vmem.py``, on the CPU (the probe's printed lines:
``test_torch_probes_records.py``).

The JAX probe is loaded by path with ``pl.pallas_call`` patched to
``interpret=True``, and its ``build(rows, z, ZC, B, variant, K)`` kernel
runs at z = 8, ZC = z, B = 8, K = 3 on the 18 block rows of
``make_qc_ldpc(36, 8, 3, 6, seed=12345)``.  Both sides start from the same
numpy state (``probe_resident_vmem.mixed_state``): frames that converge at
the first step, at a later one and never, with ``it0 = 2``.

Tolerances: every output bit for bit.  The totals, messages and final
captures are bf16; the JAX interpret run rounds each bf16 add of its
variable pass (the left fold ``acc + slab`` and ``prior + acc``), as the
port's plain version and kernel do, so the two agree bit for bit rather
than within the one bf16 ulp an add that XLA left unrounded would cost.
done and iters are exact against sublane 0 of the JAX [8, B] outputs.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from qamreconciliation_tpu.models.qc_decoder import (
    make_qc_ldpc as jax_make_qc_ldpc,
)
from qamreconciliation_tpu_torch.ops import kernels as K
from qamreconciliation_tpu_torch.scripts import probe_resident_vmem as P

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Z, B, STEPS, IT0 = 8, 8, 3, 2


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX probe's module, its ``pallas_call`` in interpret mode."""
    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call

    def pallas_call(kernel, **kw):
        kw["interpret"] = True
        return orig(kernel, **kw)

    mp.setattr(pl, "pallas_call", pallas_call)
    mp.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        "jax_probe_resident_vmem",
        os.path.join(REPO, "scripts", "probe_resident_vmem.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    mp.undo()


def jax_rows(z):
    base, _, _ = jax_make_qc_ldpc(36, z, dv=3, dc=6, seed=12345)
    rows = [[] for _ in range(18)]
    for c, v, s in base:
        rows[c].append((int(v), int(s)))
    return rows


def f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("variant", P.VARIANTS)
def test_bookkeeping_matches_the_jax_probe(variant, jax_probe):
    tables = P.code_tables(36 * Z)
    rows = jax_rows(Z)
    assert [[(v, s % Z) for v, s in row] for row in rows] == tables.rows
    state = P.mixed_state(tables, B, 4, "cpu")
    total, c2v, prior, synd8, final, done, iters, viol = state
    step, nb_c, nb_v, dc = jax_probe.build(rows, Z, Z, B, variant, STEPS)
    bf = jnp.bfloat16
    jt = jnp.asarray(total.float().numpy()).astype(bf)
    out = step(jnp.full((1, 1), IT0, jnp.int32),
               jnp.full((1, 1), 10 ** 6, jnp.int32), jt,
               jnp.zeros((nb_c, dc, Z, B), bf), jt,
               jnp.asarray(synd8.numpy()), jt,
               jnp.zeros((8, B), jnp.int32), jnp.zeros((8, B), jnp.int32))
    K.resident_bookkeeping_probe(tables, IT0, 10 ** 6, *state,
                                 variant=variant, k_rounds=STEPS)
    assert np.array_equal(f32(out[0]), total.float().numpy())
    assert np.array_equal(f32(out[1]).reshape(tables.E, Z, B),
                          c2v.float().numpy())
    assert np.array_equal(f32(out[2]), final.float().numpy())
    assert np.array_equal(np.asarray(out[3])[0], done.numpy())
    assert np.array_equal(np.asarray(out[4])[0], iters.numpy())
    if variant in ("nocapture", "full"):
        # frames converge at it0, after it and never
        assert IT0 in iters.tolist() and int(iters.max()) > IT0
        assert 0 < int(done.sum()) < B
    if variant == "full":
        assert not torch.equal(final, prior)


def test_variants_differ_only_in_their_bookkeeping():
    """Totals and messages are the same in every variant (no freeze);
    nobook and violonly leave done and iters, all but full leave final."""
    tables = P.code_tables(36 * 16)
    outs = {}
    for variant in P.VARIANTS:
        state = P.mixed_state(tables, 12, 7, "cpu")
        outs[variant] = K.resident_bookkeeping_probe(
            tables, 0, 10 ** 6, *state, variant=variant, k_rounds=4)
    init = P.mixed_state(tables, 12, 7, "cpu")
    for variant, (total, c2v, final, done, iters, viol) in outs.items():
        assert torch.equal(total, outs["full"][0])
        assert torch.equal(c2v, outs["full"][1])
        level = K.BOOKKEEPING_VARIANTS[variant]
        assert torch.equal(viol, outs["full"][5]) if level else \
            not bool(viol.any())
        if level < 2:
            assert not bool(done.any()) and not bool(iters.any())
        else:
            assert torch.equal(done, outs["full"][3])
            assert torch.equal(iters, outs["full"][4])
        assert torch.equal(final, init[4]) == (variant != "full")


def test_bookkeeping_runs_no_step_past_maxiter():
    """n = max(min(K, maxiter - it0), 0): iterations past maxiter are
    no-ops, and a call past it changes nothing."""
    tables = P.code_tables(36 * 8)
    a = P.mixed_state(tables, 4, 1, "cpu")
    b = [x.clone() for x in a]
    K.resident_bookkeeping_probe(tables, 5, 7, *a, k_rounds=8)
    K.resident_bookkeeping_probe(tables, 5, 10 ** 6, *b, k_rounds=2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = [x.clone() for x in a]
    K.resident_bookkeeping_probe(tables, 9, 7, *c, k_rounds=8)
    assert all(torch.equal(x, y) for x, y in zip(a, c))


def test_bookkeeping_rejects_what_it_does_not_take():
    tables = P.code_tables(36 * 8)
    state = list(P.mixed_state(tables, 4, 1, "cpu"))
    with pytest.raises(ValueError):
        K.resident_bookkeeping_probe(tables, 0, 9, *state, variant="spill")
    state[0] = state[0].float()
    with pytest.raises(TypeError):
        K.resident_bookkeeping_probe(tables, 0, 9, *state)


def test_probe_inputs_follow_the_jax_draws():
    """The probe's state: the JAX draws in order, prior and final copies of
    the totals, zero messages and counters."""
    tables = P.code_tables(36 * 8)
    total, c2v, prior, synd8, final, done, iters, viol = P.inputs(
        tables, 4, "cpu")
    rng = np.random.default_rng(0)
    want_t = torch.as_tensor(rng.normal(0, 3, (36, 8, 4)),
                             dtype=torch.bfloat16)
    want_s = rng.integers(0, 2, (18, 8, 4))
    assert torch.equal(total, want_t) and torch.equal(prior, want_t)
    assert torch.equal(final, want_t) and final.data_ptr() != \
        total.data_ptr()
    assert np.array_equal(synd8.numpy(), want_s)
    assert not bool(c2v.any()) and c2v.shape == (108, 8, 4)
    assert not any(bool(x.any()) for x in (done, iters, viol))
