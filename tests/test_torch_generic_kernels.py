"""Port parity: the generic decoder's check phase (kernels 4 and 5) and the
check-major box-plus rules.

``bp_check_phase_generic_ref`` (torch, CPU) against the JAX Pallas kernel
``bp_check_phase_generic`` run in interpret mode, and
``check_node_update_fused_ref`` against ``check_node_update_pallas``, on
numpy-seeded inputs with a random, non-prefix mask that also holds a
degree-1 check and an empty one.  The per-frame violation counts are equal;
min-sum is bit-exact; the sum-product forms agree within atol 1e-5 + rtol
1e-3 in f32: the two libms differ by an ulp in phi, and ``phi(s - phi_d)``
magnifies that when one slot dominates the sum s (measured up to 6e-4
relative); bf16 storage within one bf16 ulp (the check-major update
computes in bf16, as the JAX kernel does).  The CUDA kernels against these
plain versions are in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.ops import boxplus as jbp
from qamreconciliation_tpu.ops.pallas_kernels import (
    bp_check_phase_generic as jax_generic,
    check_node_update_pallas as jax_check_major,
)
from qamreconciliation_tpu_torch.ops import boxplus as tbp
from qamreconciliation_tpu_torch.ops.kernels import (
    GENERIC_BLOCK_C, bp_check_phase_generic, bp_check_phase_generic_ref,
    check_node_update_fused, check_node_update_fused_ref,
)

torch.set_num_threads(1)

C, B = 100, 8
RULES = [
    ("sumproduct", {}),
    ("tanhfb", {}),
    ("minsum", {}),
    ("minsum", dict(ms_alpha=1.0, ms_beta=0.3)),
]
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def random_mask(rng, dc, c):
    """[dc, c] 0/1 mask: random with a non-prefix pattern, check 0 of
    degree 1 and check 1 empty."""
    mask = (rng.random((dc, c)) < 0.8).astype(np.float32)
    mask[:, 0] = 0.0
    mask[dc // 2, 0] = 1.0
    mask[:, 1] = 0.0
    # a real slot after a padded one: not a prefix mask
    assert ((mask[:-1] == 0) & (mask[1:] == 1)).any()
    return mask


def make_inputs(seed, dc, c=C, b=B):
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 3, (dc, c, b)).astype(np.float32)
    c2v = rng.normal(0, 1, (dc, c, b)).astype(np.float32)
    synd = rng.integers(0, 2, (c, b)).astype(np.int32)
    mask = random_mask(rng, dc, c)
    # a few frames that satisfy their syndrome, so both outcomes occur
    par = (np.sum((t < 0) * mask[:, :, None].astype(np.int64), 0) & 1)
    synd[:, :3] = par[:, :3]
    return t, c2v, synd, mask


def bf16_ulp(x):
    a = np.abs(x.astype(np.float32))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 2.0 ** -133)


def assert_close(got, want, rule, dtype):
    if rule == "minsum":
        np.testing.assert_array_equal(got, want)
    elif dtype == "bfloat16":
        assert np.all(np.abs(got - want) <= bf16_ulp(want)), \
            np.max(np.abs(got - want))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("dc", [5, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule,kw", RULES)
def test_generic_check_phase_matches_jax_kernel(rule, kw, dtype, dc):
    t, c2v, synd, mask = make_inputs(20 + dc, dc)
    jo, jviol = jax_generic(
        jnp.asarray(t, _J[dtype]), jnp.asarray(c2v, _J[dtype]),
        jnp.asarray(synd), jnp.asarray(mask, _J[dtype]), block_c=32,
        interpret=True, rule=rule, **kw,
    )
    to, tviol = bp_check_phase_generic(
        torch.from_numpy(t).to(_T[dtype]), torch.from_numpy(c2v).to(_T[dtype]),
        torch.from_numpy(synd), torch.from_numpy(mask), rule=rule, **kw,
    )
    assert to.dtype == _T[dtype] and tviol.dtype == torch.int32
    assert tuple(tviol.shape) == (-(-C // GENERIC_BLOCK_C), B)
    want_count = np.asarray(jnp.sum(jviol, axis=0))
    np.testing.assert_array_equal(tviol.sum(0).numpy(), want_count)
    assert (want_count[:3] == 0).all() and (want_count[3:] > 0).any()
    got = to.float().numpy()
    want = np.asarray(jo.astype(jnp.float32))
    assert np.isfinite(got).all()
    assert (got[mask == 0] == 0).all()
    assert_close(got, want, rule, dtype)


@pytest.mark.parametrize("dc", [6, 14, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_check_major_update_matches_jax_kernel(dtype, dc):
    """Kernel 5's plain version against check_node_update_pallas in
    interpret mode, both in the input dtype.  bf16 holds within one bf16
    ulp (measured bit-equal: every operation rounds to bf16 in the same
    order, and the phi sum accumulates in float32 as jnp.sum does for
    bf16); f32 within atol 1e-5 + rtol 1e-3 (the libms)."""
    rng = np.random.default_rng(dc)
    c, b = 300, 16
    v = rng.normal(0, 3, (c, dc, b)).astype(np.float32)
    synd = rng.integers(0, 2, (c, b)).astype(np.int32)
    mask = random_mask(rng, dc, c).T.copy()
    want = np.asarray(jax_check_major(
        jnp.asarray(v, _J[dtype]), jnp.asarray(synd), jnp.asarray(mask),
        block_c=128, interpret=True).astype(jnp.float32))
    n0 = check_node_update_fused.launches
    tv = torch.from_numpy(v).to(_T[dtype])
    got = check_node_update_fused(tv, torch.from_numpy(synd),
                                  torch.from_numpy(mask))
    assert check_node_update_fused.launches == n0
    assert got.dtype == _T[dtype]
    assert (got[torch.from_numpy(mask) == 0] == 0).all()
    assert_close(got.float().numpy(), want, "sumproduct", dtype)
    if dtype == "float32":
        # the slot-major kernel 4 with c2v = 0 computes the same update
        slot_major, _ = bp_check_phase_generic_ref(
            tv.transpose(0, 1), torch.zeros(dc, c, b),
            torch.from_numpy(synd), torch.from_numpy(mask).T)
        assert torch.equal(slot_major.transpose(0, 1), got)


def test_check_major_update_extreme_llrs_finite():
    v = torch.tensor([[[0.0, 1e9, -1e9, 1e-30]] * 6])          # [1, 6, 4]
    out = check_node_update_fused_ref(v, torch.zeros(1, 4, dtype=torch.int32),
                                      torch.ones(1, 6))
    assert torch.isfinite(out).all()


def test_cpu_tensors_run_the_plain_versions():
    t, c2v, synd, mask = (torch.from_numpy(a) for a in make_inputs(3, 7))
    n0 = bp_check_phase_generic.launches
    got = bp_check_phase_generic(t, c2v, synd, mask, rule="minsum")
    want = bp_check_phase_generic_ref(t, c2v, synd, mask, rule="minsum")
    assert bp_check_phase_generic.launches == n0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_generic_check_phase_rejects_bad_arguments():
    t = torch.zeros(7, C, B)
    synd = torch.zeros(C, B, dtype=torch.int32)
    mask = torch.ones(7, C)
    with pytest.raises(ValueError, match="synd"):
        bp_check_phase_generic(t, t, synd[:, :-1], mask)
    with pytest.raises(ValueError, match="c_mask"):
        bp_check_phase_generic(t, t, synd, mask.T)
    with pytest.raises(ValueError, match="rule"):
        bp_check_phase_generic(t, t, synd, mask, rule="bogus")
    with pytest.raises(TypeError, match="dtype"):
        bp_check_phase_generic(t, t.bfloat16(), synd, mask)
    with pytest.raises(ValueError, match="C, dc, B"):
        check_node_update_fused(t[0], synd, mask)


# ------------------------------------------------------ check-major rules


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_check_major_rules_match_jax(dtype):
    rng = np.random.default_rng(5)
    v = rng.normal(0, 3, (C, 6, B)).astype(np.float32)
    synd = rng.integers(0, 2, (C, B)).astype(np.int32)
    mask = random_mask(rng, 6, C).T.copy()
    jv, tv = jnp.asarray(v, _J[dtype]), torch.from_numpy(v).to(_T[dtype])
    for jfn, tfn, rule in (
            (jbp.check_node_update, tbp.check_node_update, "sumproduct"),
            (jbp.check_node_minsum, tbp.check_node_minsum, "minsum")):
        want = np.asarray(jfn(jv, jnp.asarray(synd),
                              jnp.asarray(mask)).astype(jnp.float32))
        got = tfn(tv, torch.from_numpy(synd), torch.from_numpy(mask))
        assert got.dtype == _T[dtype]
        assert_close(got.float().numpy(), want, rule, dtype)


def test_box_plus_and_var_node_update_match_jax():
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal(100), rng.standard_normal(100)
    np.testing.assert_allclose(
        tbp.box_plus(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jbp.box_plus(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        tbp.box_plus(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        2 * np.arctanh(np.tanh(a / 2) * np.tanh(b / 2)), rtol=1e-9,
        atol=1e-12)
    prior = rng.normal(size=(20, 4))
    c2v = rng.normal(size=(20, 3, 4))
    v_mask = (rng.random((20, 3)) < 0.7).astype(np.float64)
    want = jbp.var_node_update(jnp.asarray(prior), jnp.asarray(c2v),
                               jnp.asarray(v_mask))
    got = tbp.var_node_update(torch.from_numpy(prior), torch.from_numpy(c2v),
                              v_mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14)
