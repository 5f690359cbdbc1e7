"""Port parity: ops/boxplus magnitudes, torch (CPU) against JAX (CPU).

Inputs come from a numpy seed and go to both sides as float32.  Min-sum is
compare/select/multiply only, so it is bit-exact; the sum-product forms go
through two libms (SLEEF in torch, XLA's own on the JAX side), so they are
held to rtol 1e-6, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.ops import boxplus as jbp
from qamreconciliation_tpu_torch.ops import boxplus as tbp

torch.set_num_threads(1)

EXTREMES = np.array([0.0, 1e-30, 1e-12, 0.5, 9.999, 10.0, 10.001, 30.0,
                     1e9, -1e9, -0.0, -3.0], np.float32)


def _both(fn_j, fn_t, x, **kw):
    want = np.asarray(fn_j(jnp.asarray(x, jnp.float32), **kw))
    got = fn_t(torch.from_numpy(x), **kw).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float32
    return want, got


def _slots(seed, shape=(5, 6, 64)):
    """Random magnitudes with a share of exact ties and extremes."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(0, 3, shape)).astype(np.float32)
    x[:, 1] = np.where(rng.random((shape[0], shape[2])) < 0.3, x[:, 0],
                       x[:, 1])                                  # ties
    flat = x.reshape(-1)
    pick = rng.choice(flat.size, 40, replace=False)
    flat[pick] = np.abs(rng.choice(EXTREMES, 40))
    return x


@pytest.mark.parametrize("x", [
    EXTREMES,
    np.abs(np.random.default_rng(0).normal(0, 4, 4096)).astype(np.float32),
], ids=["extremes", "random"])
def test_phi_llr_matches_jax(x):
    want, got = _both(jbp.phi_llr, tbp.phi_llr, np.abs(x))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_minsum_extrinsic_mag_bit_exact(seed):
    x = _slots(seed)
    want, got = _both(jbp.minsum_extrinsic_mag, tbp.minsum_extrinsic_mag, x,
                      axis=1)
    np.testing.assert_array_equal(got, want)
    # normalized and offset magnitudes on top
    for alpha, beta in ((jbp.MINSUM_ALPHA, 0.0), (1.0, 0.3)):
        w = np.asarray(jbp.minsum_mag(jnp.asarray(want), alpha, beta))
        g = tbp.minsum_mag(torch.from_numpy(got), alpha, beta).numpy()
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [3, 4])
def test_tanhfb_extrinsic_mag_matches_jax(seed):
    x = _slots(seed)
    want, got = _both(jbp.tanhfb_extrinsic_mag, tbp.tanhfb_extrinsic_mag, x,
                      axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_tanhfb_degree_one_saturates_like_jax():
    x = np.abs(np.random.default_rng(5).normal(0, 2, (3, 1, 8))).astype(
        np.float32)
    want, got = _both(jbp.tanhfb_extrinsic_mag, tbp.tanhfb_extrinsic_mag, x,
                      axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fb_allbutone_list_matches_jax():
    rng = np.random.default_rng(6)
    terms = [rng.random(16).astype(np.float32) for _ in range(6)]
    w_out, w_full = jbp.fb_allbutone_list([jnp.asarray(t) for t in terms])
    g_out, g_full = tbp.fb_allbutone_list([torch.from_numpy(t) for t in terms])
    for w, g in zip(w_out + [w_full], g_out + [g_full]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


SM_RULES = [
    ("update", {}), ("tanhfb", {}), ("minsum", {}),
    ("minsum", dict(alpha=1.0, beta=0.3)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule,kw", SM_RULES)
def test_slot_major_check_rules_match_jax(rule, kw, dtype):
    """check_node_{update,tanhfb,minsum}_sm on [dc, C, B] with padded
    slots (mask 0) and bf16 computed in f32: min-sum bit-exact, the
    sum-product forms within rtol/atol 1e-6 (f32) or one bf16 ulp."""
    rng = np.random.default_rng(len(rule) + len(kw))
    dc, C, B = 6, 10, 16
    v2c = rng.normal(0, 3, (dc, C, B)).astype(np.float32)
    synd = rng.integers(0, 2, (C, B)).astype(np.int32)
    mask = np.ones((dc, C), np.float32)
    mask[4:, ::3] = 0.0
    mask[5, 1::3] = 0.0
    jfn = getattr(jbp, f"check_node_{rule}_sm")
    tfn = getattr(tbp, f"check_node_{rule}_sm")
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (
        jnp.float32, torch.float32)
    want = jfn(jnp.asarray(v2c, jd), jnp.asarray(synd), mask, **kw)
    got = tfn(torch.from_numpy(v2c).to(td), torch.from_numpy(synd),
              torch.from_numpy(mask), **kw)
    assert got.dtype == td
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert np.all(got[mask == 0] == 0)
    if rule == "minsum":
        np.testing.assert_array_equal(got, want)
    elif dtype == "bfloat16":
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
