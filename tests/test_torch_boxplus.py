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
