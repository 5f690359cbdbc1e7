"""Port parity: the direct-mode LLR functions (ops/llr.py) against JAX's.

Inputs: numpy-seeded PAM samples for bps 1-4, at a low and a high SNR, with
``2 * sigma**2`` formed in the dtype as the engines form it.

Tolerances:
* float32: |port - JAX| <= 4 f32 ulp of |JAX| + 1e-6 (XLA's and torch's exp
  and log differ by an ulp; the LLR is a difference of two logs);
* bfloat16: |port - JAX| <= 2 bf16 ulp of |JAX| (the two libraries may
  round a fused bf16 chain differently; on the CPU they measured equal).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qamreconciliation_tpu.ops import llr as jllr
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.bicm import gray_bit_masks
from qamreconciliation_tpu_torch.ops import llr as tllr

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def samples(bps, snr_db, seed, S=48, B=16):
    pa = PAMAlphabet(bps, 2.0)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, pa.order, (S, B))
    sigma = np.sqrt(pa.variance * 10 ** (-snr_db / 10) / 2)
    y = (pa.constellation[x] + sigma * rng.normal(size=x.shape))
    return pa, y.astype(np.float32), sigma


def two_var(sigma, jd, td):
    return (2.0 * jnp.asarray(sigma, jd) ** 2,
            2.0 * torch.tensor(sigma, dtype=td) ** 2)


def assert_llrs_close(got, want, name):
    got = got.double().numpy()
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape
    if name == "float32":
        tol = 4 * np.spacing(np.abs(want).astype(np.float32)) + 1e-6
    else:
        mag = np.maximum(np.abs(want), 2.0 ** -126)
        tol = 2 * 2.0 ** (np.floor(np.log2(mag)) - 7)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("snr_db", [3.0, 12.0])
@pytest.mark.parametrize("bps", [1, 2, 3, 4])
def test_gray_bits_llrs_equal_jax(bps, snr_db, name):
    jd, td = DTYPES[name]
    pa, y, sigma = samples(bps, snr_db, seed=10 * bps + int(snr_db))
    tv_j, tv_t = two_var(sigma, jd, td)
    want = jllr.y_to_lappr_gray_bits(jnp.asarray(y), pa.constellation, tv_j,
                                     jd)
    got = tllr.y_to_lappr_gray_bits(torch.from_numpy(y), pa.constellation,
                                    tv_t, td)
    assert got.dtype == td and got.shape == (bps, *y.shape)
    assert_llrs_close(got, want, name)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("bps", [1, 2, 3, 4])
def test_logsumexp_llrs_equal_jax(bps, name):
    jd, td = DTYPES[name]
    pa, y, sigma = samples(bps, 4.0, seed=bps)
    y_bs = np.ascontiguousarray(y.T)                      # [B, S]
    tv_j, tv_t = two_var(sigma, jd, td)
    want = jllr.y_to_lappr_gray(jnp.asarray(y_bs), pa.constellation, tv_j,
                                jd)
    got = tllr.y_to_lappr_gray(torch.from_numpy(y_bs), pa.constellation,
                               tv_t, td)
    assert got.dtype == td and got.shape == (y_bs.shape[0],
                                             y_bs.shape[1] * bps)
    assert_llrs_close(got, want, name)


@pytest.mark.parametrize("bps", [1, 2, 4])
def test_both_forms_agree_in_float64(bps):
    """The per-bit form is the logsumexp form's math: per-symbol
    interleave of [bps, S, B] equals [B, S*bps] to f64 round-off."""
    pa, y, sigma = samples(bps, 5.0, seed=7)
    y = y.astype(np.float64)
    tv = 2.0 * sigma ** 2
    ref = tllr.y_to_lappr_gray(torch.from_numpy(y.T.copy()),
                               pa.constellation, tv, torch.float64)
    new = tllr.y_to_lappr_gray_bits(torch.from_numpy(y), pa.constellation,
                                    tv, torch.float64)
    new_bn = new.permute(2, 1, 0).reshape(y.shape[1], -1)
    torch.testing.assert_close(new_bn, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", DTYPES)
def test_gray_bits_llrs_finite_at_very_high_snr(name):
    """A far tail sample underflows a whole Gray group against the shared
    max: the LLR saturates finite (never +-inf or NaN), keeps the exact
    form's sign, equals JAX's saturated value, and agrees with the exact
    form where that one is moderate."""
    jd, td = DTYPES[name]
    pa = PAMAlphabet(4, 2)
    y = np.array([[1.6], [14.9], [-15.2], [0.05]], np.float32)
    tv_j, tv_t = jnp.asarray(0.02, jd), torch.tensor(0.02, dtype=td)
    got = tllr.y_to_lappr_gray_bits(torch.from_numpy(y), pa.constellation,
                                    tv_t, td)
    assert bool(torch.isfinite(got).all()), got
    want = jllr.y_to_lappr_gray_bits(jnp.asarray(y), pa.constellation, tv_j,
                                     jd)
    assert_llrs_close(got, want, name)
    ref = tllr.y_to_lappr_gray(torch.from_numpy(y.T.copy()),
                               pa.constellation, 0.02, torch.float64).numpy()
    new_bn = got.double().permute(2, 1, 0).reshape(1, -1).numpy()
    saturated = np.abs(ref) >= 80.0
    assert saturated.any()
    assert (np.sign(new_bn[saturated]) == np.sign(ref[saturated])).all()
    if name == "float32":
        np.testing.assert_allclose(new_bn[~saturated], ref[~saturated],
                                   rtol=1e-4, atol=1e-3)


def test_gray_bit_masks_equal_jax():
    from qamreconciliation_tpu.models.bicm import gray_bit_masks as jmasks

    for bps in range(1, 7):
        np.testing.assert_array_equal(gray_bit_masks(bps), jmasks(bps))
