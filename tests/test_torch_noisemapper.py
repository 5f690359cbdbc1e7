"""Port parity: the softening layer on shared samples.

For bps 2 and 4 and the Base and Alternating sign configurations, the
port's ``NoiseMapper`` (torch, CPU, float32) against the JAX one on the same
numpy-seeded ``(x, y)``: ``hard_decide_index`` is exact, ``map_noise``
within 1e-6, and the poly/table softening LLRs within 1e-4.

Under the tests' x64 mode the JAX ``F_Y`` promotes to float64, while the
port's stays in float32 as on the card; the metric divides F's rounding
(up to 4 ulp at F ~ 1) by the interval mass, so where that bound exceeds
1e-6 (the narrow intervals of bps 4) it is the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models.alphabet import PAMAlphabet as JPAM
from qamreconciliation_tpu.models.noisemapper import NoiseMapper as JNM
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper

torch.set_num_threads(1)

CASES = [(2, 3.5), (4, 12.0)]       # (bps, Es/N0 dB)


def sign_config(order, name):
    cfg = np.zeros(order, np.uint8)
    if name == "alternating":
        cfg[1::2] = 1
    return cfg


def setup(bps, snr_dB, cfg_name, seed=0, S=512, B=4):
    pa = PAMAlphabet(bps, 2.0)
    N0 = pa.variance * 10 ** (-snr_dB / 10) / 2
    cfg = sign_config(pa.order, cfg_name)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, pa.order, (S, B)).astype(np.int32)
    y = (pa.constellation[x] + np.sqrt(N0) * rng.normal(size=(S, B))) \
        .astype(np.float32)
    jnm = JNM(JPAM(bps, 2.0), N0, cfg, dtype=jnp.float32)
    tnm = NoiseMapper(pa, N0, cfg, dtype=torch.float32, device="cpu")
    return jnm, tnm, x, y


@pytest.mark.parametrize("cfg_name", ["base", "alternating"])
@pytest.mark.parametrize("bps,snr", CASES)
def test_hard_decision_and_softening_metric(bps, snr, cfg_name):
    jnm, tnm, x, y = setup(bps, snr, cfg_name)
    jidx = np.asarray(jnm.hard_decide_index(jnp.asarray(y)))
    tidx = tnm.hard_decide_index(torch.from_numpy(y))
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    jn = np.asarray(jnm.map_noise(jnp.asarray(y), jnp.asarray(jidx)))
    tn = tnm.map_noise(torch.from_numpy(y), tidx)
    assert tn.dtype == torch.float32
    atol = max(1e-6, 4 * 2.0 ** -24 / tnm.np_tables["delta_F_Y"].min())
    np.testing.assert_allclose(tn.numpy(), jn, rtol=0, atol=atol)


@pytest.mark.parametrize("mode", ["poly", "table"])
@pytest.mark.parametrize("cfg_name", ["base", "alternating"])
@pytest.mark.parametrize("bps,snr", CASES)
def test_softening_llrs(bps, snr, cfg_name, mode):
    jnm, tnm, x, y = setup(bps, snr, cfg_name, seed=1)
    jidx = jnm.hard_decide_index(jnp.asarray(y))
    n = np.asarray(jnm.map_noise(jnp.asarray(y), jidx), np.float32)
    fn_j = jnm._poly_llr_bits if mode == "poly" else jnm._table_llr_bits
    fn_t = tnm._poly_llr_bits if mode == "poly" else tnm._table_llr_bits
    want = fn_j(jnp.asarray(n), jnp.asarray(x))
    got = fn_t(torch.from_numpy(n), torch.from_numpy(x))
    assert len(got) == len(want) == bps
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_random_symbols_shape_and_law():
    pa = PAMAlphabet(2, 2.0, probabilities=[0.1, 0.4, 0.4, 0.1])
    g = torch.Generator().manual_seed(3)
    x = pa.random_symbols(g, (4000, 8), "cpu")
    assert x.dtype == torch.int32 and tuple(x.shape) == (4000, 8)
    freq = np.bincount(x.numpy().reshape(-1), minlength=4) / x.numel()
    # 32000 draws: 4 standard errors of the largest cell is ~0.011
    np.testing.assert_allclose(freq, pa.probabilities, atol=0.011)
    v = pa.index_to_value(x, torch.float32)
    np.testing.assert_array_equal(v.numpy(), pa.constellation[x.numpy()]
                                  .astype(np.float32))


def test_host_tables_match_jax():
    pa = PAMAlphabet(4, 2.0)
    N0 = pa.variance * 10 ** (-12 / 10) / 2
    cfg = sign_config(16, "alternating")
    jt = JNM(JPAM(4, 2.0), N0, cfg, dtype=jnp.float32).np_tables
    tt = NoiseMapper(pa, N0, cfg, device="cpu").np_tables
    assert jt.keys() == tt.keys()
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k])


@pytest.mark.parametrize("bps,snr", CASES)
def test_bf16_softening_matches_jax_without_x64(bps, snr):
    """bf16 samples: the JAX ``F_Y`` promotes to float32 (its float64 numpy
    scalar, with x64 off as on an accelerator), so the metric is float32 and
    the bf16 poly LLRs are rounded once.  The port mirrors that: the metric
    within the float32 tolerance above and, at bps 2, the bf16 LLRs
    bit-equal (at bps 4 the metric's tolerance can move an LLR by one bf16
    ulp)."""
    import jax

    pa = PAMAlphabet(bps, 2.0)
    N0 = pa.variance * 10 ** (-snr / 10) / 2
    cfg = sign_config(pa.order, "alternating")
    rng = np.random.default_rng(9)
    x = rng.integers(0, pa.order, (512, 4)).astype(np.int32)
    y = (pa.constellation[x] + np.sqrt(N0) * rng.normal(size=x.shape)) \
        .astype(np.float32)
    tnm = NoiseMapper(pa, N0, cfg, dtype=torch.bfloat16, device="cpu")
    tnm._ensure_llr_poly()
    ty = torch.from_numpy(y).to(torch.bfloat16)
    tn = tnm.map_noise(ty, tnm.hard_decide_index(ty))
    tl = tnm._poly_llr_bits(tn, torch.from_numpy(x))
    with jax.enable_x64(False):
        jnm = JNM(JPAM(bps, 2.0), N0, cfg, dtype=jnp.bfloat16)
        jy = jnp.asarray(y, jnp.bfloat16)
        jn = jnm.map_noise(jy, jnm.hard_decide_index(jy))
        jl = jnm._poly_llr_bits(jn, jnp.asarray(x))
        jn = np.asarray(jn)
        jl = [np.asarray(b.astype(jnp.float32)) for b in jl]
    assert tn.dtype == torch.float32 and jn.dtype == np.float32
    atol = max(1e-6, 4 * 2.0 ** -24 / tnm.np_tables["delta_F_Y"].min())
    np.testing.assert_allclose(tn.numpy(), jn, rtol=0, atol=atol)
    for got, want in zip(tl, jl):
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        if bps == 2:
            np.testing.assert_array_equal(got, want)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                          - 7)
            assert np.all(np.abs(got - want) <= ulp)
