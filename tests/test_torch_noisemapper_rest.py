"""Port parity: the rest of ``NoiseMapper`` against the JAX package's.

The same numpy-seeded inputs go through both, float64 with x64 on and
float32/bfloat16 with x64 off (the JAX package's dtype rules as they run on
an accelerator).  Tolerances, each stated where it is used:

* ``np_tables``, the device tables and every fit coefficient: identical.
* The CDF forms (``fy_mode`` erf, erf_flat, poly): within 4 ulp of 1, i.e.
  ``4 eps`` absolute (the mixture adds ``1 + erf``, so its rounding is
  absolute, not relative to a small F); the softening metric within that
  divided by the smallest interval mass.
* ``g_inv``/``g_inv_poly``: within 4 ulp at the inverse's scale, ``4 eps
  max|y|`` (the Clenshaw sums round at the scale of their partial sums).
* ``g_inv_search``: within 1e-9 in float64 and ``8 eps |y| + 1e-6`` in
  float32, where the inverse is determined to that: the Newton root is only
  fixed to the CDF's rounding over the density, so the float32 bound is
  ``8 eps |y| + max(1e-6, 4 eps / f_Y(y))`` (2 ulp at the inner points of
  16-PAM at 12 dB); in bf16 both raise TypeError (the JAX package's Newton
  carry would change dtype from bf16 to float32 inside its
  ``fori_loop``).
* LLRs of every ``demap_lappr*`` mode: within ``rtol 1e-9 + atol 1e-9`` in
  float64, ``16 ulp + 1e-5`` in float32, one bf16 ulp in bf16, with equal
  NaN masks; "Formulation 3" (``demap_lappr_sofisticated``), whose LLRs are
  NaN in exact arithmetic, is held through its group sums instead (its
  test says how).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models import noisemapper as jm
from qamreconciliation_tpu.models.alphabet import PAMAlphabet as JPAM
from qamreconciliation_tpu_torch.models import noisemapper as tm
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet

torch.set_num_threads(1)

CASES = [(2, 3.5), (4, 12.0)]               # (bps, Es/N0 dB)
DTYPES = ["float64", "float32", "bfloat16"]
EPS = {"float64": 2.0 ** -52, "float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}


def x64(dt):
    """float64 runs with x64 on, float32/bf16 with it off."""
    return jax.enable_x64(dt == "float64")


def sign_config(order, name):
    cfg = np.zeros(order, np.uint8)
    if name == "alternating":
        cfg[1::2] = 1
    return cfg


@functools.lru_cache(maxsize=None)
def mappers(bps, snr, dt, cfg="alternating", cls="NoiseMapper",
            fy_mode="erf"):
    """(JAX mapper, port mapper), built once per module; call inside
    ``x64(dt)``."""
    pa = PAMAlphabet(bps, 2.0)
    N0 = pa.variance * 10 ** (-snr / 10) / 2
    c = sign_config(pa.order, cfg)
    J = getattr(jm, cls)(JPAM(bps, 2.0), N0, c, dtype=jnp.dtype(dt),
                         fy_mode=fy_mode)
    T = getattr(tm, cls)(pa, N0, c, dtype=dt, device="cpu", fy_mode=fy_mode)
    return J, T


def inputs(J, seed=0, S=256):
    """Received samples y, softening metrics n in (0, 1) and symbols j,
    each as (JAX array, port tensor) with the same values in the dtype."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, J.order, S)
    y = J.constellation[x] + J.noise_sigma * rng.normal(size=S)
    n = rng.uniform(1e-3, 1 - 1e-3, S)
    j = rng.integers(0, J.order, S)

    def both(a):
        ja = jnp.asarray(a, J.dtype)
        t = torch.from_numpy(np.asarray(ja).astype(np.float64))
        return ja, t.to(getattr(torch, J.dtype.name))

    return both(y), both(n), (jnp.asarray(j), torch.from_numpy(j))


def host(a):
    """float64 numpy of a JAX array or a tensor."""
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(a).astype(np.float64)


def same_dtype(ja, t):
    assert str(t.dtype).removeprefix("torch.") == np.dtype(ja.dtype).name


def ulp(want, dt):
    """One ulp of ``want`` in ``dt`` (of the smallest normal at 0)."""
    e = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    return 2.0 ** (e + np.log2(EPS[dt]))


def assert_llrs(got, want, dt):
    """The LLR tolerance of the module docstring, NaN masks equal and the
    infinite LLRs (a group sum of 0) equal."""
    g, w = host(got), host(want)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(g[np.isinf(w)], w[np.isinf(w)])
    ok = np.isfinite(w)
    g, w = g[ok], w[ok]
    if dt == "float64":
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)
    elif dt == "float32":
        assert np.all(np.abs(g - w) <= 16 * ulp(w, dt) + 1e-5)
    else:
        assert np.all(np.abs(g - w) <= ulp(w, dt))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("bps,snr", CASES)
def test_tables_and_fits_are_identical(bps, snr, dt):
    with x64(dt):
        J, T = mappers(bps, snr, dt)
        for m in (J, T):
            m._ensure_fy_poly()
            m._ensure_ginv_poly()
        assert J.np_tables.keys() == T.np_tables.keys()
        for k in J.np_tables:
            np.testing.assert_array_equal(T.np_tables[k], J.np_tables[k])
        for prop in ("y_range", "F_Y_values", "F_Y_thresholds", "delta_F_Y",
                     "fwrd_transition_probability",
                     "back_transition_probability", "bare_llr_table",
                     "inf_erf_table", "constellation", "thresholds",
                     "probabilities"):
            np.testing.assert_array_equal(getattr(T, prop), getattr(J, prop))
        for k in ("_F_thr", "_delta_F_Y", "_fwd", "_back", "_bare_llr",
                  "_inf_erf", "_c", "_thr_interior", "_p", "_log_p",
                  "_bits_mask", "_y_of_u", "_sigma_dev", "_noise_var_dev",
                  "_fy_poly", "_fy_dom", "_ginv_poly"):
            same_dtype(getattr(J, k), getattr(T, k))
            np.testing.assert_array_equal(host(getattr(T, k)),
                                          host(getattr(J, k)), err_msg=k)
        np.testing.assert_array_equal(T._sign_cfg.numpy(),
                                      np.asarray(J._sign_cfg))
        assert T._fy_poly_fit_err == J._fy_poly_fit_err
        assert T._ginv_poly_fit_err == J._ginv_poly_fit_err
        assert (T._c_tuple, T._p_tuple, T._thr_tuple) == (
            J._c_tuple, J._p_tuple, J._thr_tuple)


@pytest.mark.parametrize("fy_mode", ["erf", "erf_flat", "poly"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("bps,snr", CASES)
def test_cdf_forms_and_softening_metric(bps, snr, dt, fy_mode):
    """F_Y within 4 eps absolute; ``map_noise`` within that over the
    smallest interval mass; the output dtypes as JAX's (bf16 "erf" is
    float32, the other two forms bf16)."""
    with x64(dt):
        J, T = mappers(bps, snr, dt, fy_mode=fy_mode)
        (jy, ty), _, _ = inputs(J)
        want, got = J.F_Y(jy), T.F_Y(ty)
        same_dtype(want, got)
        out_dt = np.dtype(want.dtype).name
        assert np.all(np.abs(host(got) - host(want)) <= 4 * EPS[out_dt])
        np.testing.assert_array_equal(host(T.single_F_Y(ty)), host(got))
        jidx = J.hard_decide_index(jy)
        tidx = T.hard_decide_index(ty)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        wn, gn = J.map_noise(jy, jidx), T.map_noise(ty, tidx)
        same_dtype(wn, gn)
        tol = 4 * EPS[np.dtype(wn.dtype).name] / T.delta_F_Y.min()
        assert np.all(np.abs(host(gn) - host(wn)) <= tol)


@pytest.mark.parametrize("name", ["g_inv", "g_inv_poly"])
@pytest.mark.parametrize("cfg", ["base", "alternating"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("bps,snr", CASES)
def test_inverse_softening(bps, snr, dt, cfg, name):
    """Within 4 eps max|y|; ``demap_noise`` is ``g_inv``."""
    with x64(dt):
        J, T = mappers(bps, snr, dt, cfg=cfg)
        _, (jn, tn), (jj, tj) = inputs(J, seed=1)
        want = getattr(J, name)(jn, jj)
        got = getattr(T, name)(tn, tj)
        same_dtype(want, got)
        w = host(want)
        assert np.all(np.abs(host(got) - w) <= 4 * EPS[dt] * np.abs(w).max())
        if name == "g_inv":
            np.testing.assert_array_equal(host(T.demap_noise(tn, tj)),
                                          host(got))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("bps,snr", CASES)
def test_g_inv_search(bps, snr, dt):
    """Within 1e-9 (float64), 8 eps |y| + max(1e-6, 4 eps / f_Y(y))
    (float32, f_Y the mixture density); TypeError in bf16 from both, as the
    Newton carry would change dtype."""
    with x64(dt):
        J, T = mappers(bps, snr, dt)
        _, (jn, tn), (jj, tj) = inputs(J, seed=2)
        if dt == "bfloat16":
            with pytest.raises(TypeError):
                J.g_inv_search(jn, jj)
            with pytest.raises(TypeError):
                T.g_inv_search(tn, tj)
            return
        want, got = J.g_inv_search(jn, jj), T.g_inv_search(tn, tj)
        same_dtype(want, got)
        w, g = host(want), host(got)
        if dt == "float64":
            tol = 1e-9
        else:
            c, p, s = J.constellation, J.probabilities, J.noise_sigma
            pdf = np.sum(p * np.exp(-0.5 * ((w[:, None] - c) / s) ** 2)
                         / (s * np.sqrt(2 * np.pi)), axis=-1)
            tol = 8 * EPS[dt] * np.abs(w) + np.maximum(1e-6,
                                                       4 * EPS[dt] / pdf)
        assert np.all(np.abs(g - w) <= tol)
        np.testing.assert_array_equal(host(T.demap_noise_search(tn, tj)), g)
        # Newton moved off the interpolated start
        assert not np.array_equal(g, host(T.g_inv(tn, tj)))


@pytest.mark.parametrize("ref_compat", [False, True])
@pytest.mark.parametrize("mode", ["poly", "table", "interp", "search"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("bps,snr", CASES)
def test_demap_lappr_array(bps, snr, dt, mode, ref_compat):
    """Every mode (ref_compat takes "interp" for "poly"/"table"), the LLR
    tolerance of the module docstring; the layout [..., S*bps] with a
    leading axis kept; ``demap_lappr`` is one sample of it."""
    with x64(dt):
        J, T = mappers(bps, snr, dt)
        _, (jn, tn), (jj, tj) = inputs(J, seed=3, S=128)
        if mode == "search" and dt == "bfloat16":
            with pytest.raises(TypeError):
                J.demap_lappr_array(jn, jj, mode=mode,
                      ref_compat=ref_compat)
            with pytest.raises(TypeError):
                T.demap_lappr_array(tn, tj, mode, ref_compat)
            return
        want = J.demap_lappr_array(jn.reshape(2, -1),
                     jj.reshape(2, -1), mode=mode, ref_compat=ref_compat)
        got = T.demap_lappr_array(tn.reshape(2, -1), tj.reshape(2, -1),
                                  mode, ref_compat)
        assert tuple(got.shape) == tuple(want.shape) == (2, 64 * bps)
        same_dtype(want, got)
        assert_llrs(got, want, dt)
        one = T.demap_lappr(tn[5], tj[5], mode, ref_compat)
        np.testing.assert_array_equal(host(one),
                                      host(got[0, 5 * bps:6 * bps]))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("bps,snr", CASES)
def test_demap_lappr_simplified(bps, snr, dt):
    with x64(dt):
        J, T = mappers(bps, snr, dt)
        _, (jn, tn), (jj, tj) = inputs(J, seed=4)
        want = J.demap_lappr_simplified_array(jn, jj)
        got = T.demap_lappr_simplified_array(tn, tj)
        same_dtype(want, got)
        assert_llrs(got, want, dt)
        np.testing.assert_array_equal(
            host(T.demap_lappr_simplified(tn[3], tj[3])),
            host(got[3 * bps:4 * bps]))


def formulation3_sums(T, n, j, ref_compat):
    """"Formulation 3"'s Gray-group sums in float64 numpy from the port's
    host tables and its own y_hat (``g_inv``, held to JAX's above), with the
    scale each sum is rounded at: ``(N, D, size_N, size_D)``, each
    [S, bps].  ``size`` sums ``beta_m sum|dFZ| + |dFZ_m| B`` with each
    ``|dFZ|`` taken before its cancelling difference, ``(|erf| +
    |inf_erf|) / 2``: a sum computed in a dtype of epsilon ``eps`` lies
    within a few ``eps size`` of the exact one."""
    from scipy.special import erf

    t = T.np_tables
    c, p, dF = t["constellation"], t["probabilities"], t["delta_F_Y"]
    M = c.size
    if ref_compat:
        y_hat = T.g_inv(n, j)[:, None].expand(-1, M)
    else:
        y_hat = T._y_hat_all_candidates(n, "interp")
    y_hat, j = host(y_hat), j.numpy()
    cj = c[j][:, None, None]
    expo = (2.0 * y_hat[..., None] - c - cj) * (c - cj) / (2.0 * T.noise_var)
    beta = dF / np.sum(p * np.exp(expo), axis=-1)
    B = beta.sum(-1, keepdims=True)
    e = erf((y_hat - c[j][:, None]) / np.sqrt(2.0 * T.noise_var))
    inf_erf = t["inf_erf_table"].T[j]
    dFZ = 0.5 * (e - inf_erf)
    A = beta * dFZ.sum(-1, keepdims=True) - dFZ * B
    s_dFZ = 0.5 * (np.abs(e) + np.abs(inf_erf))
    size = beta * s_dFZ.sum(-1, keepdims=True) + s_dFZ * B
    bits = T._bits_mask.double().numpy()
    return A @ (1.0 - bits), A @ bits, size @ (1.0 - bits), size @ bits


@pytest.mark.parametrize("ref_compat", [False, True])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("bps,snr", CASES)
def test_demap_lappr_sofisticated(bps, snr, dt, ref_compat):
    """The formulation's two Gray-group sums N_k, D_k add to 0 (sum_m A_m =
    Sz B - Sz B), so in exact arithmetic one is negative and every LLR
    ``log N_k - log D_k`` is NaN; a finite LLR only comes out where both
    sums are rounding noise, and no tolerance applies to it.  So:

    * the port's group sums, every entry in every dtype, lie within ``4 eps
      size`` of a float64 evaluation of the formula on the port's y_hat
      (``formulation3_sums``; at most ``1 eps size`` seen);
    * where that bound decides a sum's sign with room to spare (``4 eps
      size / |sum| < 1e-2``), the LLR is NaN in both packages;
    * in float64 and float32 at least half the LLRs are so decided, for
      both ``ref_compat`` (0.69-1.0 seen at these seeds); in bf16 (eps
      2^-7) none is, at either bps, since a sum with ``4 eps size / |sum|
      < 1e-2`` would need ``|sum| > 3 size``: there the sums alone are
      compared."""
    with x64(dt):
        J, T = mappers(bps, snr, dt)
        _, (jn, tn), (jj, tj) = inputs(J, seed=5)
        want = J.demap_lappr_sofisticated_array(jn, jj,
                     ref_compat=ref_compat)
        got = T.demap_lappr_sofisticated_array(tn, tj, ref_compat)
        same_dtype(want, got)
        g, w = host(got), host(want)
        assert g.shape == w.shape == (256 * bps,)
        N, D, sN, sD = formulation3_sums(T, tn, tj, ref_compat)
        tN, tD = T._formulation3_sums(tn, tj, ref_compat)
        assert np.all(np.abs(host(tN) - N) <= 4 * EPS[dt] * sN)
        assert np.all(np.abs(host(tD) - D) <= 4 * EPS[dt] * sD)
        with np.errstate(divide="ignore", invalid="ignore"):
            kappa = np.maximum(sN / np.abs(N), sD / np.abs(D)).reshape(-1)
        det = 4 * EPS[dt] * kappa < 1e-2
        if dt == "bfloat16":
            assert not det.any()
        else:
            assert det.mean() >= 0.5
        assert np.isnan(g[det]).all() and np.isnan(w[det]).all()
        np.testing.assert_array_equal(
            host(T.demap_lappr_sofisticated(tn[7], tj[7], ref_compat)),
            g[7 * bps:8 * bps])


@pytest.mark.parametrize("cls", ["NoiseMapperFlipSign",
                                 "NoiseMapperAntiFlipSign", "NoiseDemapper"])
@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("bps,snr", CASES)
def test_sign_variants(bps, snr, dt, cls):
    """The subclasses' fixed directions: g, g_inv and the LLRs (their own
    directions in "interp"/"poly", ``sign_config`` in "search") as JAX's."""
    with x64(dt):
        J, T = mappers(bps, snr, dt, cls=cls)
        assert isinstance(T, tm.NoiseMapper)
        np.testing.assert_array_equal(T._g_signs().numpy(),
                                      np.asarray(J._g_signs()))
        (jy, ty), (jn, tn), (jj, tj) = inputs(J, seed=6, S=128)
        jidx, tidx = J.hard_decide_index(jy), T.hard_decide_index(ty)
        tol = 4 * EPS[dt] / T.delta_F_Y.min()
        assert np.all(np.abs(host(T.map_noise(ty, tidx))
                             - host(J.map_noise(jy, jidx))) <= tol)
        w = host(J.g_inv(jn, jj))
        assert np.all(np.abs(host(T.g_inv(tn, tj)) - w)
                      <= 4 * EPS[dt] * np.abs(w).max())
        for mode in ("interp", "search", "poly"):
            assert_llrs(T.demap_lappr_array(tn, tj, mode),
                        J.demap_lappr_array(jn, jj, mode=mode), dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_with_sign_config(dt):
    """The clone shares every table and the sign-independent fits, builds
    its own LLR fit, and computes what a mapper built with that
    configuration computes (and JAX's clone); the original is unchanged."""
    bps, snr = 4, 12.0
    with x64(dt):
        J, T = mappers(bps, snr, dt, cfg="base")
        for m in (J, T):
            m._ensure_llr_poly()
            m._ensure_ginv_poly()
            m._ensure_fy_poly()
        cfg = sign_config(16, "alternating")
        tc, jc = T.with_sign_config(cfg), J.with_sign_config(cfg)
        for k in ("_F_thr", "_delta_F_Y", "_y_of_u", "_c", "_bits_mask",
                  "_ginv_poly", "_fy_poly", "_fy_dom"):
            assert getattr(tc, k) is getattr(T, k), k
        assert tc._llr_poly is None and tc._llr_tab is None
        assert T._llr_poly is not None
        np.testing.assert_array_equal(tc.sign_config, cfg)
        np.testing.assert_array_equal(T.sign_config, np.zeros(16))
        _, fresh = mappers(bps, snr, dt, cfg="alternating")
        _, (jn, tn), (jj, tj) = inputs(J, seed=7, S=128)
        for mode in ("poly", "interp"):
            got = tc.demap_lappr_array(tn, tj, mode)
            np.testing.assert_array_equal(
                host(got), host(fresh.demap_lappr_array(tn, tj, mode)))
            assert_llrs(got, jc.demap_lappr_array(jn, jj, mode=mode),
                        dt)
        assert not np.array_equal(host(T.g_inv(tn, tj)),
                                  host(tc.g_inv(tn, tj)))
        with pytest.raises(ValueError):
            T.with_sign_config([0, 1])


def test_constructor_validation_and_index_to_val():
    pa = PAMAlphabet(2, 2.0)
    with pytest.raises(ValueError, match="fy_mode"):
        tm.NoiseMapper(pa, 0.5, device="cpu", fy_mode="bogus")
    with pytest.raises(ValueError):
        tm.NoiseMapper(pa, 0.0, device="cpu")
    T = tm.NoiseMapper(pa, 0.5, device="cpu")
    np.testing.assert_array_equal(
        T.index_to_val(torch.tensor([0, 3, 1])).numpy(),
        pa.constellation[[0, 3, 1]].astype(np.float32))
