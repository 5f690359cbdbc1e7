"""Port parity: the mutual-information estimators and their CLIs.

* The cases of ``tests/test_mi.py`` on the port (analytic invariants; the
  Monte-Carlo estimators against the analytic values with the reference's
  sign conventions: the first two MC estimators are the negatives of the
  information, I(X,N;Xhat) comes out positive).
* The host estimators (copied numpy/scipy) against the JAX ones, rtol
  1e-10.
* ``_mc_info_impl`` against the JAX one (jitted) on identical samples (the JAX key's
  symbols and normals fed through the port's ``xy=`` seam): float64 within
  rtol 1e-12, float32 (JAX with x64 off) within rtol 1e-5 + atol 1e-6.
  The two sides sum their N terms in different orders.
* ``montecarlo_information_batched`` equal to the per-mapper calls on the
  same samples, the mismatched-mapper ValueError.
* The three CLIs against the JAX CLIs on a 3-point grid: host columns
  within rtol 1e-10, MC columns within 4 standard errors of the difference
  of two independent estimates.
"""

import csv
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu import NoiseMapper as JNM
from qamreconciliation_tpu import PAMAlphabet as JPAM
from qamreconciliation_tpu.models import mutual_information as jmi
from qamreconciliation_tpu_torch.models import mutual_information as mi
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
from qamreconciliation_tpu_torch.sims.sim_mutual_information_compare_signs \
    import enumerate_configs
from qamreconciliation_tpu_torch.utils.checkpoint import SweepState

torch.set_num_threads(1)


def noise_var(pa, snr):
    return pa.variance * 10 ** (-snr / 10) / 2


@pytest.fixture(scope="module")
def setup():
    pa = PAMAlphabet(2, 2.0)
    nm = NoiseMapper(pa, noise_var(pa, 5.0), dtype=torch.float64,
                     device="cpu")
    return pa, nm, mi.P_xhat(nm)


def test_p_xhat_is_distribution(setup):
    pa, nm, p_Xhat = setup
    np.testing.assert_allclose(p_Xhat.sum(), 1.0, rtol=1e-12)
    assert (p_Xhat > 0).all()


def test_analytic_ordering(setup):
    """Softening shares more than the hard decision but no more than Y:
    I(X;Xhat) <= I(X,N;Xhat) <= I(X;Y) <= log2 M."""
    pa, nm, p_Xhat = setup
    i_xxh = mi.mutual_information_X_Xhat(nm, p_Xhat)
    i_base = mi.mutual_information_base_scheme(nm, p_Xhat)
    i_xy = mi.mutual_information_X_Y(nm)
    assert 0.0 < i_xxh <= i_base + 1e-9
    assert i_base <= i_xy + 1e-6
    assert i_xy <= pa.bit_per_symbol


def test_montecarlo_matches_analytic(setup):
    pa, nm, p_Xhat = setup
    i_xxh = mi.mutual_information_X_Xhat(nm, p_Xhat)
    i_base = mi.mutual_information_base_scheme(nm, p_Xhat)
    i_xy = mi.mutual_information_X_Y(nm)
    gen = torch.Generator().manual_seed(0)
    acc = np.zeros(3)
    iters = 8
    for _ in range(iters):
        acc += np.asarray(mi.montecarlo_information(gen, pa, nm, p_Xhat,
                                                    1 << 13))
    acc /= iters
    # reference sign conventions: the first two estimators are negated
    np.testing.assert_allclose(acc[0], -i_xxh, atol=0.02)
    np.testing.assert_allclose(acc[1], -i_xy, atol=0.02)
    np.testing.assert_allclose(acc[2], i_base, atol=0.02)


def test_which_mask(setup):
    pa, nm, p_Xhat = setup
    res = mi.montecarlo_information(torch.Generator().manual_seed(1), pa,
                                    nm, p_Xhat, 256,
                                    which=(False, True, False))
    assert res[0] == 0.0 and res[2] == 0.0 and res[1] != 0.0


def test_high_snr_limits():
    pa = PAMAlphabet(2, 2.0)
    nm = NoiseMapper(pa, pa.variance * 1e-3, dtype=torch.float64,
                     device="cpu")
    p_Xhat = mi.P_xhat(nm)
    # noiseless limit: all MIs -> H(X) = 2 bits
    assert mi.mutual_information_X_Xhat(nm, p_Xhat) > 1.99
    assert mi.mutual_information_X_Y(nm) > 1.99


def mapper_pair(bps, snr, dtype="float64", signs=None, probs=None):
    jpa, tpa = JPAM(bps, 2.0, probs), PAMAlphabet(bps, 2.0, probs)
    N0 = noise_var(jpa, snr)
    return (jpa, JNM(jpa, N0, signs, dtype=jnp.dtype(dtype)),
            tpa, NoiseMapper(tpa, N0, signs, dtype=dtype, device="cpu"))


HOST_CASES = [(1, 2.0, None, None), (2, 5.0, [0, 1, 0, 1], None),
              (2, 12.0, None, [0.1, 0.4, 0.4, 0.1]),
              (3, 9.0, [1, 0, 0, 1, 1, 0, 1, 0], None)]


@pytest.mark.parametrize("bps,snr,signs,probs", HOST_CASES)
def test_host_estimators_match_jax(bps, snr, signs, probs):
    _, jnm, _, tnm = mapper_pair(bps, snr, signs=signs, probs=probs)
    p = mi.P_xhat(tnm)
    np.testing.assert_allclose(p, jmi.P_xhat(jnm), rtol=1e-10)
    for n in (0.0, 0.13, 0.5, 0.97, 1.0):
        np.testing.assert_allclose(
            mi.mutual_information_base_scheme_arg(n, tnm, p),
            jmi.mutual_information_base_scheme_arg(n, jnm, p),
            rtol=1e-10, atol=1e-14)
    for y in (-7.0, -0.3, 0.0, 2.2, 40.0):
        np.testing.assert_allclose(
            mi.mutual_information_X_Y_int_arg(y, tnm),
            jmi.mutual_information_X_Y_int_arg(y, jnm),
            rtol=1e-10, atol=1e-14)
    for fn in (mi.mutual_information_X_Xhat,
               mi.mutual_information_base_scheme):
        want = getattr(jmi, fn.__name__)(jnm, p)
        np.testing.assert_allclose(fn(tnm, p), want, rtol=1e-10)
    np.testing.assert_allclose(mi.mutual_information_X_Y(tnm),
                               jmi.mutual_information_X_Y(jnm), rtol=1e-10)


def jax_samples(jpa, dtype, key, shape):
    """The symbols and normals JAX's ``_mc_info_impl`` draws from ``key``."""
    kx, kn = jax.random.split(key)
    x = jpa.random_symbols(kx, shape[-1])
    noise = jax.random.normal(kn, (shape[-1],), jnp.dtype(dtype))
    return np.asarray(x), np.asarray(noise)


MC_TOL = {"float64": dict(rtol=1e-12, atol=1e-12),
          "float32": dict(rtol=1e-5, atol=1e-6)}


@pytest.mark.parametrize("bps,snr,signs,dtype,ginv", [
    (2, 5.0, [0, 1, 0, 1], "float64", "interp"),
    (2, 5.0, [0, 1, 0, 1], "float32", "poly"),
    (3, 11.0, None, "float64", "poly"),
    (3, 11.0, None, "float32", "interp"),
])
def test_mc_estimator_matches_jax_on_identical_samples(bps, snr, signs,
                                                       dtype, ginv):
    N = 4096
    with jax.enable_x64(dtype == "float64"):
        jpa, jnm, tpa, tnm = mapper_pair(bps, snr, dtype, signs)
        p = jmi.P_xhat(jnm)
        if ginv == "poly":
            jnm._ensure_ginv_poly()
        key = jax.random.key(5)
        want = [float(v) for v in jmi._mc_info(
            key, jpa, jnm, jnp.asarray(p, jnm.dtype), N, (True,) * 3, ginv)]
        xy = jax_samples(jpa, dtype, key, (N,))
    got = mi.montecarlo_information(None, tpa, tnm, p, N, ginv_mode=ginv,
                                    xy=xy)
    np.testing.assert_allclose(got, want, **MC_TOL[dtype])
    # the signs of the reference's accumulators
    assert got[0] < 0 and got[1] < 0 and got[2] > 0


@pytest.mark.parametrize("ginv", ["interp", "poly"])
def test_batched_equals_per_mapper_calls(ginv):
    """Sign-config clones (tables shared) and a mapper built separately (its
    own tables) in one batched call: each row equals that mapper's own call
    on the same samples."""
    pa = PAMAlphabet(2, 2.0)
    base = NoiseMapper(pa, noise_var(pa, 6.0), dtype=torch.float64,
                       device="cpu")
    if ginv == "poly":
        base._ensure_ginv_poly()
    nms = [base.with_sign_config(c) for c in
           ([0, 0, 0, 0], [0, 1, 0, 1], [1, 1, 0, 0], [1, 0, 1, 0])]
    nms.append(NoiseMapper(pa, noise_var(pa, 6.0), [0, 1, 1, 0],
                           dtype=torch.float64, device="cpu"))
    P, N = len(nms), 2048
    gen = torch.Generator().manual_seed(3)
    xy = mi._draw(gen, pa, base, (P, N))
    p = np.stack([mi.P_xhat(nm) for nm in nms])
    got = mi.montecarlo_information_batched(None, pa, nms, p, N,
                                            (True, True, True), ginv, xy=xy)
    assert got.shape == (P, 3)
    for k, nm in enumerate(nms):
        want = mi.montecarlo_information(None, pa, nm, p[k], N,
                                         ginv_mode=ginv,
                                         xy=(xy[0][k], xy[1][k]))
        np.testing.assert_allclose(got[k], want, rtol=1e-13, atol=1e-13)
    # the sign configurations move I(X,N;Xhat)
    assert np.ptp(got[:, 2]) > 1e-3
    # a generator draws the same [P, N] samples
    again = mi.montecarlo_information_batched(
        torch.Generator().manual_seed(3), pa, nms, p, N, (True,) * 3, ginv)
    np.testing.assert_array_equal(again, got)


def test_batched_rejects_mismatched_mappers():
    pa2, pa3 = PAMAlphabet(2, 2.0), PAMAlphabet(3, 2.0)
    a = NoiseMapper(pa2, 0.3, dtype=torch.float64, device="cpu")
    for other in (NoiseMapper(pa3, 0.3, dtype=torch.float64, device="cpu"),
                  NoiseMapper(pa2, 0.3, dtype=torch.float32, device="cpu"),
                  NoiseMapper(pa2, 0.3, dtype=torch.float64, device="cpu",
                              fy_mode="poly")):
        with pytest.raises(ValueError, match="NoiseMapper 1's structure"):
            mi.montecarlo_information_batched(
                None, pa2, [a, other], np.stack([mi.P_xhat(a)] * 2), 16,
                (True, True, True))


# ------------------------------------------------------------- the CLIs


def read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


def run_clis(name, tmp_path, argv):
    """The JAX CLI and the port's (on the CPU) with the same flags; their
    CSVs (header, values)."""
    import importlib

    out = {}
    for pkg in ("qamreconciliation_tpu", "qamreconciliation_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.sims.{name}")
        path = str(tmp_path / f"{pkg}.csv")
        extra = ["--device", "cpu"] if pkg.endswith("torch") else []
        mod.main([*argv, "--out", path, *extra])
        out[pkg] = read_csv(path)
    (jh, jv), (th, tv) = out["qamreconciliation_tpu"], \
        out["qamreconciliation_tpu_torch"]
    assert th == jh and tv.shape == jv.shape
    return tv, jv


def test_base_scheme_cli_matches_jax(tmp_path):
    got, want = run_clis("sim_mutual_information_base_scheme", tmp_path,
                         ["--snr", "0", "6", "--nsnr", "3", "--bps", "2"])
    np.testing.assert_allclose(got, want, rtol=1e-10)


def mc_terms_se(bps, snr, which, signs=None, samples=1 << 14):
    """Standard error of one sample of each MC estimator (its per-sample
    standard deviation), from a port draw."""
    pa = PAMAlphabet(bps, 2.0)
    nm = NoiseMapper(pa, noise_var(pa, snr), signs, dtype=torch.float64,
                     device="cpu")
    xy = mi._draw(torch.Generator().manual_seed(99), pa, nm, (1, samples))
    p = torch.as_tensor(mi.P_xhat(nm))[None, :]
    terms = mi._mc_terms(pa, nm, p, *xy, which, "interp")
    return [0.0 if t is None else float(t.std()) for t in terms]


def test_montecarlo_cli_matches_jax(tmp_path):
    argv = ["--snr", "0", "10", "--nsnr", "3", "--bps", "2", "--niters", "4",
            "--samples-per-iter", "2048", "--dtype", "float64"]
    got, want = run_clis("sim_montecarlo_information", tmp_path, argv)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])   # index, point
    n = 4 * 2048
    for r, snr in enumerate((0.0, 5.0, 10.0)):
        sd = mc_terms_se(2, snr, (True, True, True))
        for e in range(3):
            bound = 4 * math.sqrt(2.0) * sd[e] / math.sqrt(n)
            assert abs(got[r, 2 + e] - want[r, 2 + e]) <= bound, (snr, e)


def test_compare_signs_cli_matches_jax(tmp_path):
    """Host quadrature per configuration within 1e-10; the Monte-Carlo
    path within 4 standard errors, config by config."""
    grid = ["--snr", "2", "8", "--nsnr", "3", "--bps", "2"]
    (tmp_path / "quad").mkdir()
    (tmp_path / "mc").mkdir()
    got, want = run_clis("sim_mutual_information_compare_signs",
                         tmp_path / "quad", grid)
    assert got.shape == (3, 2 + 10)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    mc = grid + ["--montecarlo", "--nmontecarlo", "2048", "--nloops", "2",
                 "--config-chunk", "4"]
    got_mc, want_mc = run_clis("sim_mutual_information_compare_signs",
                               tmp_path / "mc", mc)
    np.testing.assert_array_equal(got_mc[:, :2], want_mc[:, :2])
    configs, _ = enumerate_configs(4)
    n = 2048 * 2
    for r, snr in enumerate((2.0, 5.0, 8.0)):
        for k, cfg in enumerate(configs):
            sd = mc_terms_se(2, snr, (False, False, True), signs=cfg,
                             samples=1 << 12)[2]
            bound = 4 * math.sqrt(2.0) * sd / math.sqrt(n)
            assert abs(got_mc[r, 2 + k] - want_mc[r, 2 + k]) <= bound
        # Monte-Carlo against quadrature, within the same bound
        np.testing.assert_allclose(got_mc[r, 2:], got[r, 2:], atol=0.05)


def test_montecarlo_cli_resume_gnuplot_and_display(tmp_path, monkeypatch,
                                                   capsys):
    """--resume takes a journalled point as it stands; --gnuplot writes the
    script; --display without matplotlib says so and still writes the
    CSV."""
    from qamreconciliation_tpu_torch.sims import sim_montecarlo_information

    out = str(tmp_path / "mc.csv")
    state = SweepState(out)
    state.record(0.0, dict(ixxh=-1.0, ixy=-2.0, ixnxh=3.0))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rows = sim_montecarlo_information.main([
        "--snr", "0", "4", "--nsnr", "2", "--niters", "1",
        "--samples-per-iter", "512", "--resume", "--gnuplot", "--display",
        "--device", "cpu", "--out", out])
    assert rows[0] == (0.0, -1.0, -2.0, 3.0)
    header, vals = read_csv(out)
    assert header == ["", "EsN0dB", "I(X;Xhat)", "I(X;Y)", "I(N,X;Xhat)"]
    np.testing.assert_array_equal(vals[0], [0, 0.0, -1.0, -2.0, 3.0])
    assert vals[1, 2] < 0 < vals[1, 4]
    with open(out + ".gnuplot") as f:
        assert "using 2:5 with lines" in f.read()
    assert "needs matplotlib" in capsys.readouterr().err
