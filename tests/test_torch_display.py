"""The display CLIs and ``make_dvbs2_code`` of the port.

* Each display CLI renders headless (Agg, ``--save``) from CSVs the JAX
  package's CLIs wrote (``docs/img``) and from ones written the way the
  MI CLIs write theirs; the port reads them with the standard library
  (column for column what pandas reads) and never imports pandas.
* Without matplotlib a display CLI exits non-zero naming it.
* The analytic helpers (uncoded floor, Shannon loci, BI-AWGN capacity)
  equal the JAX package's.
* ``python -m qamreconciliation_tpu_torch.sims.make_dvbs2_code`` writes the
  same bytes as the JAX package's ``scripts/make_dvbs2_code.py`` for rate
  1/2.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from qamreconciliation_tpu.sims import display_biawgn as j_biawgn  # noqa
from qamreconciliation_tpu.sims import display_bsc as j_bsc  # noqa: E402
from qamreconciliation_tpu.sims import display_softened as j_soft  # noqa
from qamreconciliation_tpu_torch.sims import (  # noqa: E402
    _display, display_biawgn, display_bsc, display_mi, display_monotonicity,
    display_softened,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = os.path.join(REPO, "docs", "img")


@pytest.fixture()
def mi_csv(tmp_path):
    path = str(tmp_path / "mi.csv")
    snr = np.linspace(-5, 15, 11)
    sat = 1 / (1 + 10 ** (-snr / 10))
    pd.DataFrame({
        "EsN0dB": snr,
        "I(X;Xhat)": sat * 1.6,
        "I(X;Y)": sat * 2.0,
        "I(N,X;Xhat)": sat * 1.8,
    }).to_csv(path)
    return path


@pytest.mark.parametrize("name", ["wf_dvbs2_12.csv", "bsc_dvbs2_34.csv",
                                  "biawgn_dvbs2_12.csv"])
def test_read_table_is_what_pandas_reads(name):
    """Column for column what pandas' correctly rounded parser reads (its
    default parser may differ in the last bit)."""
    path = os.path.join(IMG, name)
    got = _display.read_table(path)
    want = pd.read_csv(path, float_precision="round_trip")
    assert list(got)[1:] == list(want)[1:] and list(got)[0] == ""
    for key in list(want)[1:]:
        np.testing.assert_array_equal(got[key], want[key].to_numpy())


def saved(tmp_path, name, main, argv):
    out = str(tmp_path / name)
    main(argv + ["--save", out])
    return os.path.getsize(out)


def test_display_softened(tmp_path):
    assert saved(tmp_path, "soft.png", display_softened.main, [
        "--file", os.path.join(IMG, "wf_dvbs2_12.csv"), "run A", "--bps",
        "2", "--rate", "0.5", "--nsnr", "5"]) > 0


def test_display_bsc(tmp_path):
    assert saved(tmp_path, "bsc.png", display_bsc.main, [
        "--file", os.path.join(IMG, "bsc_dvbs2_34.csv"), "decoder",
        "--rate", "0.75"]) > 0


def test_display_biawgn(tmp_path):
    assert saved(tmp_path, "biawgn.png", display_biawgn.main, [
        "--file", os.path.join(IMG, "biawgn_dvbs2_12.csv"), "soft 50 iter",
        "--rate", "0.5", "--shannon"]) > 0


def test_display_mi(mi_csv, tmp_path):
    assert saved(tmp_path, "mi.png", display_mi.main, [
        mi_csv, "--rescalex", "--title", "t", "--extra-file", mi_csv]) > 0


def test_display_monotonicity(mi_csv, tmp_path):
    assert saved(tmp_path, "mono.png", display_monotonicity.main, [
        mi_csv, "--reference-file", mi_csv, "--logy"]) > 0


def test_analytic_helpers_match_jax():
    snr = np.array([-5.0, 0.0, 5.0, 10.0, 15.0])
    np.testing.assert_allclose(display_softened.uncoded_ber(2, snr),
                               j_soft.uncoded_ber(2, snr), rtol=1e-12)
    assert np.all(np.diff(display_softened.uncoded_ber(2, snr)) < 0)
    for got, want in zip(display_bsc.shannon_limit_bsc(0.75, [0.01, 0.1],
                                                       n=20),
                         j_bsc.shannon_limit_bsc(0.75, [0.01, 0.1], n=20)):
        np.testing.assert_array_equal(got, want)
    c = np.array([1e-6, 0.1, 1.0, 10.0, 100.0])
    np.testing.assert_array_equal(display_biawgn.biawgn_capacity(c),
                                  j_biawgn.biawgn_capacity(c))
    np.testing.assert_array_equal(
        display_biawgn.shannon_limit_biawgn(0.5, [-2, 4], n=7)[1],
        j_biawgn.shannon_limit_biawgn(0.5, [-2, 4], n=7)[1])


def test_display_without_matplotlib_names_it(tmp_path):
    """A display CLI on a host without matplotlib (the card's): a non-zero
    exit whose message names it, after the CSV module imported fine."""
    script = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "from qamreconciliation_tpu_torch.sims import display_bsc\n"
        f"display_bsc.main(['--file', {os.path.join(IMG, 'bsc_dvbs2_34.csv')!r},"
        " 'x', '--save', 'x.png'])\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode != 0
    assert "matplotlib" in proc.stderr
    assert "Traceback" not in proc.stderr


def test_display_modules_do_not_import_pandas():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['pandas'] = None\n"
         "import qamreconciliation_tpu_torch.sims.display_mi, "
         "qamreconciliation_tpu_torch.sims.display_monotonicity, "
         "qamreconciliation_tpu_torch.sims.display_softened, "
         "qamreconciliation_tpu_torch.sims.display_bsc, "
         "qamreconciliation_tpu_torch.sims.display_biawgn\n"
         "from qamreconciliation_tpu_torch.sims._display import read_table\n"
         f"print(len(read_table({os.path.join(IMG, 'wf_dvbs2_12.csv')!r})))"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "5"


def test_make_dvbs2_code_matches_the_jax_script(tmp_path):
    """Rate 1/2: both CSVs byte-identical to scripts/make_dvbs2_code.py's."""
    from qamreconciliation_tpu_torch.sims import make_dvbs2_code

    mine, theirs = tmp_path / "port", tmp_path / "jax"
    make_dvbs2_code.main(["--rate", "1/2", "--out-dir", str(mine)])
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_dvbs2_code as j_make
    finally:
        sys.path.pop(0)
    j_make.main(["--rate", "1/2", "--out-dir", str(theirs)])
    for name in ("dvbs2_12_exact.csv", "dvbs2_12_qc.csv"):
        assert (mine / name).read_bytes() == (theirs / name).read_bytes()
