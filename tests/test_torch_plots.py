"""The port's five plotters (``qamreconciliation_tpu_torch/scripts/plot_*``)
against the JAX package's ``scripts/plot_*``.

* Each renders headless from the committed ``docs/img`` CSVs into a PNG,
  and draws the JAX plotter's curves: the same x and y data, point for
  point, with the same formats, on the same number of panels.
* ``sims/_display.read_table`` reads every one of those CSVs column for
  column as pandas does.
* ``--records`` names the card from a campaign's device record; without
  it the title names no device.  The committed H100 sweeps render too.
"""

import functools
import importlib
import importlib.util
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from matplotlib.axes import Axes  # noqa: E402

from qamreconciliation_tpu_torch.scripts import _plot  # noqa: E402
from qamreconciliation_tpu_torch.sims import _display  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = os.path.join(REPO, "docs", "img")
H100 = os.path.join(REPO, "qamreconciliation_tpu_torch", "scripts", "h100")
# plotter -> its CSVs in docs/img, in argument order (OUT.png after them)
PLOTS = {
    "plot_checkrule_waterfall": ["wf_sumproduct.csv", "wf_minsum.csv"],
    "plot_schedule_waterfall": ["wf_sumproduct.csv", "wf_minsum.csv",
                                "wf_layered_minsum.csv"],
    "plot_sumproduct_engines_waterfall": [
        "wf_sumproduct_bf16.csv", "wf_tanhfb_resident.csv",
        "wf_sumproduct.csv"],
    "plot_irregular_waterfall": ["wf_ira_resident.csv", "wf_ira_dense.csv"],
    "plot_bps4_waterfall": ["bps4_soft_alt.csv", "bps4_soft_base.csv",
                            "bps4_hard.csv", "bps4_direct.csv"],
}
READ_CSV = pd.read_csv
CSVS = sorted({c for cs in PLOTS.values() for c in cs}
              | {"wf_tanhfb_resident_hybrid.csv"})


def port(name):
    return importlib.import_module(
        f"qamreconciliation_tpu_torch.scripts.{name}")


def jax_plotter(name, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traced(monkeypatch):
    """Record every ``Axes.plot`` call (``semilogy`` draws through it) as
    (panel, x, y, format)."""
    lines, plot = [], Axes.plot

    def rec(ax, *args, **kw):
        panels = list(ax.figure.axes)
        x, y, fmt = args
        lines.append((panels.index(ax), np.asarray(x, np.float64),
                      np.asarray(y, np.float64), fmt))
        return plot(ax, *args, **kw)

    monkeypatch.setattr(Axes, "plot", rec)
    return lines


def cases():
    out = []
    for name, csvs in PLOTS.items():
        out.append((name, csvs))
    out.append(("plot_sumproduct_engines_waterfall",
                PLOTS["plot_sumproduct_engines_waterfall"]
                + ["wf_tanhfb_resident_hybrid.csv"]))
    return out


@pytest.mark.parametrize("name,csvs", cases(),
                         ids=[f"{n}-{len(c)}" for n, c in cases()])
def test_plotter_draws_the_jax_plotters_curves(name, csvs, tmp_path,
                                               monkeypatch):
    paths = [os.path.join(IMG, c) for c in csvs]
    drawn = {}
    for side in ("jax", "port"):
        lines = traced(monkeypatch)
        png = str(tmp_path / f"{side}.png")
        if side == "jax":
            # pandas' correctly rounded parser, as read_table reads (its
            # default parser may differ in the last bits)
            monkeypatch.setattr(pd, "read_csv", functools.partial(
                READ_CSV, float_precision="round_trip"))
            args = paths[:len(PLOTS[name])] + [png] + paths[len(PLOTS[name]):]
            jax_plotter(name, monkeypatch).main(*args)
        else:
            extra = paths[len(PLOTS[name]):]
            port(name).main(paths[:len(PLOTS[name])] + [png] + extra)
        with open(png, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        assert os.path.getsize(png) > 10_000
        monkeypatch.undo()
        drawn[side] = lines
    assert len(drawn["port"]) == len(drawn["jax"]) >= 2 * len(csvs)
    for (pa, xa, ya, fa), (pb, xb, yb, fb) in zip(drawn["port"],
                                                  drawn["jax"]):
        assert (pa, fa) == (pb, fb)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("name", CSVS)
def test_read_table_reads_what_pandas_reads(name):
    path = os.path.join(IMG, name)
    got = _display.read_table(path)
    want = pd.read_csv(path, float_precision="round_trip")
    assert list(got)[1:] == list(want)[1:] and list(got)[0] == ""
    for key in list(want)[1:]:
        np.testing.assert_array_equal(got[key], want[key].to_numpy())


def test_records_name_the_card(tmp_path):
    rec = tmp_path / "campaign.jsonl"
    rec.write_text(json.dumps({"campaign": "run_waterfall",
                               "device": "NVIDIA H100 80GB HBM3",
                               "power_limit": "700.00 W"}) + "\n"
                   + json.dumps({"csv": "wf.csv", "wall_s": 1.0}) + "\n")
    assert _plot.card(str(rec)) == ", NVIDIA H100 80GB HBM3"
    assert _plot.card(None) == ""
    png = str(tmp_path / "c.png")
    port("plot_checkrule_waterfall").main(
        [os.path.join(IMG, "wf_sumproduct.csv"),
         os.path.join(IMG, "wf_minsum.csv"), png, "--records", str(rec)])
    assert os.path.getsize(png) > 10_000


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plotter_renders_the_h100_sweeps(name, tmp_path):
    """The committed H100 sweeps (``scripts/run_h100.sh``), each figure's
    card named from its first sweep's records."""
    csvs = [os.path.join(H100, c) for c in PLOTS[name]]
    png = str(tmp_path / "h100.png")
    records = csvs[0][:-len(".csv")] + ".jsonl"
    assert _plot.card(records) == ", NVIDIA H100 80GB HBM3"
    port(name).main(csvs + [png, "--records", records])
    assert os.path.getsize(png) > 10_000


def test_titles_name_no_tpu():
    for name in PLOTS:
        with open(port(name).__file__) as f:
            src = f.read()
        assert "TPU" not in src and "VMEM" not in src, name
