"""The port's experiment campaigns (``qamreconciliation_tpu_torch/scripts``)
against the JAX package's ``scripts/``.

* Config equivalence: each JAX campaign, loaded from ``scripts/`` by path,
  and its port run with the sweep CLIs' ``main`` (or the decoder, or the
  MC estimator) replaced on both sides by a recorder; the lists of configs
  are equal once a code file is replaced by the hash of its bytes, an
  output path by its file name, and ``--device`` is dropped.  So are the
  records printed (timings aside) and the oms journal.
* Code files: each one byte-identical to the file the JAX script writes.
* Failure: a config that raises prints the JAX ``"error"`` record, the
  campaign exits 1 after the remaining configs, and nothing is retried on
  another engine.
* Output directory: the default ``--outdir`` is the port's ``h100/``, not
  ``docs/img/``.
* End to end: ``run_r5_knee --configs "dense f32,layered bf16"`` on a
  z = 32 code (N = 384), 256 frames, both ways: the same CSV schema, FER
  and BER within 4 standard errors.
"""

import hashlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import types

import jax
import numpy as np
import pytest
import torch

import qamreconciliation_tpu.models.mutual_information as j_mi
import qamreconciliation_tpu.models.qc_decoder as j_qc
import qamreconciliation_tpu.sims.sim_bsc as j_bsc
import qamreconciliation_tpu.sims.sim_reconciliation as j_sr
from qamreconciliation_tpu_torch.models import mutual_information as t_mi
from qamreconciliation_tpu_torch.models import qc_decoder as t_qc
from qamreconciliation_tpu_torch.scripts import (
    _codes, _runner, run_bps4_grid, run_oms_sweep, run_r5_dvbs2, run_r5_knee,
    run_r5_mi_grid, run_r5_sp_grid, run_r5_stream_grid, run_waterfall,
)
from qamreconciliation_tpu_torch.sims import sim_bsc as t_bsc
from qamreconciliation_tpu_torch.sims import sim_reconciliation as t_sr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"run_waterfall": run_waterfall, "run_r5_dvbs2": run_r5_dvbs2,
        "run_r5_knee": run_r5_knee, "run_bps4_grid": run_bps4_grid,
        "run_oms_sweep": run_oms_sweep, "run_r5_sp_grid": run_r5_sp_grid,
        "run_r5_stream_grid": run_r5_stream_grid,
        "run_r5_mi_grid": run_r5_mi_grid}


def jax_script(name, monkeypatch):
    """``scripts/<name>.py`` loaded by path (its ``sys.path`` edit undone
    after the test)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class Sweeps:
    """Stands in for the sweep CLIs' ``main``: records each call as
    ``[cli, *argv]`` with a code file as the hash of its bytes, the
    ``--out`` path as its file name and ``--device`` dropped, raises for an
    argv holding one of ``fail``, and else writes a one-row CSV of the
    CLI's schema to ``--out``, which must lie under ``root``."""

    def __init__(self, root, fail=(), write=True):
        self.root, self.fail, self.write = str(root), fail, write
        self.calls, self.outs, self.codes = [], [], []

    def cli(self, name, column):
        def main(argv=None):
            argv = list(argv)
            rec, it = [name], iter(argv)
            for a in it:
                if a == "--device":
                    next(it)
                elif a == "--out":
                    self.outs.append(next(it))
                    rec += ["--out", os.path.basename(self.outs[-1])]
                elif a.endswith(".csv") and os.path.isfile(a):
                    self.codes.append(a)
                    rec.append(sha(a))
                else:
                    rec.append(a)
            self.calls.append(rec)
            if any(f in argv for f in self.fail):
                raise RuntimeError("config failed")
            if self.write:
                out = os.path.abspath(self.outs[-1])
                assert out.startswith(self.root), out
                with open(out, "w") as f:
                    f.write(f",{column},ber,fer,iters\n0,3.5,0.01,0.5,20.0\n")
            return [types.SimpleNamespace(fer=0.5, frames_per_s=1.0)]
        return main

    def patch(self, monkeypatch, jax_side):
        sr, bsc = (j_sr, j_bsc) if jax_side else (t_sr, t_bsc)
        monkeypatch.setattr(sr, "main", self.cli("sim_reconciliation",
                                                 "EsN0dB"))
        monkeypatch.setattr(bsc, "main", self.cli("sim_bsc", "f"))


def records(capsys):
    """The JSON records printed since the last read, the device record
    dropped, timings nulled (in a step's nested records too) and paths cut
    to file names."""
    out = []
    for line in capsys.readouterr().out.splitlines():
        if not line.startswith("{"):
            continue
        r = json.loads(line)
        if "campaign" in r:
            continue
        for d in [r, *(v for v in r.values() if isinstance(v, dict))]:
            for key in ("wall_s", "compile_s", "rep_s", "samples_per_s"):
                if key in d:
                    d[key] = None
        if "csv" in r:
            r["csv"] = os.path.basename(r["csv"])
        out.append(r)
    return out


def run_jax(name, argv, monkeypatch, tmp_path):
    """The JAX campaign ``name`` with ``argv``, its temporary directory and
    its repository root (where it writes ``docs/img/``) under
    ``tmp_path``."""
    mod = jax_script(name, monkeypatch)
    mod.REPO = str(tmp_path)
    os.makedirs(tmp_path / "docs" / "img", exist_ok=True)
    if name == "run_waterfall":
        return mod.main(list(argv))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return mod.main()


@pytest.fixture()
def sides(tmp_path, monkeypatch):
    """Run a campaign on one side: ``sides(side)`` points the temporary
    directory at ``tmp_path/side`` and returns it."""
    def use(side):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        monkeypatch.setattr(tempfile, "tempdir", str(d))
        return d
    return use


# campaign -> argv cases, "{tmp}" standing for the case's directory
ARGV_CASES = [
    ("run_waterfall", ["{tmp}/wf.csv", "--snr", "3.0", "4.25", "--nsnr", "6",
                       "--resident", "--check-phi", "tanhfb"]),
    ("run_waterfall", ["{tmp}/wf.csv", "--irregular", "--dtype", "bfloat16"]),
    ("run_waterfall", ["{tmp}/wf.csv", "--rate34", "--resident"]),
    ("run_waterfall", ["{tmp}/wf.csv", "--nbv", "180", "--direct"]),
    ("run_waterfall", ["{tmp}/wf.csv", "--dvbs2", "1/2", "--hard", "--snr",
                       "3.0", "5.5", "--nsnr", "6"]),
    ("run_r5_dvbs2", []),
    ("run_r5_dvbs2", ["--steps", "equiv", "--simloops", "256"]),
    ("run_r5_knee", []),
    ("run_r5_knee", ["--configs", "layered,f32", "--snr", "3.75"]),
    ("run_bps4_grid", []),
    ("run_oms_sweep", ["--out", "{tmp}/oms.jsonl"]),
    ("run_oms_sweep", ["--out", "{tmp}/oms.jsonl", "--resident", "--alphas",
                       "0.75", "1.0", "--betas", "0.0", "0.3"]),
]


@pytest.mark.parametrize(
    "name,argv", ARGV_CASES,
    ids=[f"{n}-{i}" for i, (n, _) in enumerate(ARGV_CASES)])
def test_campaign_configs_equal_the_jax_scripts(name, argv, sides,
                                                monkeypatch, capsys):
    got = {}
    for side in ("jax", "port"):
        tmp = sides(side)
        args = [a.replace("{tmp}", str(tmp)) for a in argv]
        if name == "run_oms_sweep":     # one pair already journaled
            with open(tmp / "oms.jsonl", "w") as f:
                f.write(json.dumps({"alpha": 0.75, "beta": 0.0}) + "\n")
        sw = Sweeps(tmp)
        sw.patch(monkeypatch, side == "jax")
        if side == "jax":
            run_jax(name, args, monkeypatch, tmp)
        else:
            outdir = (["--outdir", str(tmp / "h100")]
                      if name in ("run_r5_dvbs2", "run_oms_sweep") else [])
            assert PORT[name].main(args + ["--device", "cpu"] + outdir) == 0
        journal = (open(tmp / "oms.jsonl").read()
                   if name == "run_oms_sweep" else None)
        got[side] = sw.calls, records(capsys), journal
    assert got["port"][0] == got["jax"][0]
    assert len(got["port"][0]) >= 1
    if name in ("run_r5_dvbs2", "run_r5_knee"):   # the JAX records
        assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]


class FakeDecoder:
    """Stands in for ``QCDecoder``: records (base, z, dtype name, the other
    keywords but ``device``) and raises."""

    def __init__(self, calls):
        self.calls = calls

    def __call__(self, base, z, dtype=None, **kw):
        kw.pop("device", None)
        name = str(dtype).replace("torch.", "") if isinstance(
            dtype, torch.dtype) else np.dtype(dtype).name
        self.calls.append(([tuple(int(x) for x in e) for e in base], int(z),
                           name, sorted(kw.items())))
        raise RuntimeError("recorded")


def test_decode_grid_configs_equal_the_jax_scripts(sides, monkeypatch,
                                                   capsys):
    """sp and stream grids: the config names and each decoder's
    keywords."""
    for name, argv in (("run_r5_sp_grid", []),
                       ("run_r5_stream_grid", ["--n", "1152", "--nbv", "36",
                                               "--frames", "8"])):
        got = {}
        for side in ("jax", "port"):
            tmp = sides(side)
            calls = []
            if side == "jax":
                monkeypatch.setattr(j_qc, "QCDecoder", FakeDecoder(calls))
                run_jax(name, argv, monkeypatch, tmp)
            else:
                monkeypatch.setattr(PORT[name], "QCDecoder",
                                    FakeDecoder(calls))
                assert PORT[name].main(argv + ["--device", "cpu"]) == 1
            got[side] = calls, records(capsys)
        assert got["port"] == got["jax"], name
        n_configs = {"run_r5_sp_grid": 8, "run_r5_stream_grid": 10}[name]
        assert len(got["port"][0]) == len(got["port"][1]) == n_configs
        assert all(r["error"] == "RuntimeError: recorded"
                   for r in got["port"][1])


def test_mi_grid_configs_equal_the_jax_script(sides, monkeypatch, capsys):
    """Each estimator call: bps, which, g^-1 form, CDF form and samples."""
    got = {}
    for side in ("jax", "port"):
        tmp = sides(side)
        calls = []

        def fake(key, pa, nm, p_Xhat, N, which=(True, True, True),
                 ginv_mode="interp", xy=None):
            calls.append((pa.bit_per_symbol, tuple(bool(w) for w in which),
                          ginv_mode, nm.fy_mode, int(N)))
            return 0.0, 0.0, 0.0

        argv = ["--n", "4096", "--reps", "2"]
        if side == "jax":
            monkeypatch.setattr(j_mi, "montecarlo_information", fake)
            with jax.enable_x64(False):
                run_jax("run_r5_mi_grid", argv, monkeypatch, tmp)
        else:
            monkeypatch.setattr(t_mi, "montecarlo_information", fake)
            assert run_r5_mi_grid.main(argv + ["--device", "cpu"]) == 0
        got[side] = calls, records(capsys)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 7 * 3


# (JAX campaign, argv, port builder): the code file each writes
CODE_CASES = [
    ("run_waterfall", ["{tmp}/wf.csv"], lambda: [_codes.qc_ldpc(36)]),
    ("run_waterfall", ["{tmp}/wf.csv", "--nbv", "180"],
     lambda: [_codes.qc_ldpc(180)]),
    ("run_waterfall", ["{tmp}/wf.csv", "--irregular"],
     lambda: [_codes.qc_ira(36, "1/2")]),
    ("run_waterfall", ["{tmp}/wf.csv", "--rate34", "--nbv", "180"],
     lambda: [_codes.qc_ira(180, "3/4")]),
    ("run_waterfall", ["{tmp}/wf.csv", "--dvbs2", "3/4"],
     lambda: [_codes.dvbs2_qc("3/4")]),
    ("run_r5_knee", ["--configs", "target"],
     lambda: [_codes.qc_ldpc(36, "qc36_knee.csv")]),
    ("run_r5_dvbs2", ["--steps", "equiv"],
     lambda: [_codes.dvbs2_qc("1/2"), _codes.dvbs2_exact("1/2")]),
]


@pytest.mark.parametrize(
    "name,argv,build", CODE_CASES,
    ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(CODE_CASES)])
def test_code_files_are_the_jax_scripts_bytes(name, argv, build, sides,
                                              monkeypatch):
    tmp = sides("jax")
    sw = Sweeps(tmp)
    sw.patch(monkeypatch, True)
    run_jax(name, [a.replace("{tmp}", str(tmp)) for a in argv], monkeypatch,
            tmp)
    theirs = list(dict.fromkeys(sw.codes))
    sides("port")
    mine = build()
    assert [os.path.basename(p) for p in mine] == \
        [os.path.basename(p) for p in theirs]
    for a, b in zip(mine, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


def test_a_failing_config_prints_the_error_record_and_exits_1(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    sw = Sweeps(tmp_path, fail=("layered",))
    sw.patch(monkeypatch, False)
    assert run_r5_knee.main(["--device", "cpu"]) == 1
    recs = records(capsys)
    assert [r["config"] for r in recs] == [name for name, _ in
                                           run_r5_knee.GRID]
    assert [r for r in recs if "error" in r] == [
        {"config": "layered bf16", "error": "RuntimeError: config failed"},
        {"config": "layered f32", "error": "RuntimeError: config failed"}]
    assert len(sw.calls) == 5            # one call a config


def test_the_dvbs2_waterfall_is_not_retried_on_the_dense_engine(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    sw = Sweeps(tmp_path, fail=("--resident",))
    sw.patch(monkeypatch, False)
    assert run_r5_dvbs2.main(["--steps", "wf", "--device", "cpu",
                              "--outdir", str(tmp_path)]) == 1
    assert len(sw.calls) == 1 and "--resident" in sw.calls[0]
    assert records(capsys) == [{"step": "wf_dvbs2_12",
                                "engine": "resident-rg4",
                                "error": "RuntimeError: config failed"}]


def test_the_default_outdir_is_not_docs_img(tmp_path, monkeypatch):
    here = os.path.realpath(_runner.DEFAULT_OUTDIR)
    assert here == os.path.join(os.path.realpath(REPO),
                                "qamreconciliation_tpu_torch", "scripts",
                                "h100")
    docs = os.path.realpath(os.path.join(REPO, "docs"))
    assert not here.startswith(docs)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    sw = Sweeps(tmp_path, write=False)
    sw.patch(monkeypatch, False)
    assert run_r5_dvbs2.main(["--steps", "wf,bsc", "--device", "cpu"]) == 0
    assert [os.path.dirname(p) for p in sw.outs] == \
        [_runner.DEFAULT_OUTDIR] * 2
    assert [os.path.basename(p) for p in sw.outs] == ["wf_dvbs2_12.csv",
                                                      "bsc_dvbs2_34.csv"]


def test_knee_end_to_end_both_ways(sides, monkeypatch, capsys):
    """Two knee configs on a z = 32 QC(3,6) code of 12 block columns (N =
    384: the JAX layered schedule compiles a sweep over 6 block rows in a
    few seconds on the CPU), 256 frames at 3.5 dB,
    through the JAX script and the port: CSV schemas equal, FER within 4
    standard errors of the difference (pooled), BER within 4 standard
    errors too, taking a frame's BER variance as at most the pooled BER
    times twice the mean BER of a failed frame."""
    base, _, _ = t_qc.make_qc_ldpc(12, 32, 3, 6, seed=12345)
    argv = ["--configs", "dense f32,layered bf16", "--simloops", "256"]
    got, headers, codes = {}, {}, {}
    for side in ("jax", "port"):
        tmp = sides(side)
        if side == "jax":
            save = j_qc.save_qc_csv
            monkeypatch.setattr(j_qc, "save_qc_csv",
                                lambda path, b, z: save(path, base, 32))
            with jax.enable_x64(False):
                run_jax("run_r5_knee", argv, monkeypatch, tmp)
        else:
            def small(nbv=36, name=None):
                path = os.path.join(tempfile.gettempdir(), name)
                t_qc.save_qc_csv(path, base, 32)
                return path
            monkeypatch.setattr(_codes, "qc_ldpc", small)
            assert run_r5_knee.main(argv + ["--device", "cpu"]) == 0
        got[side] = {r["config"]: r for r in records(capsys)}
        codes[side] = sha(tmp / "qc36_knee.csv")
        headers[side] = sorted(
            open(tmp / f).readline() for f in os.listdir(tmp)
            if f.startswith("knee_"))
    assert codes["port"] == codes["jax"]
    assert headers["port"] == headers["jax"] == [",EsN0dB,ber,fer,iters\n"] * 2
    assert sorted(got["port"]) == sorted(got["jax"]) == [
        "dense f32 (target)", "layered bf16"]
    for name, mine in got["port"].items():
        theirs = got["jax"][name]
        assert set(mine) == set(theirs)
        F = 256
        p = (mine["fer"] + theirs["fer"]) / 2
        assert abs(mine["fer"] - theirs["fer"]) <= \
            4 * math.sqrt(2 * p * (1 - p) / F), (name, mine, theirs)
        b = (mine["ber"] + theirs["ber"]) / 2
        var = b * 2 * (b / p) if p > 0 else 0.0
        assert abs(mine["ber"] - theirs["ber"]) <= \
            4 * math.sqrt(2 * var / F), (name, mine, theirs)
        assert 0 < mine["fer"] < 1 and mine["frames"] == F
