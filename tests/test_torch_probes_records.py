"""What ``probe_resident_vmem``, ``probe_decode``, ``probe_round`` and
``probe_streaming`` print, against the JAX package's ``scripts/`` on the
CPU.

Each JAX probe is loaded by path and run through its ``main`` at a small
size (n = 288 for the resident probe, n = 2304 for the others, a few
frames and 2 iterations), with ``pl.pallas_call`` and the JAX package's
``bp_check_phase_qc`` in interpret mode, and the bf16 runs inside
``jax.enable_x64(False)`` (the suite's conftest turns x64 on, which the
JAX bf16 mapper does not take).  The port's probe then runs the same
flags with ``--device cpu``:

* its first record names the device; the rest have the JAX probe's keys
  in its order, with the same configuration values (the resident QC
  decode's ``resident_double``, a TPU buffer, becomes ``plan``);
* ``probe_resident_vmem``'s two JAX lines have the same form;
* ``probe_streaming``'s frame counts and dispatches are equal and its
  successes and bit errors within 4 standard errors (the square root of
  the count: the two mappers round bf16 in different places).
"""

import importlib.util
import json
import math
import os
import re
import sys

import jax
import pytest
import torch
from jax.experimental import pallas as pl

import qamreconciliation_tpu.ops.pallas_kernels as j_pallas
from qamreconciliation_tpu_torch.scripts import (
    probe_decode, probe_resident_vmem, probe_round, probe_streaming,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--n", "2304", "--batch", "4", "--maxiter", "2", "--reps", "1"]
STREAM = ["--n", "2304", "--frames", "4", "--batch", "2", "--maxiter", "2"]


def run_jax_main(name, argv, monkeypatch, capsys):
    """Lines the JAX probe ``name`` prints on stdout for ``argv``."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    orig_pallas, orig_check = pl.pallas_call, j_pallas.bp_check_phase_qc

    def pallas_call(kernel, **kw):
        kw["interpret"] = True
        return orig_pallas(kernel, **kw)

    def check_phase(*a, **kw):
        kw["interpret"] = True
        return orig_check(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    monkeypatch.setattr(j_pallas, "bp_check_phase_qc", check_phase)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    capsys.readouterr()
    with jax.enable_x64(False):
        mod.main()
    lines = capsys.readouterr().out.splitlines()
    monkeypatch.undo()
    return lines


def port_records(module, argv, capsys):
    """(device record, the other records) of the port probe on the CPU."""
    assert module.main([*argv, "--device", "cpu"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    name = module.__name__.rsplit(".", 1)[1]
    assert recs[0] == {"probe": name, "device": "cpu", "power_limit": None}
    return recs[1:]


def jax_records(lines):
    return [json.loads(x) for x in lines if x.startswith("{")]


def test_resident_vmem_prints_the_jax_lines(monkeypatch, capsys):
    argv = ["--variant", "nocapture", "--zc", "8", "--n", "288", "--batch",
            "8", "--k", "2"]
    want = run_jax_main("probe_resident_vmem", argv, monkeypatch, capsys)
    assert probe_resident_vmem.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert json.loads(got[0]) == {"probe": "probe_resident_vmem",
                                  "device": "cpu", "power_limit": None}

    def form(line):
        return re.sub(r"\d+\.\d+", "X", line)

    assert [form(x) for x in got[1:3]] == [form(x) for x in want]
    assert want[1].endswith("(2 iters/call, 6 calls)")
    assert got[3].startswith("nocapture: ptxas none") and "--zc 8" in got[3]


CONFIG_KEYS = ("n", "nbv", "batch", "qc", "pallas", "dtype", "check",
               "schedule", "resident", "phi", "resident_chunk",
               "totals_dtype")


@pytest.mark.parametrize("flags", [["--pallas", "0"], ["--qc", "0"]],
                         ids=["dense-plain", "generic"])
def test_decode_record_equals_the_jax_probe(flags, monkeypatch, capsys):
    want = jax_records(run_jax_main("probe_decode", [*SMALL, *flags],
                                    monkeypatch, capsys))
    got = port_records(probe_decode, [*SMALL, *flags], capsys)
    assert len(got) == len(want) == 1
    assert list(got[0]) == list(want[0])
    assert {k: got[0][k] for k in CONFIG_KEYS} == \
        {k: want[0][k] for k in CONFIG_KEYS}
    assert got[0]["ms_per_iter"] > 0 and got[0]["decode_fps"] > 0


@pytest.mark.parametrize("flags", [["--resident", "1"],
                                   ["--resident", "1", "--schedule",
                                    "layered"]])
def test_resident_decode_record_holds_the_plan(flags, capsys):
    got = port_records(probe_decode, [*SMALL, *flags], capsys)[0]
    base = ["n", "nbv", "batch", "qc", "pallas", "dtype", "check",
            "schedule", "resident", "phi", "resident_chunk", "totals_dtype",
            "ms_per_iter", "decode_fps", "compile_s"]
    assert list(got) == base + ["plan", "totals_f32"]
    assert got["plan"] is None and got["totals_f32"] is False   # no kernel


def test_round_records_equal_the_jax_probe(monkeypatch, capsys):
    want = jax_records(run_jax_main("probe_round", SMALL, monkeypatch,
                                    capsys))
    got = port_records(probe_round, SMALL, capsys)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [(r["stage"], r["bps"]) for r in got] == \
        [(r["stage"], r["bps"]) for r in want] == [
            ("syndrome_from_bits", 4), ("preamble+synd", 4),
            ("full_round", 4), ("decode_only", 4)]


@pytest.mark.parametrize("flags", [[], ["--fused", "1"], ["--handoff", "1"]],
                         ids=["split", "fused", "handoff"])
def test_streaming_record_equals_the_jax_probe(flags, monkeypatch, capsys):
    want = jax_records(run_jax_main("probe_streaming", [*STREAM, *flags],
                                    monkeypatch, capsys))[0]
    got = port_records(probe_streaming, [*STREAM, *flags], capsys)[0]
    assert list(got) == list(want)
    for key in ("frames", "decoded_frames", "batch", "chunk_frames",
                "snr_dB", "dispatches", "defer", "fused", "handoff"):
        assert got.get(key) == want.get(key), key
    for key in ("success", "bit_errors"):
        assert abs(got[key] - want[key]) <= 4 * math.sqrt(
            max(want[key], 1)), key
