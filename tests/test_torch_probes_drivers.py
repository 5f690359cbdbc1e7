"""Kernel 8's plain version, ``probe_vmem``, ``probe_fb_form`` and the
flags of the last six probes against the JAX package's ``scripts/``, on the
CPU.

* Kernel 8: the JAX probe's Pallas kernel (``scripts/probe_vmem.py``,
  loaded by path, ``pl.pallas_call`` patched to ``interpret=True`` and the
  built call kept) at 1 MiB against ``smem_ceiling_probe_ref``, bit for bit
  on ones (4.0: the JAX probe's own check against 5.0 reads
  ``value=False``, which is pinned here) and on normals.
* ``probe_fb_form``: the JAX probe's ``serial_fb_allbutone_list``, the
  port's copy and both packages' ``fb_allbutone_list``, bit for bit on
  random float32 terms, one to seven of them; the probe's two labels equal
  at each z on the same inputs (N cut to 1440, 2 iterations, B = 4).
* Flags: every new probe's argparse flags, defaults and choices equal the
  JAX probe's, less ``--device`` (``probe_vmem`` and ``probe_fb_form`` have
  none in the JAX package); each exits 2 without a card unless given
  ``--device cpu``.
"""

import argparse
import importlib.util
import json
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from qamreconciliation_tpu.ops import boxplus as jax_boxplus
from qamreconciliation_tpu_torch.ops import boxplus
from qamreconciliation_tpu_torch.ops import kernels as K
from qamreconciliation_tpu_torch.scripts import (
    probe_decode, probe_fb_form, probe_resident_vmem, probe_round,
    probe_streaming, probe_vmem,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"probe_vmem": probe_vmem, "probe_resident_vmem": probe_resident_vmem,
        "probe_fb_form": probe_fb_form, "probe_decode": probe_decode,
        "probe_round": probe_round, "probe_streaming": probe_streaming}
# the JAX probes without argparse (their only flag in the port: --device)
NO_FLAGS = ("probe_vmem", "probe_fb_form")
SMALL_RUNS = {
    "probe_vmem": [],
    "probe_resident_vmem": ["--n", "288", "--batch", "4", "--k", "1"],
    "probe_fb_form": [],
    "probe_decode": ["--n", "2304", "--batch", "4", "--maxiter", "2",
                     "--reps", "1"],
    "probe_round": ["--n", "2304", "--batch", "4", "--maxiter", "2",
                    "--reps", "1"],
    "probe_streaming": ["--n", "2304", "--frames", "4", "--batch", "2",
                        "--maxiter", "2"],
}


def load_jax_script(name, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------- #
# Kernel 8 and probe_vmem


def jax_vmem_run(monkeypatch, mib=1):
    """The JAX probe's line at ``mib`` and its built Pallas call."""
    built = []
    orig = pl.pallas_call

    def pallas_call(kernel, **kw):
        kw["interpret"] = True
        built.append(orig(kernel, **kw))
        return built[-1]

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    mod = load_jax_script("probe_vmem", monkeypatch)
    return mod.probe(mib), built[-1]


def test_smem_ceiling_plain_matches_the_jax_kernel(monkeypatch):
    line, fn = jax_vmem_run(monkeypatch)
    rng = np.random.default_rng(8)
    for x in (np.ones((8, 128), np.float32),
              rng.normal(0, 3, (8, 128)).astype(np.float32)):
        want = np.asarray(fn(jnp.asarray(x)))
        got = K.smem_ceiling_probe_ref(torch.from_numpy(x), 2 ** 20)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)
    assert np.all(want == want)        # finite path taken
    ones = K.smem_ceiling_probe_ref(torch.ones(8, 128), 2 ** 20)
    assert bool((ones == 4.0).all())


def test_the_reference_probe_reads_value_false(monkeypatch):
    """The JAX probe checks ``out == 5.0``, but its kernel computes 2x +
    (x + 1) = 4.0 for x = 1: it reports value=False at every size."""
    line, fn = jax_vmem_run(monkeypatch)
    assert line.startswith("1 MiB scratch: OK value=False compile+run ")
    assert np.all(np.asarray(fn(jnp.ones((8, 128), jnp.float32))) == 4.0)


def test_probe_vmem_prints_every_size(capsys):
    assert probe_vmem.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0]) == {"probe": "probe_vmem", "device": "cpu",
                                    "power_limit": None}
    assert lines[1] == f"shared_memory_per_block_optin: {K.SMEM_BLOCK_MAX} " \
        "bytes"
    sizes = [int(x.split()[0]) for x in lines[2:]]
    assert sizes == [32, 48, 96, 160, 200, 227, 228]
    assert probe_vmem.sizes_kib(K.SMEM_BLOCK_MAX) == tuple(sizes)
    for line in lines[2:]:
        assert re.fullmatch(r"\d+ KiB scratch: OK value=True compile\+run "
                            r"\d+\.\ds", line), line


def test_smem_ceiling_takes_only_its_shapes():
    x = torch.ones(8, 128)
    n0 = K.smem_ceiling_probe.launches
    assert torch.equal(K.smem_ceiling_probe(x, 8192),
                       K.smem_ceiling_probe_ref(x, 8192))
    assert K.smem_ceiling_probe.launches == n0
    for nbytes in (4096, 8192 + 100):
        with pytest.raises(ValueError):
            K.smem_ceiling_probe_ref(x, nbytes)
    with pytest.raises(ValueError):
        K.smem_ceiling_probe_ref(torch.ones(8, 64), 8192)
    with pytest.raises(ValueError):
        K.smem_ceiling_probe_ref(x.double(), 8192)


def test_a_refused_size_names_its_error():
    e = K.SharedMemoryRefused(233472, 1, "cudaErrorInvalidValue")
    assert isinstance(e, RuntimeError) and e.nbytes == 233472
    assert str(e).startswith("cudaErrorInvalidValue (1): 233472 bytes")


# --------------------------------------------------------------------- #
# probe_fb_form


@pytest.mark.parametrize("n", range(1, 8))
def test_serial_forms_are_one_form(n, monkeypatch):
    mod = load_jax_script("probe_fb_form", monkeypatch)
    rng = np.random.default_rng(n)
    terms = [rng.uniform(-1.5, 1.5, (5, 3)).astype(np.float32)
             for _ in range(n)]
    jt = [jnp.asarray(t) for t in terms]
    tt = [torch.from_numpy(t) for t in terms]
    results = [mod.serial_fb_allbutone_list(jt),
               jax_boxplus.fb_allbutone_list(jt),
               probe_fb_form.serial_fb_allbutone_list(tt),
               boxplus.fb_allbutone_list(tt)]
    want_out, want_full = results[0]
    for out, full in results[1:]:
        assert len(out) == n
        assert all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(out, want_out))
        assert np.array_equal(np.asarray(full), np.asarray(want_full))


def small_fb(monkeypatch):
    for name, value in (("N", 1440), ("B", 4), ("ITERS", 2), ("REPS", 1)):
        monkeypatch.setattr(probe_fb_form, name, value)


def test_fb_form_labels_decode_alike_and_restore_the_form(monkeypatch):
    small_fb(monkeypatch)
    seen = []

    def spy(terms):
        seen.append(len(terms))
        return probe_fb_form.serial_fb_allbutone_list(terms)

    shared = boxplus.fb_allbutone_list
    dev = torch.device("cpu")
    for nbv in (36, 180):
        rec, out = probe_fb_form.run("tree", nbv, shared, dev,
                                     np.random.default_rng(0))
        rec2, out2 = probe_fb_form.run("serial", nbv, spy, dev,
                                       np.random.default_rng(0))
        assert all(torch.equal(a, b) for a, b in zip(out, out2))
        assert list(rec) == ["config", "nbv", "compile_s", "ms_per_iter",
                             "reps"]
        assert boxplus.fb_allbutone_list is shared
    assert seen and set(seen) == {6}     # the swap reached the check rule


def test_fb_form_main_prints_the_jax_records(monkeypatch, capsys):
    small_fb(monkeypatch)
    assert probe_fb_form.main(["--device", "cpu"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert recs[0] == {"probe": "probe_fb_form", "device": "cpu",
                       "power_limit": None}
    assert [(r["config"], r["nbv"]) for r in recs[1:]] == [
        ("z1800 tree", 36), ("z1800 serial", 36), ("z360 tree", 180),
        ("z360 serial", 180)]
    assert all(len(r["reps"]) == 1 for r in recs[1:])


def test_fb_form_error_record_and_status(monkeypatch, capsys):
    small_fb(monkeypatch)
    shared = boxplus.fb_allbutone_list

    def broken(terms):
        raise RuntimeError("no form")

    monkeypatch.setattr(probe_fb_form, "serial_fb_allbutone_list", broken)
    assert probe_fb_form.main(["--device", "cpu"]) == 1
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert recs[2] == {"config": "z1800 serial",
                       "error": "RuntimeError: no form"}
    assert "error" not in recs[1] and boxplus.fb_allbutone_list is shared


# --------------------------------------------------------------------- #
# Flags and the card


class _Parsed(Exception):
    pass


def parser_of(main, argv, monkeypatch):
    """The ArgumentParser ``main`` builds (stopped at parse_args)."""
    seen = []

    def parse_args(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Parsed):
        main(argv)
    monkeypatch.undo()
    return seen[0]


def flags(parser):
    return sorted((tuple(a.option_strings), a.dest, a.default,
                   tuple(a.choices) if a.choices else None,
                   getattr(a.type, "__name__", None), a.required)
                  for a in parser._actions
                  if a.dest not in ("help", "device"))


@pytest.mark.parametrize("name", sorted(PORT))
def test_flags_equal_the_jax_probe(name, monkeypatch):
    port_parser = parser_of(PORT[name].main, [], monkeypatch)
    device = [a for a in port_parser._actions if a.dest == "device"][0]
    assert device.default == "cuda"
    if name in NO_FLAGS:
        src = open(os.path.join(REPO, "scripts", f"{name}.py")).read()
        assert "argparse" not in src
        assert flags(port_parser) == []
        return
    mod = load_jax_script(name, monkeypatch)
    jax_parser = parser_of(lambda argv: mod.main(), [], monkeypatch)
    assert flags(port_parser) == flags(jax_parser)


@pytest.mark.parametrize("name", sorted(PORT))
def test_probe_exits_2_without_a_card(name, capsys):
    assert not torch.cuda.is_available()
    assert PORT[name].main(SMALL_RUNS[name]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "--device cpu" in captured.err
