"""The dense QC flooding loop as the benchmark's ``qc36.dense-3.5dB`` cell
runs it (bf16, the phi sum-product rule): its gather 1 span once a decode
and its gather 2 span around the variable pass once an iteration under a
profiler, and no span without one; bit-equality with the
benchmark's frozen plain reference (``rrbench/decoders/qc_dense.py``) on a
small QC (3,6) code, which a planted fault breaks; and the reference's
copy of kernel 1's work count."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qamreconciliation_tpu_torch.utils import perf
from rrbench import codes, decoders
from rrbench.decoders import qc_dense
from rrbench.ref import Precision
from rrbench.ref.checks import messages as tanhfb_messages

CODE = {"kind": "qc_ldpc", "nb_v": 24, "z": 16, "dv": 3, "dc": 6, "seed": 5}
SPEC = {"kind": "qc_dense", "check_rule": "sumproduct", "check_phi": "phi"}
B, MAXITER = 8, 20


def _code():
    return codes.build(CODE)


def _program(code):
    torch.set_num_threads(1)
    return qc_dense.program(code, SPEC, "bfloat16", "cpu")


def _reference(code):
    return qc_dense.Reference(code, SPEC, Precision("bfloat16"), "cpu")


def _inputs(code, converging: bool, seed: int):
    """bf16 priors [N, B] and the syndrome [C, B]: a codeword-ish prior
    about a random word (its syndrome's frames converge within a few
    iterations), or noise against random syndrome bits (no frame
    converges)."""
    g = torch.Generator().manual_seed(seed)
    n, c = code.vnum, code.cnum
    if converging:
        word = torch.randint(0, 2, (n, B), generator=g, dtype=torch.int32)
        prior = (1 - 2 * word).float() * 2.0 + 1.5 * torch.randn(
            (n, B), generator=g)
        synd = decoders.syndrome(code, word)
    else:
        prior = torch.randn((n, B), generator=g)
        synd = torch.randint(0, 2, (c, B), generator=g, dtype=torch.int32)
    return prior.to(torch.bfloat16), synd


def _same(got, want):
    """success, iters and the final values' bit patterns all equal."""
    return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2].view(torch.int16),
                            want[2].view(torch.int16)))


@pytest.mark.parametrize("converging", [True, False])
def test_the_dense_decode_is_bit_equal_to_the_reference(converging):
    code = _code()
    prior, synd = _inputs(code, converging, seed=11 + converging)
    got = _program(code).decode_batched(prior, synd, MAXITER)
    want = _reference(code).decode(prior, synd, MAXITER)
    if converging:
        assert bool(got[0].all()) and int(got[1].max()) < MAXITER - 1
    else:
        assert not bool(got[0].any())
        assert bool((got[1] == MAXITER).all())
    assert got[2].dtype == want[2].dtype == torch.bfloat16
    assert _same(got, want)
    assert torch.equal(got[2] < 0, want[2] < 0)


def test_a_reference_with_another_rule_reads_as_different(monkeypatch):
    code = _code()
    prior, synd = _inputs(code, False, seed=3)
    got = _program(code).decode_batched(prior, synd, MAXITER)
    monkeypatch.setattr(qc_dense, "phi_messages", tanhfb_messages)
    assert not _same(got, _reference(code).decode(prior, synd, MAXITER))


def test_a_reference_one_iteration_short_reads_as_different():
    code = _code()
    prior, synd = _inputs(code, False, seed=4)
    got = _program(code).decode_batched(prior, synd, MAXITER)
    want = _reference(code).decode(prior, synd, MAXITER - 1)
    assert not torch.equal(got[2].view(torch.int16),
                           want[2].view(torch.int16))
    assert not _same(got, want)


def _span_counts(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    n = {}
    for ev in events:
        name = ev.get("name", "")
        if ev.get("ph") == "X" and name.startswith("rr."):
            n[name] = n.get(name, 0) + 1
    return n


@pytest.mark.parametrize("converging", [True, False])
def test_a_profiled_dense_decode_gathers_once_and_passes_each_iteration(
        converging, tmp_path):
    """Gather 1 opens once a decode (the first iteration's t); every
    iteration opens gather 2 around one variable pass, which writes the
    next t."""
    code = _code()
    dec = _program(code)
    prior, synd = _inputs(code, converging, seed=5)
    it0 = dec.iterations_run
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dec.decode_batched(prior, synd, MAXITER)
    iters = dec.iterations_run - it0
    n = _span_counts(prof, tmp_path / "trace.json")
    assert 0 < iters < MAXITER if converging else iters == MAXITER
    assert n["rr.decoder.gather1"] == 1
    assert n["rr.decoder.gather2"] == n["rr.kernel.bp_var_pass_qc"] == iters
    assert n["rr.decoder.poll"] == n["rr.kernel.bp_check_phase_qc"] == iters
    assert n["rr.decoder.decode"] == n["rr.decoder.tail"] == 1


def test_without_a_profiler_the_dense_decode_opens_no_span(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    code = _code()
    dec = _program(code)
    prior, synd = _inputs(code, True, seed=6)
    want = dec.decode_batched(prior, synd, MAXITER)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert _same(dec.decode_batched(prior, synd, MAXITER), want)


@pytest.mark.parametrize("args", [
    (90, 6, 360, 128, torch.bfloat16, torch.bfloat16, "sumproduct"),
    (5, 7, 70, 40, torch.float32, torch.bfloat16, "minsum"),
    (3, 9, 37, 1, torch.float32, torch.float32, "tanhfb"),
], ids=["cell", "padded-rows", "f32"])
def test_the_frozen_work_count_is_kernel_1s(args):
    assert qc_dense.check_phase_qc_work(*args) == \
        perf.check_phase_qc_work(*args)


def test_the_cell_shapes_bound_is_its_bytes():
    nbytes, ops = qc_dense.check_phase_qc_work(
        90, 6, 360, 128, torch.bfloat16, torch.bfloat16, "sumproduct")
    assert nbytes == 165_934_080
    ms, by = perf.bound(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(0.04953, abs=1e-5)


def test_the_reference_takes_the_phi_rule_alone():
    code = _code()
    for spec in ({**SPEC, "check_phi": "tanhfb"},
                 {**SPEC, "check_rule": "minsum"}):
        with pytest.raises(ValueError, match="phi sum-product"):
            qc_dense.Reference(code, spec, Precision("bfloat16"), "cpu")

