"""The resident layered QC loop as the benchmark's ``qc36.layered-4.0dB``
cell runs it (bf16 messages over f32 totals, min-sum, 4 sweeps a call):
bit-equality with the benchmark's frozen plain reference
(``rrbench/decoders/qc_layered.py``) on a small QC (3,6) code, which
planted faults break; the reference's kernel-3 work count and its
(frame, sweep) pairs; and the loop's spans under a profiler (the prior's
test once, the tail once, a kernel span a call, a poll before each call
and one after the last when every frame is done), none without one."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qamreconciliation_tpu_torch.utils import perf
from rrbench import codes, decoders, work
from rrbench.decoders import qc_layered
from rrbench.ref import Precision

CODE = {"kind": "qc_ldpc", "nb_v": 12, "z": 32, "dv": 3, "dc": 6, "seed": 0}
SPEC = {"kind": "qc_layered", "check_rule": "minsum", "minsum_alpha": 0.8125,
        "minsum_beta": 0.0, "chunk": 4}
B, MAXITER = 16, 20
# the frames' noise about a codeword-ish prior: "mixed" frames converge at
# staggered sweeps or run to the limit, "converging" ones all converge,
# "noise" ones none; frame 0 of each has a consistent prior
MIXES = {"mixed": (0.5, 1.0), "converging": (0.2, 0.5), "noise": None}


class F32Messages:
    """A precision that keeps the messages in f32 (no bf16 rounding)."""

    dtype = torch.float32

    def cast(self, x):
        return x.to(torch.float32)


def _code():
    return codes.build(CODE)


def _program(code):
    torch.set_num_threads(1)
    return qc_layered.program(code, SPEC, "bfloat16", "cpu")


def _reference(code, spec=SPEC, prec=None):
    return qc_layered.Reference(code, spec, prec or Precision("bfloat16"),
                                "cpu")


def _inputs(code, mix: str, seed: int):
    """bf16 priors [N, B] and the syndrome [C, B] of a random word."""
    g = torch.Generator().manual_seed(seed)
    word = torch.randint(0, 2, (code.vnum, B), generator=g,
                         dtype=torch.int32)
    sign = (1 - 2 * word).float()
    if MIXES[mix] is None:
        prior = 2.0 * torch.randn((code.vnum, B), generator=g)
        synd = torch.randint(0, 2, (code.cnum, B), generator=g,
                             dtype=torch.int32)
    else:
        sigma = torch.linspace(*MIXES[mix], B)
        prior = sign + sigma * torch.randn((code.vnum, B), generator=g)
        synd = decoders.syndrome(code, word)
    prior[:, 0] = 2.0 * sign[:, 0]
    synd[:, 0] = decoders.syndrome(code, word)[:, 0]
    return prior.to(torch.bfloat16), synd


def _same(got, want):
    """success, iters and the final f32 totals all equal."""
    return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2]))


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("seed", [0, 1])
def test_the_layered_decode_is_bit_equal_to_the_reference(mix, seed):
    code = _code()
    prior, synd = _inputs(code, mix, seed)
    got = _program(code).decode_batched(prior, synd, MAXITER)
    want = _reference(code).decode(prior, synd, MAXITER)
    success, iters = got[0], got[1]
    assert bool(success[0]) and int(iters[0]) == 0
    live = iters[1:][success[1:]]
    if mix == "mixed":
        assert len(set(live.tolist())) >= 3 and not bool(success.all())
    elif mix == "converging":
        assert bool(success.all()) and int(iters.max()) < MAXITER // 2
    else:
        assert not bool(success[1:].any())
    assert bool((iters[~success] == MAXITER).all())
    assert got[2].dtype == want[2].dtype == torch.float32
    assert _same(got, want)


def _faulty(code, fault):
    """The reference with one planted fault, and the sweeps it is given."""
    if fault == "one_sweep_short":
        return _reference(code), MAXITER - 1
    if fault == "alpha_1":
        return _reference(code, {**SPEC, "minsum_alpha": 1.0}), MAXITER
    return _reference(code, prec=F32Messages()), MAXITER


@pytest.mark.parametrize("fault", ["one_sweep_short", "alpha_1",
                                   "f32_messages"])
def test_a_planted_fault_in_the_reference_reads_as_different(fault):
    code = _code()
    prior, synd = _inputs(code, "mixed", seed=3)
    got = _program(code).decode_batched(prior, synd, MAXITER)
    ref, maxiter = _faulty(code, fault)
    assert not _same(got, ref.decode(prior, synd, maxiter))


def _recorded_calls(dec):
    """Wrap the decoder's kernel hook as the benchmark's recorder does and
    keep each call's record."""
    records = []
    kernel = getattr(dec, qc_layered.KERNEL_HOOK)

    def call(*args, **kw):
        pre = qc_layered.pre_call(args, kw)
        out = kernel(*args, **kw)
        records.append(qc_layered.call_record(args, kw, pre))
        return out
    setattr(dec, qc_layered.KERNEL_HOOK, call)
    return records


@pytest.mark.parametrize("mix", ["mixed", "converging"])
def test_frame_sweeps_count_each_frames_sweeps_until_it_converged(mix):
    """Over a decode the calls' pairs add up to each converged frame's
    1-based ``iters`` and every other frame's sweeps run; kernel 2's
    count (its last step tests and freezes, so ``+ 1``) overcounts each
    frame that converged in a call."""
    code = _code()
    dec = _program(code)
    records = _recorded_calls(dec)
    prior, synd = _inputs(code, mix, seed=2)
    it0 = dec.iterations_run
    success, iters, _ = dec.decode_batched(prior, synd, MAXITER)
    run = dec.iterations_run - it0
    want = int(torch.where(success, iters, run).sum())
    assert sum(int(r["frame_sweeps"]) for r in records) == want
    assert sum(r["sweeps"] for r in records) == run
    converged_in_a_call = int((success & (iters > 0)).sum())
    assert converged_in_a_call > 0

    # the same calls counted by kernel 2's rule
    dec = _program(code)
    k2 = []
    kernel = dec.sweeps_step

    def call(*args, **kw):
        pre = args[6].clone()
        out = kernel(*args, **kw)
        n = max(min(kw["k_sweeps"], args[2] - args[1]), 0)
        k2.append(int(work.frame_steps(pre, args[6], args[7], args[1], n)))
        return out
    dec.sweeps_step = call
    dec.decode_batched(prior, synd, MAXITER)
    assert sum(k2) == want + converged_in_a_call


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("m_dtype", [torch.bfloat16, torch.float32])
def test_the_work_count_is_kernel_3s_times_the_sweeps(n, m_dtype):
    """With no frame frozen a call's pairs are ``B * n``: the bytes are
    ``utils/perf.layered_sweeps_work``'s, the operations ``n`` times its
    one sweep's."""
    dims = (180, 90, 540, 360, 128)
    nbytes, ops = perf.layered_sweeps_work(*dims, m_dtype, "minsum")
    done = torch.zeros(128, dtype=torch.int32)
    pairs = int(qc_layered.frame_sweeps(done, done, done, 8, n))
    assert pairs == 128 * n
    assert qc_layered.layered_sweeps_work(*dims, m_dtype, "minsum",
                                          pairs) == (nbytes, n * ops)


def test_the_work_count_takes_a_converged_frames_sweeps():
    """A frame done before the call: none; one converged at 1-based sweep
    ``iters`` in a call from ``it0``: ``iters - it0``; the rest: ``n``."""
    before = torch.tensor([1, 0, 0, 0], dtype=torch.int32)
    after = torch.tensor([1, 1, 1, 0], dtype=torch.int32)
    iters = torch.tensor([3, 9, 12, 0], dtype=torch.int32)
    assert int(qc_layered.frame_sweeps(before, after, iters, 8, 4)) == \
        0 + 1 + 4 + 4


def test_the_cell_shapes_bound_is_its_bytes():
    nbytes, ops = qc_layered.layered_sweeps_work(
        180, 90, 540, 360, 128, torch.bfloat16, "minsum", 128 * 4)
    assert nbytes == 170_037_248
    s, by = work.bound(nbytes, ops)
    assert by == "bytes" and s == pytest.approx(50.757e-6, rel=1e-4)


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


@pytest.mark.parametrize("mix", ["converging", "noise"])
def test_a_profiled_layered_decode_opens_its_spans(mix, tmp_path):
    """The prior's test and the tail once a decode, a kernel span a call;
    a poll before each call, and one more after the last call when every
    frame is done (a decode that runs to the limit stops on the count)."""
    code = _code()
    dec = _program(code)
    prior, synd = _inputs(code, mix, seed=5)
    it0 = dec.iterations_run
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        success = dec.decode_batched(prior, synd, MAXITER)[0]
    sweeps = dec.iterations_run - it0
    n = _span_counts(prof, tmp_path / "trace.json")
    calls = n["rr.kernel.bp_layered_sweeps_qc"]
    assert calls == -(-sweeps // SPEC["chunk"])
    assert n["rr.decoder.decode"] == n["rr.decoder.precheck"] == 1
    assert n["rr.decoder.tail"] == 1
    if mix == "converging":
        assert bool(success.all()) and sweeps < MAXITER
        assert n["rr.decoder.poll"] == calls + 1
    else:
        assert sweeps == MAXITER and n["rr.decoder.poll"] == calls


def test_without_a_profiler_the_layered_decode_opens_no_span(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    code = _code()
    dec = _program(code)
    prior, synd = _inputs(code, "mixed", seed=6)
    want = dec.decode_batched(prior, synd, MAXITER)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert _same(dec.decode_batched(prior, synd, MAXITER), want)


def test_the_reference_takes_the_minsum_rule_alone():
    with pytest.raises(ValueError, match="min-sum"):
        _reference(_code(), {**SPEC, "check_rule": "sumproduct"})
