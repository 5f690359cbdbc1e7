"""The port's named spans (``utils/trace.span``): absent, and free of
``record_function``, while no profiler runs; under a CPU profiler one of
each at its place, in the counts and nesting the span readers rely on; and
a point's result the same either way."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc)
from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine
from qamreconciliation_tpu_torch.utils import trace

# the benchmark's tiny cells: a QC (3,6) code of N = 384, 8 frames a round,
# 2 rounds a dispatch, 12 iterations at most, 32 frames a point
Z, BATCH, R, MAXITER, FRAMES = 16, 8, 2, 12, 32
ROUNDS = FRAMES // BATCH
SEED = 2 ** 31 + 123

DECODERS = {
    "qc_resident": dict(resident=True, resident_chunk=50,
                        resident_phi="tanhfb"),
    "qc_dense": dict(check_phi="tanhfb"),
    "qc_compressed": dict(check_rule="minsum", compressed=True),
    "qc_layered": dict(schedule="layered", layered_chunk=4),
    "qc_resident_layered": dict(schedule="layered", layered_chunk=4,
                                resident=True),
    # the benchmark's qc36.layered-4.0dB decoder
    "qc_resident_layered_minsum": dict(schedule="layered", layered_chunk=4,
                                       resident=True, check_rule="minsum"),
    "generic": None,
}
KERNELS = {"qc_resident": ("bp_decode_rounds_qc",),
           "qc_dense": ("bp_check_phase_qc", "bp_var_pass_qc"),
           "qc_resident_layered": ("bp_layered_sweeps_qc",),
           "qc_resident_layered_minsum": ("bp_layered_sweeps_qc",),
           "generic": ("bp_check_phase_generic", "bp_var_totals_generic")}


def _engine(kind):
    torch.set_num_threads(1)
    base, vid, cid = make_qc_ldpc(24, Z, 3, 6, seed=5)
    kw = DECODERS[kind]
    if kw is None:
        dec = Decoder(vid, cid, "bfloat16", device="cpu",
                      check_rule="sumproduct", check_phi="tanhfb")
    else:
        kw = dict(kw)
        rule = kw.pop("check_rule", "sumproduct")
        dec = QCDecoder(base, Z, "bfloat16", device="cpu", check_rule=rule,
                        **kw)
    return ReconciliationEngine(dec, Matrix(vid, cid), PAMAlphabet(2, 2.0),
                                batch=BATCH, dtype="bfloat16",
                                rounds_per_dispatch=R)


def _point(eng, mode="softening", frames=FRAMES):
    return eng.run_point(mode, 3.5, MAXITER, frames, frames + 1,
                         nmconfig=[0, 0, 0, 0], seed=SEED)


def _spans(prof, path):
    """{name: sorted [(start, end)]} of the profile's ``rr.`` ranges, read
    from its chrome trace (``prof.events()`` takes seconds to build)."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for ev in events:
        name = ev.get("name", "")
        if ev.get("ph") == "X" and name.startswith("rr."):
            out.setdefault(name, []).append(
                (ev["ts"], ev["ts"] + ev["dur"]))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer):
    return all(any(a <= s and e <= b for a, b in outer) for s, e in inner)


@pytest.mark.parametrize("kind", ["qc_resident", "generic"])
def test_without_a_profiler_no_span_is_made(kind, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("rr.engine.point") is trace.span("rr.engine.round")
    res = _point(_engine(kind))
    assert res.frames == FRAMES


@pytest.mark.parametrize("kind", list(DECODERS))
def test_a_profiled_point_opens_each_span_in_its_place(kind, tmp_path):
    eng = _engine(kind)
    dec = eng.dec
    # the plain layered sweeps make ~10^5 profiled operations a point: one
    # dispatch of them
    frames = BATCH * R if "layered" in kind else FRAMES
    rounds = frames // BATCH
    it0 = dec.iterations_run
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _point(eng, frames=frames)
    iters = dec.iterations_run - it0
    spans = _spans(prof, tmp_path / "trace.json")
    n = {k: len(v) for k, v in spans.items()}
    assert res.frames == frames and iters > 0
    assert n["rr.engine.point"] == n["rr.engine.setup"] == 1
    for name in ("rr.engine.round", "rr.engine.sample", "rr.engine.inputs",
                 "rr.engine.syndrome", "rr.engine.count",
                 "rr.decoder.decode"):
        assert n[name] == rounds, name
    # the flooding and resident loops end in a tail, the plain layered one
    # not; the resident layered one tests the prior before its sweeps
    assert n.get("rr.decoder.tail", 0) == (0 if kind == "qc_layered"
                                           else rounds)
    assert n.get("rr.decoder.precheck", 0) == (
        rounds if kind.startswith("qc_resident_layered") else 0)
    assert n["rr.engine.dispatch"] == n["rr.engine.read"] == rounds // R
    assert n["rr.decoder.poll"] >= rounds
    if kind in ("generic", "qc_dense", "qc_compressed"):
        # the flooding loops, with gather 2 and a poll an iteration; the
        # generic and compressed ones gather their check input every
        # iteration, the dense one once a decode (its variable pass writes
        # the next)
        assert n["rr.decoder.gather2"] == n["rr.decoder.poll"] == iters
        assert n["rr.decoder.gather1"] == (rounds if kind == "qc_dense"
                                           else iters)
    else:
        assert "rr.decoder.gather2" not in n
    if kind in ("generic", "qc_dense"):
        # gather 2 is one fold call an iteration
        fold = ("bp_var_totals_generic" if kind == "generic"
                else "bp_var_pass_qc")
        assert n[f"rr.kernel.{fold}"] == iters
        assert _inside(spans[f"rr.kernel.{fold}"],
                       spans["rr.decoder.gather2"])
    if kind == "qc_resident":
        # chunk 50 > 12 iterations: one kernel call and one poll a decode
        assert n["rr.kernel.bp_decode_rounds_qc"] == rounds
        assert n["rr.decoder.poll"] == rounds
    if kind.startswith("qc_resident_layered"):
        # a poll before each call, and one after a decode's last call when
        # every frame is done
        calls = n["rr.kernel.bp_layered_sweeps_qc"]
        assert calls <= n["rr.decoder.poll"] <= calls + rounds
    # the softening inputs: one kernel call a round, inside its inputs
    assert n["rr.kernel.softening_inputs"] == rounds
    assert _inside(spans["rr.kernel.softening_inputs"],
                   spans["rr.engine.inputs"])
    kernels = sorted(k for k in n if k.startswith("rr.kernel.")
                     and k != "rr.kernel.softening_inputs")
    assert kernels == sorted(f"rr.kernel.{k}" for k in KERNELS.get(kind, ()))
    assert _inside(spans["rr.engine.setup"], spans["rr.engine.point"])
    assert _inside(spans["rr.engine.round"], spans["rr.engine.dispatch"])
    for name in ("rr.engine.sample", "rr.engine.inputs",
                 "rr.engine.syndrome", "rr.decoder.decode",
                 "rr.engine.count"):
        assert _inside(spans[name], spans["rr.engine.round"]), name
    for name in kernels + ["rr.decoder.poll", "rr.decoder.gather1",
                           "rr.decoder.gather2", "rr.decoder.precheck",
                           "rr.decoder.tail"]:
        assert _inside(spans.get(name, []), spans["rr.decoder.decode"]), name
    assert not _inside(spans["rr.engine.read"], spans["rr.engine.dispatch"])
    assert _inside(spans["rr.engine.read"], spans["rr.engine.point"])


def test_a_profiled_grid_opens_one_point_span(tmp_path):
    eng = _engine("qc_resident")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = eng.run_sweep_batched("hard", [3.0, 3.5], MAXITER, FRAMES,
                                    FRAMES + 1, seed=SEED)
    n = {k: len(v) for k, v in _spans(prof, tmp_path / "t.json").items()}
    assert [r.frames for r in res] == [FRAMES, FRAMES]
    assert n["rr.engine.point"] == 1 and n["rr.engine.setup"] == 2
    assert n["rr.engine.dispatch"] == n["rr.engine.read"] == ROUNDS // R
    assert n["rr.engine.inputs"] == 2 * ROUNDS
    assert n["rr.decoder.decode"] == ROUNDS


@pytest.mark.parametrize("mode", ["softening", "hard"])
@pytest.mark.parametrize("kind", ["qc_resident", "generic"])
def test_a_point_is_the_same_with_and_without_the_profiler(kind, mode):
    plain = _point(_engine(kind), mode)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _point(_engine(kind), mode)
    assert traced.as_tuple() == plain.as_tuple()
    assert (traced.frames, traced.bp_iterations) == (plain.frames,
                                                     plain.bp_iterations)
