"""The readers of the program's own spans (``rr.engine.*``,
``rr.decoder.*``): their arithmetic on hand-placed device and span
intervals, None where their spans are absent (as on a program without
them), and a CPU rehearsal that reads the span count non-null."""

import time

import pytest
import torch

from rrbench import run, spec, tracing
from rrbench.tests import tiny

NEW = ("llr_ms_per_round", "gather2_ms_per_iter", "setup_idle_ms_per_point",
       "round_idle_ms_per_round", "syncs_per_round")
DEVICE = NEW[:4]


def _ev(cat, name, ts, dur, corr=None):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _span(name, a, b):
    return _ev("user_annotation", name, a, b - a)


# kernels (launch, start, end): busy [10, 20], [30, 60], [65, 68], [90, 95]
KERNELS = ((5, 10, 20), (22, 30, 40), (41, 40, 60), (55, 65, 68),
           (74, 90, 95))
SPANS = (("rr.engine.point", 0, 50), ("rr.engine.point", 50, 100),
         # the first set-up starts before the window: clipped to it
         ("rr.engine.setup", -5, 15), ("rr.engine.setup", 50, 70),
         ("rr.engine.round", 20, 45), ("rr.engine.round", 72, 98),
         ("rr.engine.inputs", 21, 25), ("rr.engine.inputs", 73, 75),
         ("rr.decoder.gather2", 40, 44), ("rr.decoder.gather2", 80, 82),
         ("rr.decoder.poll", 44, 45), ("rr.decoder.poll", 96, 97),
         ("rr.engine.read", 49, 50))


def _events(spans=SPANS, kernels=KERNELS):
    ev = [_span(tracing.WINDOW, 0, 100)]
    ev += [_span(*s) for s in spans]
    for corr, (launch, a, b) in enumerate(kernels):
        ev += [_ev("cuda_runtime", "cudaLaunchKernel", launch, 0.5, corr),
               _ev("kernel", f"k{corr}", a, b - a, corr)]
    return ev


def _read(name, events):
    return spec.load_reader(name)(tracing.Run(spans=tracing.Trace(events)))


def test_the_readers_read_what_their_spans_hold():
    ev = _events()
    assert tracing.Trace(ev).busy == [[10, 20], [30, 60], [65, 68], [90, 95]]
    # idle in the set-ups: [0, 10] and [50, 70] less [50, 60], [65, 68];
    # over 2 points
    assert _read("setup_idle_ms_per_point", ev) == pytest.approx(17e-3 / 2)
    # idle in the rounds: [20, 30] and [72, 98] less [90, 95]; 2 rounds
    assert _read("round_idle_ms_per_round", ev) == pytest.approx(31e-3 / 2)
    # kernels launched in the inputs: 10 + 5 us over 2 rounds
    assert _read("llr_ms_per_round", ev) == pytest.approx(15e-3 / 2)
    # one kernel of 20 us launched in the 2 gathers
    assert _read("gather2_ms_per_iter", ev) == pytest.approx(20e-3 / 2)
    # 2 polls and 1 read over 2 rounds
    assert _read("syncs_per_round", ev) == pytest.approx(1.5)


def test_overlapping_spans_of_one_name_count_their_idle_once():
    spans = SPANS + (("rr.engine.setup", 0, 8),)
    assert _read("setup_idle_ms_per_point", _events(spans)) == \
        pytest.approx(17e-3 / 2)


def test_a_device_busy_all_through_leaves_no_idle():
    ev = _events(kernels=((1, 0, 100),))
    assert _read("setup_idle_ms_per_point", ev) == 0.0
    assert _read("round_idle_ms_per_round", ev) == 0.0


@pytest.mark.parametrize("absent, silent", [
    ("rr.engine.round", ("llr_ms_per_round", "round_idle_ms_per_round",
                         "syncs_per_round")),
    ("rr.engine.inputs", ("llr_ms_per_round",)),
    ("rr.decoder.gather2", ("gather2_ms_per_iter",)),
    ("rr.engine.setup", ("setup_idle_ms_per_point",)),
    ("rr.engine.point", ("setup_idle_ms_per_point",)),
])
def test_a_reader_whose_span_is_absent_reads_none(absent, silent):
    ev = _events(tuple(s for s in SPANS if s[0] != absent))
    for name in NEW:
        value = _read(name, ev)
        assert (value is None) == (name in silent), name


def test_a_program_without_spans_and_a_run_without_a_device():
    # the benchmark's own ranges alone, as on a program with no spans
    bench_only = (("rr.round", 20, 45), ("rr.decode", 30, 44))
    for name in NEW:
        assert _read(name, _events(bench_only)) is None, name
        assert spec.load_reader(name)(tracing.Run()) is None, name
    # no device activity: only the span count reads
    ev = _events(kernels=())
    for name in NEW:
        assert (_read(name, ev) is None) == (name in DEVICE), name


@pytest.mark.parametrize("name", ["qc36.soft-3.5dB", "dvbs2.soft-3.5dB"])
def test_a_cpu_rehearsal_reads_the_span_metrics(name, monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(run, "TRACE_MIN_S", 0.02)
    kept = {}
    window = run.Session.window

    def keep(self, *args, **kw):
        kept.update(window(self, *args, **kw))
        return kept
    monkeypatch.setattr(run.Session, "window", keep)
    cell = tiny.cell(name)
    result, _ = run.run_cell(cell, tiny.SEED, 0.3, True, "cpu",
                             t_start=time.perf_counter())
    assert result["correct"] is True
    traced = kept["run"]
    tr = traced.spans
    n = {k: len(v) for k, v in tr.spans.items()}
    R = cell.config["rounds_per_dispatch"]
    rounds = traced.counters["decodes"]
    assert n["rr.engine.round"] == n["rr.engine.inputs"] == rounds
    assert n["rr.engine.read"] * R == rounds
    assert n["rr.engine.point"] == n["rr.engine.setup"] >= 1
    # the QC loop polls once a 12-iteration decode, the generic one once
    # an iteration
    polls = (traced.counters["decode_iterations"]
             if cell.config["decoder"]["kind"] == "generic" else rounds)
    assert n["rr.decoder.poll"] == polls
    assert n.get("rr.decoder.gather2", 0) == (
        polls if cell.config["decoder"]["kind"] == "generic" else 0)
    want = polls / rounds + 1 / R
    assert result["metrics"]["syncs_per_round"]["value"] == \
        pytest.approx(want)
    # the device-time readers need a card
    for m in DEVICE:
        assert m not in result["metrics"]
        assert spec.load_reader(m)(traced) is None
