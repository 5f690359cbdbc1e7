"""The benchmark's hooks on the program fail loudly at set-up where the
program's structure no longer matches them, and the trace readers that
split a round and take the idle share read what they say."""

import pytest
import torch

from rrbench import run, spec, tracing
from rrbench.tests import tiny


def _session(name, trace=False):
    torch.set_num_threads(1)
    return run.Session(tiny.cell(name), tiny.SEED, "cpu", trace=trace)


def test_a_hooked_attribute_that_is_gone_stops_the_set_up(monkeypatch):
    from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine
    monkeypatch.delattr(ReconciliationEngine, "round_inputs")
    with pytest.raises(run.HookError, match="round_inputs"):
        _session(tiny.WORKLOADS[0])


def test_a_hook_the_round_no_longer_calls_stops_the_set_up(monkeypatch):
    from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine

    def fused(self, mode, nm, sigma, alpha, max_iterations, generator=None,
              xy=None):
        # the class's round_inputs, not the instance's: the hook is bypassed
        x, y = self._sample_sb(generator, sigma)
        lappr, word = ReconciliationEngine.round_inputs(
            self, mode, nm, x, y, sigma, alpha)
        return self._decode_and_count_nb(lappr, word, max_iterations)
    monkeypatch.setattr(ReconciliationEngine, "round", fused)
    with pytest.raises(run.HookError, match="round_inputs: 0 calls"):
        _session(tiny.WORKLOADS[0])


def test_a_decode_built_before_the_hooks_stops_the_set_up(monkeypatch):
    from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine
    real_init = ReconciliationEngine.__init__
    real_count = ReconciliationEngine._decode_and_count_nb

    def init(self, dec, *args, **kw):
        real_init(self, dec, *args, **kw)
        self.decode_fn = dec._build_decode()     # built once, up front

    def count(self, lappr, word, max_iterations, points=None):
        dec = self.dec
        dec._build_decode = lambda: self.decode_fn
        try:
            return real_count(self, lappr, word, max_iterations, points)
        finally:
            del dec._build_decode
    monkeypatch.setattr(ReconciliationEngine, "__init__", init)
    monkeypatch.setattr(ReconciliationEngine, "_decode_and_count_nb", count)
    with pytest.raises(run.HookError, match="decode: 0 calls"):
        _session(tiny.WORKLOADS[0])


@pytest.mark.parametrize("name", tiny.WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_the_hooks_hold_on_the_program_as_it_is(name, trace):
    session = _session(name, trace)
    calls = dict(session.recorder.calls_of)
    R = session.cell.config["rounds_per_dispatch"]
    assert calls["round"] == calls["round_inputs"] == calls["decode"] == R
    assert calls["point_setup"] == 1
    assert (calls.get("kernel", 0) >= R) == trace




def _ev(cat, name, ts, dur, corr=None):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _round_events():
    """Two rounds: 3 us of preamble kernels, then a decode of 10 us, then
    a count kernel of 1 us launched after the decode closed."""
    ev = [_ev("user_annotation", tracing.WINDOW, 0, 100)]
    corr = 0
    for base in (0, 50):
        ev += [_ev("user_annotation", "rr.round", base + 1, 40),
               _ev("user_annotation", "rr.decode", base + 10, 20)]
        for launch, start, dur in ((base + 2, base + 3, 1),
                                   (base + 4, base + 5, 2),
                                   (base + 11, base + 12, 10),
                                   (base + 31, base + 32, 1)):
            corr += 1
            ev += [_ev("cuda_runtime", "cudaLaunchKernel", launch, 0.5,
                       corr),
                   _ev("kernel", f"k{corr % 4}", start, dur, corr)]
    return ev


def test_the_preamble_is_the_rounds_work_before_its_decode():
    run_ = tracing.Run(spans=tracing.Trace(_round_events()),
                       counters={"decodes": 2, "decode_iterations": 4})
    assert run_.spans.device_s_before("rr.round", "rr.decode") == \
        pytest.approx(6e-6)
    assert spec.load_reader("preamble_ms_per_round")(run_) == \
        pytest.approx(3e-3)
    assert spec.load_reader("decode_ms_per_iter")(run_) == \
        pytest.approx(5e-3)


def test_the_idle_share_is_over_the_untraced_points():
    read = spec.load_reader("device_idle_pct")
    events = [e for e in _round_events()
              if e["cat"] not in ("user_annotation",)]
    device = tracing.Trace(events, window_s=90e-6)
    assert device.busy_s == pytest.approx(28e-6)
    assert device.window_s == 90e-6
    run_ = tracing.Run(device=device,
                       host={"untraced_point": [40e-6, 40e-6]})
    assert read(run_) == pytest.approx(100.0 * (1 - 28 / 80))
    assert read(tracing.Run(device=device)) is None
    assert read(tracing.Run(host={"untraced_point": [1.0]})) is None
