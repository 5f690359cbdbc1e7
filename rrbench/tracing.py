"""What a traced run leaves for the per-layer metrics' readers.

A traced run profiles two stretches of its window with ``torch.profiler``
(:class:`Run`).  The first records the device's activity alone (CUDA
activity, no host operations), so that the host keeps close to its
untraced pace: the device's busy time (the union of its kernels, copies
and sets), the time of each kernel by name and the idle gaps by the
runtime call the host was in.  The second also records the host's
operations and the benchmark's spans, ``record_function`` ranges named
``rr.<layer>`` around its calls into the program: the device time of the
work launched inside each span (a device event counts for every span
whose host range holds its launch).  Readers under ``rrbench/metrics/``
take their numbers from these, from the counters and kernel calls the run
recorded over the second stretch, and from host-clock durations.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "rr.window"
TOP = 10
SHORT_GAP_US = 20.0


def chrome_events(prof):
    """The profiler's events, through its chrome trace written to (and
    removed from) a temporary file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Run:
    """A traced run: ``device`` and ``spans``, the :class:`Trace` of its
    two stretches (None where a stretch was not recorded: the device-only
    one needs a card); ``counters`` and ``calls`` recorded over the spans'
    stretch; ``host`` host-clock seconds (``point_setup`` over the window's
    points, ``untraced_point`` of the device stretch's points run
    untraced)."""

    def __init__(self, device=None, spans=None, counters=None, calls=None,
                 host=None):
        self.device, self.spans = device, spans
        self.counters = dict(counters or {})
        self.calls = list(calls or [])
        self.host = {k: list(v) for k, v in (host or {}).items()}


class Trace:
    """One profiled stretch: ``events`` from :func:`chrome_events`.  Its
    window is the ``rr.window`` range where the stretch has one, else the
    extent of its events, ``window_s`` long where that is given (the
    host clock's)."""

    def __init__(self, events, window_s=None):
        spans = defaultdict(list)
        launch = {}
        device = []
        host_ops = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            name = str(ev.get("name", ""))
            corr = (ev.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                device.append((ts, ts + dur, name, corr))
            elif cat.startswith("cuda_"):      # runtime and API launches
                if corr is not None:
                    launch[corr] = ts
                host_ops.append((ts, ts + dur, name))
            elif cat == "user_annotation" and name.startswith("rr."):
                spans[name].append((ts, ts + dur))
            elif cat == "cpu_op":
                host_ops.append((ts, ts + dur, name))
        self.spans = {k: sorted(v) for k, v in spans.items()}
        win = self.spans.get(WINDOW)
        if win:
            self.t0, self.t1 = win[0][0], win[-1][1]
        else:
            ends = [(a, b) for a, b, _ in host_ops] + [
                (a, b) for a, b, _, _ in device]
            if not ends:
                raise ValueError(f"the trace has no {WINDOW} range and no "
                                 f"events")
            self.t0 = min(a for a, _ in ends)
            self.t1 = max(b for _, b in ends)
        self.window_s = (window_s if window_s is not None
                         else (self.t1 - self.t0) * 1e-6)
        self.device = [(max(a, self.t0), min(b, self.t1), n, c)
                       for a, b, n, c in device
                       if b > self.t0 and a < self.t1]
        self.busy = _union([(a, b) for a, b, _, _ in self.device])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        self.has_device = bool(self.device)
        self._launch = launch
        self._host_ops = sorted(host_ops)

    def _in_span(self, name, t):
        iv = self.spans.get(name, [])
        k = bisect.bisect_right(iv, (t, float("inf"))) - 1
        return k >= 0 and iv[k][0] <= t <= iv[k][1]

    def device_s(self, span: str) -> float:
        """Seconds of device activity launched inside ``span``."""
        total = 0.0
        for a, b, _, corr in self.device:
            t = self._launch.get(corr)
            if t is not None and self._in_span(span, t):
                total += b - a
        return total * 1e-6

    def device_s_before(self, outer: str, inner: str) -> float:
        """Seconds of device activity launched inside an ``outer`` range
        before the first ``inner`` range that it holds opens."""
        outer_iv = self.spans.get(outer, [])
        starts = [a for a, _ in self.spans.get(inner, [])]
        cut = []
        for a, b in outer_iv:
            k = bisect.bisect_left(starts, a)
            cut.append(starts[k] if k < len(starts) and starts[k] <= b
                       else b)
        total = 0.0
        for a, b, _, corr in self.device:
            t = self._launch.get(corr)
            if t is None:
                continue
            k = bisect.bisect_right(outer_iv, (t, float("inf"))) - 1
            if k >= 0 and outer_iv[k][0] <= t < cut[k]:
                total += b - a
        return total * 1e-6

    def kernel_s(self):
        """{name: seconds} of the device activity in the window."""
        out = defaultdict(float)
        for a, b, name, _ in self.device:
            out[name] += (b - a) * 1e-6
        return dict(out)

    def _host_label(self, t):
        """The innermost benchmark span and host operation around ``t``."""
        inner = None
        for name, iv in self.spans.items():
            k = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if name != WINDOW and k >= 0 and iv[k][0] <= t <= iv[k][1]:
                if inner is None or iv[k][1] - iv[k][0] < inner[0]:
                    inner = (iv[k][1] - iv[k][0], name)
        k = bisect.bisect_right(self._host_ops, (t, float("inf"), "")) - 1
        op = None
        for a, b, name in self._host_ops[max(0, k - 64):k + 1][::-1]:
            if a <= t <= b:
                op = name
                break
        return "/".join(x for x in (inner and inner[1], op) if x) or "host"

    def idle_gaps(self):
        """[[host activity, seconds]]: the device's idle time in the window
        summed by what the host was doing when each gap began (gaps under
        ``SHORT_GAP_US`` summed as one entry), the most first."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        out = defaultdict(float)
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            if b <= a:
                continue
            label = (self._host_label(a) if b - a >= SHORT_GAP_US
                     else f"gaps under {SHORT_GAP_US:g} us")
            out[label] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in out.items()),
                      key=lambda kv: -kv[1])[:TOP]

    def breakdown(self):
        ops = sorted(([k, v] for k, v in self.kernel_s().items()),
                     key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": ops, "idle_gaps": self.idle_gaps()}
