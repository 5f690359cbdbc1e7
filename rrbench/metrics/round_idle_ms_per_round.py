"""Device-idle ms a round: the time of the spans' window in which no
kernel, copy or set runs on the device and the host is inside the
program's ``rr.engine.round`` span (the preamble's and the decode's
launches, the decoder's host reads of "all done?"), over the spans'
rounds.  As ``setup_idle_ms_per_point``, a reading of the traced, slower
host: compare two commits on one machine."""

from rrbench.metrics.setup_idle_ms_per_point import idle_s_in


def read(run):
    tr = run.spans
    if tr is None or not tr.has_device:
        return None
    rounds = len(tr.spans.get("rr.engine.round", []))
    if not rounds:
        return None
    return 1e3 * idle_s_in(tr, "rr.engine.round") / rounds
