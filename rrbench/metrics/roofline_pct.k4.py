"""Kernel 4 (``bp_check_phase_generic``): percent of its roofline, the
least time its calls' work needs (``rrbench/work.py``: each call's inputs
and outputs once and every slot's operations) over the device time of the
work launched inside its calls (``rr.k.check_phase``)."""

from rrbench import work


def read(run):
    calls = [c for c in run.calls if c["hook"] == "check_phase"]
    tr = run.spans
    if tr is None or not tr.has_device or not calls:
        return None
    seconds = tr.device_s("rr.k.check_phase")
    if seconds <= 0:
        return None
    nbytes = ops = 0
    for c in calls:
        b, o = work.check_phase_generic_work(*c["shape"], c["m_dtype"],
                                             c["rule"])
        nbytes, ops = nbytes + b, ops + o
    return 100.0 * work.bound(nbytes, ops)[0] / seconds
