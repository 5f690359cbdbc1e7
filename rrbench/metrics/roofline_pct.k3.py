"""Kernel 3 (``bp_layered_sweeps_qc``): percent of its roofline, the least
time its calls' work needs (``rrbench/decoders/qc_layered.py``: each
call's state in and out once, the operations of each (frame, sweep) pair
of a frame not yet done) over the device time of the work launched inside
its calls (``rr.k.sweeps_step``: the state's copies in and out and the
sweeps)."""

from rrbench import work
from rrbench.decoders.qc_layered import layered_sweeps_work


def read(run):
    calls = [c for c in run.calls
             if c.get("kernel") == "bp_layered_sweeps_qc"]
    tr = run.spans
    if tr is None or not tr.has_device or not calls:
        return None
    seconds = tr.device_s("rr.k.sweeps_step")
    if seconds <= 0:
        return None
    nbytes = ops = 0
    for c in calls:
        b, o = layered_sweeps_work(*c["dims"], c["m_dtype"], c["rule"],
                                   int(c["frame_sweeps"]))
        nbytes, ops = nbytes + b, ops + o
    return 100.0 * work.bound(nbytes, ops)[0] / seconds
