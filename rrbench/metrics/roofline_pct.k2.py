"""Kernel 2 (``bp_decode_rounds_qc``): percent of its roofline, the least
time its work needs (``rrbench/work.py``: each call's state in and out
once, the operations of each (frame, step) pair the call ran) over the
device time of the work launched inside its calls (``rr.k.rounds_step``:
the state's copies in and out and the steps)."""

from rrbench import work


def read(run):
    calls = [c for c in run.calls if c["hook"] == "rounds_step"]
    tr = run.spans
    if tr is None or not tr.has_device or not calls:
        return None
    seconds = tr.device_s("rr.k.rounds_step")
    if seconds <= 0:
        return None
    nbytes = ops = 0
    for c in calls:
        b, o = work.decode_rounds_work(*c["dims"], c["total_dtype"],
                                       c["m_dtype"], c["rule"],
                                       int(c["frame_steps"]))
        nbytes, ops = nbytes + b, ops + o
    return 100.0 * work.bound(nbytes, ops)[0] / seconds
