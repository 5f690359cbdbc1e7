"""Kernel 1 (``bp_check_phase_qc``): percent of its roofline, the least
time its calls' work needs (``rrbench/decoders/qc_dense.py``: each call's
inputs and outputs once and every slot's operations) over the device time
of the work launched inside its calls (``rr.k.check_phase``)."""

from rrbench import work
from rrbench.decoders.qc_dense import check_phase_qc_work


def read(run):
    calls = [c for c in run.calls if c.get("kernel") == "bp_check_phase_qc"]
    tr = run.spans
    if tr is None or not tr.has_device or not calls:
        return None
    seconds = tr.device_s("rr.k.check_phase")
    if seconds <= 0:
        return None
    nbytes = ops = 0
    for c in calls:
        b, o = check_phase_qc_work(*c["shape"], c["t_dtype"], c["m_dtype"],
                                   c["rule"])
        nbytes, ops = nbytes + b, ops + o
    return 100.0 * work.bound(nbytes, ops)[0] / seconds
