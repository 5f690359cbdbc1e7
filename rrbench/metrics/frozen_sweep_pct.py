"""Kernel 3 (``bp_layered_sweeps_qc``): percent of the (frame, sweep)
pairs its calls ran that went to frames already done, which a decode
carries to its slowest frame: ``100 * (1 - sum frame_sweeps / sum B *
n)`` over the traced calls (``rrbench/decoders/qc_layered.py``'s call
records: the batch ``B``, the sweeps ``n`` a call ran and the pairs of
frames not done at a sweep's start)."""


def read(run):
    calls = [c for c in run.calls
             if c.get("kernel") == "bp_layered_sweeps_qc"]
    run_pairs = sum(c["dims"][-1] * c["sweeps"] for c in calls)
    if not run_pairs:
        return None
    live = sum(int(c["frame_sweeps"]) for c in calls)
    return 100.0 * (1.0 - live / run_pairs)
