"""Host waits on the device a round: the program's ``rr.decoder.poll``
spans (each host read of a decode loop's "all done?") and
``rr.engine.read`` spans (each host read of a dispatch's counters) over
its ``rr.engine.round`` spans, in the spans' stretch."""


def read(run):
    tr = run.spans
    if tr is None:
        return None
    rounds = len(tr.spans.get("rr.engine.round", []))
    if not rounds:
        return None
    syncs = sum(len(tr.spans.get(n, []))
                for n in ("rr.decoder.poll", "rr.engine.read"))
    return syncs / rounds
