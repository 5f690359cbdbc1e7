"""Device ms an iteration of the generic decoder's gather 2: the device
time of the work launched inside the program's ``rr.decoder.gather2``
spans (``Decoder.var_totals``: each variable's incoming messages gathered,
masked and folded, plus the prior) over their count, one an iteration."""


def read(run):
    tr = run.spans
    if tr is None or not tr.has_device:
        return None
    n = len(tr.spans.get("rr.decoder.gather2", []))
    if not n:
        return None
    return 1e3 * tr.device_s("rr.decoder.gather2") / n
