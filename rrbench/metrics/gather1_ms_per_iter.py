"""Device ms an iteration of a decoder's gather 1: the device time of the
work launched inside the program's ``rr.decoder.gather1`` spans (the dense
QC loop's ``_check_inputs``: the totals and a +1e30 pad row gathered by
the circulant index into the check layout [nb_c, dc, z, B]) over their
count, one an iteration."""


def read(run):
    tr = run.spans
    if tr is None or not tr.has_device:
        return None
    n = len(tr.spans.get("rr.decoder.gather1", []))
    if not n:
        return None
    return 1e3 * tr.device_s("rr.decoder.gather1") / n
