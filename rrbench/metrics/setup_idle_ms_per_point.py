"""Device-idle ms a point while the host builds the point's set-up: the
time of the spans' window in which no kernel, copy or set runs on the
device and the host is inside the program's ``rr.engine.setup`` span (the
engine's ``mode_noisemapper``: the NoiseMapper, its fit and upload), over
the window's points (``rr.engine.point``).  The spans' stretch records
the host's operations, which slow the host: a reading compares two
commits on one machine, not with an untraced run."""


def idle_s_in(tr, name):
    """Seconds of ``tr``'s window in which the device is idle and the host
    is inside a ``name`` span."""
    spans = []
    for a, b in tr.spans.get(name, []):
        a, b = max(a, tr.t0), min(b, tr.t1)
        if b <= a:
            continue
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    busy, k, idle = tr.busy, 0, 0.0
    for a, b in spans:
        while k < len(busy) and busy[k][1] <= a:
            k += 1
        covered, j = 0.0, k
        while j < len(busy) and busy[j][0] < b:
            covered += min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
        idle += (b - a) - covered
    return idle * 1e-6


def read(run):
    tr = run.spans
    if tr is None or not tr.has_device:
        return None
    points = len(tr.spans.get("rr.engine.point", []))
    if not points or "rr.engine.setup" not in tr.spans:
        return None
    return 1e3 * idle_s_in(tr, "rr.engine.setup") / points
