"""Device ms a BP iteration of a batch: the device time of the work
launched inside ``rr.decode`` (the decoder's ``_build_decode()`` call) over
the decoder's ``iterations_run`` delta in the spans' rounds."""


def read(run):
    tr, iters = run.spans, run.counters.get("decode_iterations", 0)
    if tr is None or not tr.has_device or not iters:
        return None
    return 1e3 * tr.device_s("rr.decode") / iters
