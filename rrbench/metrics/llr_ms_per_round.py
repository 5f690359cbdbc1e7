"""Device ms a round of the LLRs and the word: the device time of the work
launched inside the program's ``rr.engine.inputs`` span (the engine's
``round_inputs``: hard decision, softening metric or bare LLRs, word) over
the spans' rounds (``rr.engine.round``)."""


def read(run):
    tr = run.spans
    if tr is None or not tr.has_device:
        return None
    rounds = len(tr.spans.get("rr.engine.round", []))
    if not rounds or "rr.engine.inputs" not in tr.spans:
        return None
    return 1e3 * tr.device_s("rr.engine.inputs") / rounds
