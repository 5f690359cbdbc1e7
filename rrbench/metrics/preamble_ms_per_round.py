"""Device ms a round of the preamble: the device time of the work launched
inside a round (``rr.round``, the engine's ``round``: sampling, hard
decision, softening metric or bare LLRs, word, LLRs) before its decode
(``rr.decode``) opens, over the spans' rounds."""


def read(run):
    tr, rounds = run.spans, run.counters.get("decodes", 0)
    if tr is None or not tr.has_device or not rounds:
        return None
    return 1e3 * tr.device_s_before("rr.round", "rr.decode") / rounds
