"""Mean host ms of a sweep point's set-up: the engine's ``mode_noisemapper``
(the point's NoiseMapper, its LLR fit and their upload), host clock, over
the traced run's window points."""


def read(run):
    spans = run.host.get("point_setup")
    return 1e3 * sum(spans) / len(spans) if spans else None
