"""Named spans of the port's layers, on the profiler's clock.

``span(name)`` opens a ``torch.profiler.record_function`` range while a
torch profiler runs (``sims/common.profiled``, ``--profile-dir``, or any
``torch.profiler.profile`` around the call) and does nothing otherwise:
an idle ``record_function`` still costs its operator call, ~12 us on a
host core, where the check costs under 1 us, and a DVB-S2 sweep point
opens ~6,700 spans.  The spans carry no ids: a span's parent is the span
that holds it on the host thread, and its point the ``rr.engine.point``
around it.  Names are fixed, so that a reader can count and sum them:

* ``rr.engine.point``, ``rr.engine.setup`` (the point's NoiseMapper),
  ``rr.engine.dispatch`` (the launches of R rounds), ``rr.engine.read`` (the
  host read of a dispatch's counters), ``rr.engine.round`` and in it
  ``rr.engine.sample``, ``rr.engine.inputs``, ``rr.engine.syndrome`` and
  ``rr.engine.count``;
* ``rr.decoder.decode`` and in it ``rr.decoder.poll`` (each host read of
  "all done?"), ``rr.decoder.gather1``, ``rr.decoder.gather2`` (in the
  flooding loops, ``models/flooding.flood``: the totals to the check
  layout, the messages folded back with the prior),
  ``rr.decoder.precheck`` (the resident layered loop's test of the prior
  before its first sweep) and ``rr.decoder.tail`` (the bookkeeping after
  the loop: the flooding and resident loops' consistency test, the
  resident layered loop's ``done`` and ``iters``);
* ``rr.kernel.<entry>``: each call of a decoder kernel's entry in
  ``ops/kernels.py``.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager: the profiler range ``name`` while a torch
    profiler runs, else one shared null context."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF
