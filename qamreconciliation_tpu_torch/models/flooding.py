"""The flooding loop of the port's flooding decoders.

``Decoder.decode_batched`` (generic edge lists), ``QCDecoder``'s dense
loop (kernel 1, its stochastically rounded twin and the two-step fallback)
and its compressed min-sum loop all run :func:`flood`.  The two decoders
share one set of steps, which the sharded decoders
(``parallel/graph_shard.py``) override to work on a rank's checks or
lanes:

* ``_local(x)``: the syndrome rows (QC: the lanes of any [..., z, B]
  tensor) updated here;
* ``_check_inputs(total)``: gather 1, the check phase's input t;
* ``_frame_violations(viol)``: [B] violated checks among those updated
  here -> among all;
* ``_variable_side(prior, c2v, t)``: gather 2, ``(total, t)``: the new
  totals and the next t, or None where t must be gathered again;
* ``_tail_consistent(total, synd)``: [B] bool, the syndrome test of the
  last totals;
* ``_whole_finals(final)``: the finals of every lane from those held
  here.

A decoder calls ``_local`` on its inputs and hands :func:`flood` its check
step and its variable side bound to its prior; :func:`flood` calls the
rest.
"""

from __future__ import annotations

import torch

from ..utils.trace import span

__all__ = ["flood"]


def flood(dec, prior, synd, c2v, max_iterations: int, check, variable):
    """Flooding BP until every frame satisfies its syndrome or
    ``max_iterations`` iterations ran, with one host read of "all done?"
    an iteration -> ``(success [B], iters [B] int32, final)``.

    ``prior`` is the first totals; ``check(t, c2v, synd) -> (c2v, viol)``
    the check step (the convergence test of the totals t was gathered from
    and the new messages; ``viol.sum(0)`` counts each frame's violated
    checks); ``variable(c2v, t) -> (total, t)`` the variable step: the new
    totals and the check step's next t, or None, after which t is gathered
    again.  A frame's ``iters`` is the 0-based iteration at which it first
    satisfied its syndrome and ``final`` its totals from that moment;
    failures report ``max_iterations`` and the totals after the last
    iteration.
    """
    maxiter = int(max_iterations)
    B, dev = prior.shape[-1], prior.device
    total = final = prior
    t = None
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    it = 0
    all_done = False
    while it < maxiter and not all_done:
        if t is None:
            with span("rr.decoder.gather1"):
                t = dec._check_inputs(total)
        # convergence of the current totals (after iteration it; at it = 0
        # the test of the prior) and the new messages
        c2v, viol = check(t, c2v, synd)
        conv = dec._frame_violations(viol.sum(0)) == 0
        # the new totals are enqueued before the host reads the poll, so
        # that the card works while the host waits and wakes
        with span("rr.decoder.gather2"):
            new_total, t = variable(c2v, t)
        newly = conv & ~done
        iters = torch.where(newly, it, iters)
        done = done | conv
        # one host read per iteration: skip the snapshot when no frame
        # newly converged, stop when all have
        with span("rr.decoder.poll"):
            any_new, all_done = torch.stack([newly.any(),
                                             done.all()]).tolist()
        if any_new:
            final = torch.where(newly, total, final)
        total = new_total
        it += 1
        dec.iterations_run += 1

    # frames that converged at the last allowed iteration exit the loop
    # untested: one final syndrome test covers them
    with span("rr.decoder.tail"):
        conv = dec._tail_consistent(total, synd)
        newly = conv & ~done
        iters = torch.where(newly, min(it, maxiter), iters)
        final = torch.where(newly, total, final)
        done = done | conv
        iters = torch.where(done, iters, maxiter)
        # failures: the totals at max_iterations
        final = dec._whole_finals(torch.where(done, final, total))
    return done, iters, final
