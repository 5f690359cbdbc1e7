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
    an iteration, taken one iteration late -> ``(success [B], iters [B]
    int32, final)``.

    ``prior`` is the first totals; ``check(t, c2v, synd) -> (c2v, viol)``
    the check step (the convergence test of the totals t was gathered from
    and the new messages; ``viol.sum(0)`` counts each frame's violated
    checks); ``variable(c2v, t) -> (total, t)`` the variable step: fresh
    new totals (never written over the old ones, which the late read may
    still take as finals) and the check step's next t, or None, after
    which t is gathered again.  A frame's ``iters`` is the 0-based
    iteration at which it first satisfied its syndrome and ``final`` its
    totals from that moment; failures report ``max_iterations`` and the
    totals after the last iteration.

    Iteration j's count of frames done is copied to the host without a
    wait and read once iteration j + 1 is enqueued, so the device never
    runs dry at a read: a count above the last one read means frames
    newly converged at j, a count of every frame that all are done.  A
    decode whose frames all converge early runs one iteration more than it
    needs (``dec.overrun_iterations``), which changes nothing it returns;
    ``dec.polls_waited`` counts the reads whose count had not yet reached
    the host.
    """
    maxiter = int(max_iterations)
    B, dev = prior.shape[-1], prior.device
    total = final = prior
    t = None
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    # two host slots for the counts, used in turn; on the card each is
    # pinned and its copy followed by an event, on the CPU a plain copy
    on_card = dev.type == "cuda"
    counts = [torch.empty((), dtype=torch.int64, pin_memory=on_card)
              for _ in range(2)]
    if on_card:
        stream = torch.cuda.current_stream(dev)
        copied = [torch.cuda.Event(), torch.cuda.Event()]
    else:
        copied = None
    # the iteration enqueued but not read: (slot, newly, the totals it
    # tested), so that its read can snapshot the finals; frames done at
    # the last iteration read
    pending = None
    seen = 0
    it = 0
    while it < maxiter:
        if t is None:
            with span("rr.decoder.gather1"):
                t = dec._check_inputs(total)
        # convergence of the current totals (after iteration it; at it = 0
        # the test of the prior) and the new messages
        c2v, viol = check(t, c2v, synd)
        conv = dec._frame_violations(viol.sum(0)) == 0
        with span("rr.decoder.gather2"):
            new_total, t = variable(c2v, t)
        newly = conv & ~done
        iters = torch.where(newly, it, iters)
        done = done | conv
        slot = it % 2
        counts[slot].copy_(done.sum(), non_blocking=True)
        if on_card:
            copied[slot].record(stream)
        last, pending = pending, (slot, newly, total)
        it += 1
        dec.iterations_run += 1
        if last is not None:
            final, seen = _read(dec, counts, copied, last, final, seen)
            if seen == B:
                # this iteration ran after every frame was done: its
                # totals are dropped, and its read below changes nothing
                dec.overrun_iterations += 1
                break
        total = new_total
    if pending is not None:
        final, _ = _read(dec, counts, copied, pending, final, seen)

    # frames that converged at the last allowed iteration exit the loop
    # untested: one final syndrome test covers them (none where every frame
    # was done)
    with span("rr.decoder.tail"):
        conv = dec._tail_consistent(total, synd)
        newly = conv & ~done
        iters = torch.where(newly, maxiter, iters)
        final = torch.where(newly, total, final)
        done = done | conv
        iters = torch.where(done, iters, maxiter)
        # failures: the totals at max_iterations
        final = dec._whole_finals(torch.where(done, final, total))
    return done, iters, final


def _read(dec, counts, copied, pending, final, seen):
    """The host read of an enqueued iteration's count of frames done ->
    ``(final, count)``, ``final`` with the totals the iteration tested
    taken for its newly converged frames where the count rose above
    ``seen``, the count last read."""
    slot, newly, tested = pending
    with span("rr.decoder.poll"):
        if copied is not None and not copied[slot].query():
            dec.polls_waited += 1
            copied[slot].synchronize()
        count = int(counts[slot])
    if count > seen:
        final = torch.where(newly, tested, final)
    return final, count
