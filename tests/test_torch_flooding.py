"""The flooding loop's contract (``models/flooding.flood``) in every
flooding decoder: one poll an iteration run, each iteration's read taken
after the next iteration's variable step is enqueued, gather 1 once a
decode where the variable pass writes the next t and every iteration
elsewhere, ``iterations_run`` the iterations run (one past the last
convergence where every frame converges early, ``overrun_iterations``),
and the results of a loop that reads every iteration at its end."""

import contextlib

import pytest
import torch

from qamreconciliation_tpu_torch.models import decoder as decoder_mod
from qamreconciliation_tpu_torch.models import flooding
from qamreconciliation_tpu_torch.models import qc_decoder as qc_decoder_mod
from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc)

Z, B = 16, 8
BASE, VID, CID = make_qc_ldpc(24, Z, 3, 6, seed=5)

# (decoder, gathers its check input once a decode)
CASES = {
    "generic": (lambda: Decoder(VID, CID, "float32", device="cpu"), False),
    "dense-f32": (lambda: QCDecoder(BASE, Z, "float32", device="cpu"), True),
    "dense-bf16": (lambda: QCDecoder(BASE, Z, "bfloat16", device="cpu"),
                   True),
    "dense-f32-totals-over-bf16": (
        lambda: QCDecoder(BASE, Z, "bfloat16", device="cpu",
                          totals_dtype="float32"), False),
    "sr-messages": (
        lambda: QCDecoder(BASE, Z, "bfloat16", device="cpu",
                          check_phi="tanhfb", sr_messages=True), False),
    "compressed": (
        lambda: QCDecoder(BASE, Z, "float32", device="cpu",
                          check_rule="minsum", compressed=True), False),
}
GATHER1, GATHER2 = "rr.decoder.gather1", "rr.decoder.gather2"
POLL, TAIL = "rr.decoder.poll", "rr.decoder.tail"


def _inputs(converging: bool):
    """A prior and syndrome of B frames: the codeword's signs at 3.0 with
    noise of 1.5 (every frame converges within a few iterations), or noise
    alone (no frame converges in 3)."""
    g = torch.Generator().manual_seed(11)
    V = 24 * Z
    word = torch.randint(0, 2, (V, B), generator=g)
    noise = torch.randn((V, B), generator=g)
    if converging:
        prior = (1 - 2 * word).float() * 3.0 + 1.5 * noise
    else:
        prior = 2.0 * noise
    synd = QCDecoder(BASE, Z, device="cpu").syndrome_from_bits(word)
    return prior, synd


@pytest.mark.parametrize("converging", [True, False],
                         ids=["converging", "failing"])
@pytest.mark.parametrize("case", list(CASES))
def test_the_loop_polls_once_an_iteration_after_the_variable_step(
        case, converging, monkeypatch):
    make, gathers_once = CASES[case]
    dec = make()
    opened = []

    @contextlib.contextmanager
    def span(name):
        opened.append(name)
        yield

    monkeypatch.setattr(flooding, "span", span)
    prior, synd = _inputs(converging)
    maxiter = 30 if converging else 3
    success, iters, final = dec.decode_batched(prior, synd, maxiter)
    runs = dec.iterations_run
    if converging:
        assert bool(success.all())
        assert runs == min(int(iters.max()) + 2, maxiter) > 2
        assert dec.overrun_iterations == 1
    else:
        assert not bool(success.any())
        assert runs == maxiter
        assert dec.overrun_iterations == 0
    assert dec.polls_waited == 0            # no event to wait on here
    assert tuple(final.shape) == (24 * Z, B)
    # iteration j: gather 1 where t is stale, the variable step, then the
    # read of iteration j - 1; after the loop the read of the last
    # iteration run, then the tail
    want = []
    for j in range(runs):
        if j == 0 or not gathers_once:
            want.append(GATHER1)
        want.append(GATHER2)
        if j > 0:
            want.append(POLL)
    assert opened == want + [POLL, TAIL]
    assert opened.count(POLL) == runs


def _read_every_iteration(dec, prior, synd, c2v, max_iterations, check,
                          variable):
    """A plain flooding loop with the same steps as ``flood`` that reads
    "any newly converged, all done?" at the end of each iteration, before
    the next is enqueued: the reference of ``flood``'s results."""
    maxiter = int(max_iterations)
    B = prior.shape[-1]
    total = final = prior
    t = None
    done = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    it = 0
    all_done = False
    while it < maxiter and not all_done:
        if t is None:
            t = dec._check_inputs(total)
        c2v, viol = check(t, c2v, synd)
        conv = dec._frame_violations(viol.sum(0)) == 0
        new_total, t = variable(c2v, t)
        newly = conv & ~done
        iters = torch.where(newly, it, iters)
        done = done | conv
        any_new, all_done = bool(newly.any()), bool(done.all())
        if any_new:
            final = torch.where(newly, total, final)
        total = new_total
        it += 1
    conv = dec._tail_consistent(total, synd)
    newly = conv & ~done
    iters = torch.where(newly, maxiter, iters)
    final = torch.where(newly, total, final)
    done = done | conv
    iters = torch.where(done, iters, maxiter)
    final = dec._whole_finals(torch.where(done, final, total))
    return done, iters, final


def _staggered():
    """A prior and syndrome of B frames whose noise grows frame by frame:
    they first satisfy their syndromes at iterations 0 to 7, some
    together."""
    g = torch.Generator().manual_seed(11)
    V = 24 * Z
    word = torch.randint(0, 2, (V, B), generator=g)
    noise = torch.randn((V, B), generator=g)
    prior = (1 - 2 * word).float() * 3.0 \
        + torch.linspace(0.8, 2.3, B) * noise
    synd = QCDecoder(BASE, Z, device="cpu").syndrome_from_bits(word)
    return prior, synd, word


# batch -> maxiter, or None: one past the slowest frame's iteration (it
# converges at the last allowed iteration), or "tail": the slowest frame's
# iteration (it converges only in the tail's test)
BATCHES = {
    "staggered": 30,
    "consistent-at-0": 30,
    "last-allowed-iteration": None,
    "in-the-tail": "tail",
    "maxiter-0": 0,
    "maxiter-1": 1,
    "maxiter-2": 2,
}


@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("case", list(CASES))
def test_the_late_read_returns_what_a_read_every_iteration_returns(
        case, batch, monkeypatch):
    make, _ = CASES[case]
    prior, synd, word = _staggered()
    if batch == "consistent-at-0":
        prior = (1 - 2 * word).float() * 3.0
    dec, ref = make(), make()
    maxiter = BATCHES[batch]
    if not isinstance(maxiter, int):
        slowest = int(make().decode_batched(prior, synd, 30)[1].max())
        maxiter = slowest + 1 if maxiter is None else slowest
    success, iters, final = dec.decode_batched(prior, synd, maxiter)
    with monkeypatch.context() as m:
        m.setattr(decoder_mod, "flood", _read_every_iteration)
        m.setattr(qc_decoder_mod, "flood", _read_every_iteration)
        want = ref.decode_batched(prior, synd, maxiter)
    assert torch.equal(success, want[0])
    assert torch.equal(iters, want[1])
    assert final.dtype == want[2].dtype
    assert torch.equal(final, want[2])
    # iterations run: one past the slowest frame's where every frame
    # converges within the loop early enough, else every one allowed
    slowest = int(iters.max())
    early = bool(success.all()) and slowest + 2 <= maxiter
    assert dec.iterations_run == (slowest + 2 if early else maxiter)
    assert dec.overrun_iterations == int(early)
    assert dec.polls_waited == 0
    if batch == "staggered":
        assert bool(success.all()) and len(set(iters.tolist())) >= 4
    if batch == "consistent-at-0":
        assert iters.tolist() == [0] * B and dec.iterations_run == 2
    if batch == "last-allowed-iteration":
        assert bool(success.all()) and slowest == maxiter - 1
    if batch == "in-the-tail":
        assert bool(success.all()) and slowest == maxiter
