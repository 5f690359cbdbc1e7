"""The flooding loop's contract (``models/flooding.flood``) in every
flooding decoder: one poll an iteration, the variable step enqueued before
it, gather 1 once a decode where the variable pass writes the next t and
every iteration elsewhere, and ``iterations_run`` the iterations run."""

import contextlib

import pytest
import torch

from qamreconciliation_tpu_torch.models import flooding
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
        assert runs == int(iters.max()) + 1 > 1
    else:
        assert not bool(success.any())
        assert runs == maxiter
    assert tuple(final.shape) == (24 * Z, B)
    # an iteration: the variable step, then the one poll; then the tail
    assert [n for n in opened if n != GATHER1] == \
        [GATHER2, POLL] * runs + [TAIL]
    # gather 1 only at an iteration's start, before its variable step
    at = [i for i, n in enumerate(opened) if n == GATHER1]
    assert len(at) == (1 if gathers_once else runs)
    for i in at:
        assert opened[i + 1] == GATHER2
        assert i == 0 or opened[i - 1] == POLL
