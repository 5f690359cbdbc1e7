"""Hard reverse reconciliation: Bob's hard decision is the word; Alice's
bare LLRs of the symbols she sent feed the decoder (frozen copy of
``ReconciliationEngine._hard_inputs``, ``qamreconciliation_tpu_torch/
sims/engine.py`` at commit bdbe956)."""

from __future__ import annotations

from . import bits_nb, gray_word

PROGRAM_MODE = "hard"
TAKES_NMCONFIG = False


def inputs(mapper, x, y, cast):
    x_hat = mapper.hard_decide(y)
    word = gray_word(mapper, x_hat)
    bare = cast(mapper.bare)
    xl = x.long()
    lappr = bits_nb([bare[:, b][xl] for b in range(mapper.pam.bps)])
    return lappr, word
