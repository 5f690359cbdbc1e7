"""Soft reverse reconciliation: Bob's hard decision is the word; Alice's
softening LLRs of his metric and her symbols feed the decoder (frozen
copy of ``ReconciliationEngine._softening_inputs`` with "poly" LLRs,
``qamreconciliation_tpu_torch/sims/engine.py`` at commit bdbe956)."""

from __future__ import annotations

from . import bits_nb, gray_word

PROGRAM_MODE = "softening"
TAKES_NMCONFIG = True


def inputs(mapper, x, y, cast):
    x_hat = mapper.hard_decide(y)
    n_hat = mapper.metric(y, x_hat)
    word = gray_word(mapper, x_hat)
    # the program scales the LLRs by alpha = 1, which changes no bit
    return bits_nb(mapper.poly_llr(n_hat, x, cast)), word
