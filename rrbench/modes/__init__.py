"""Reconciliation modes a traffic mix may name (``mode``), one module each.

A module holds the mode's name as the program's ``run_point`` takes it
(``PROGRAM_MODE``), whether the program's point takes the configuration's
sign configuration (``TAKES_NMCONFIG``), and ``inputs(mapper, x, y,
cast)``: the reference's LLRs and word [N, B] of a round on symbols ``x``
and samples ``y`` [S, B].
"""

from __future__ import annotations

import importlib

import torch


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def bits_nb(cols):
    """Per-bit columns [S, B] -> [N, B], bit ``b`` of symbol ``s`` at row
    ``s * bps + b``."""
    return torch.stack(cols, dim=1).reshape(-1, cols[0].shape[-1])


def gray_word(mapper, idx):
    """The Gray word [N, B] (int32) of symbol indices [S, B]."""
    s2b = torch.as_tensor(mapper.pam.s_to_b.astype("int32"),
                          device=idx.device)
    return bits_nb([s2b[:, b][idx.long()] for b in range(mapper.pam.bps)])
