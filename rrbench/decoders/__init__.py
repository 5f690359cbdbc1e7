"""Decoders a configuration may name (``decoder.kind``), one module each.

A module holds ``program(code, spec, dtype, device)``, the program's
decoder as the configuration runs it, and ``Reference(code, spec, prec,
device)``, the plain reference of its decode with ``decode(prior, synd,
max_iterations) -> (success [B], iters [B], final [N, B])``.
"""

from __future__ import annotations

import importlib

import torch


def load(kind: str):
    return importlib.import_module(f"{__name__}.{kind}")


def syndrome(code, word):
    """[C, B] int32: the parity of each check's variables of the word
    [N, B], over the expanded edge list (integer sums, exact in any
    order)."""
    dev = word.device
    vid = torch.as_tensor(code.vid, device=dev)
    cid = torch.as_tensor(code.cid, device=dev)
    acc = torch.zeros((code.cnum, word.shape[1]), dtype=torch.int32,
                      device=dev)
    acc.index_add_(0, cid, word.to(torch.int32).index_select(0, vid))
    return acc & 1
