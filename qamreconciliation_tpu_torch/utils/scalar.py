"""Small scalar/batched utilities on tensors."""

import torch

__all__ = ["dist_cut", "count_errors_from_lappr"]


def dist_cut(x):
    """Clamp to [0, 1]."""
    return torch.clamp(torch.as_tensor(x), 0.0, 1.0)


def count_errors_from_lappr(lappr, word):
    """Hard-decision mismatch count over the last axis (bit = 1 iff
    ``lappr < 0``); leading axes are batch.  Exact int64 counts."""
    lappr, word = torch.as_tensor(lappr), torch.as_tensor(word)
    decided = (lappr < 0).to(torch.int64)
    return torch.sum(decided ^ word.to(torch.int64), dim=-1)
