"""The plain reference of the benchmark: plain PyTorch and NumPy, no code
of the program.

It works out again, from the seeds and the codes the benchmark hands to
both sides, what the program's timed path derives from them: each round's
symbols and noise (:mod:`.channel`), Bob's hard decision, his softening
metric, the Gray word and Alice's LLRs (:mod:`.mapper` and the modes under
``rrbench/modes/``), the syndrome and the BP decode (``rrbench/decoders/``
with :mod:`.checks`), and the four counters (:func:`counters`).  Its
arithmetic is a frozen copy of the program's plain paths, operation for
operation, so on the same device the two agree bit for bit, and the
comparison is exact.  :class:`Precision` sets the storage precision of
the LLRs and messages; the control runs the reference with a lower one.
"""

from __future__ import annotations

import torch

__all__ = ["Precision", "counters"]


class Precision:
    """Where the program rounds to its message dtype (LLRs, messages,
    totals), the reference calls :meth:`cast`.  ``"bfloat16"`` stores
    bf16 tensors, as the program does; ``"float8_e4m3fn"`` (the control)
    rounds through float8 e4m3, saturated at its largest finite value,
    and keeps the values in float32 tensors."""

    F8_MAX = 448.0

    def __init__(self, name: str):
        if name not in ("bfloat16", "float8_e4m3fn"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = (torch.float32 if name == "float8_e4m3fn"
                      else torch.bfloat16)

    def cast(self, x):
        if self.name == "float8_e4m3fn":
            x = torch.clamp(x.float(), -self.F8_MAX, self.F8_MAX)
            return x.to(torch.float8_e4m3fn).to(torch.float32)
        return x.to(self.dtype)


def counters(final, word, success, iters, k: int):
    """The four counters of a round ``[bit errors, frame errors, iterations
    of successes, successes]`` (int64): bit errors over the first ``k``
    (information) bits of each frame, the hard decision of ``final``
    (``< 0`` is a one) against ``word``."""
    errb = (final[:k] < 0).to(torch.int32) ^ word[:k].to(torch.int32)
    errors = torch.sum(errb, dim=0)
    return torch.stack([
        errors, (errors > 0).to(errors.dtype),
        torch.where(success, iters, 0).to(errors.dtype),
        success.to(errors.dtype),
    ]).sum(dim=1)
