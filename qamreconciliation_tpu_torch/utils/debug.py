"""Debug-tier numeric guards.

The reference disables safety in its hot paths (``boundscheck(False)``,
reference: qamreconciliation/decoder.pyx:181,240,289,332,399).  The JAX
package inverts that with an opt-in ``checkify`` wrapper; this is its
PyTorch counterpart.  :func:`with_numeric_checks` runs a function under a
``TorchDispatchMode`` that looks at the floating outputs of every operator
the function dispatches and raises on the first NaN, so a NaN produced
inside a pipeline and hidden before its result (masked by a ``where``,
summed into an integer count) is caught where it arises.  Out-of-range
gathers already raise in PyTorch itself.  Each checked operator costs a
reduction and, on the card, a host synchronisation: for debugging LLR
pipelines, not for the production path.  The hand-written CUDA kernels
are called through ctypes and bypass the dispatcher; the operators that
read their outputs are checked.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["NumericCheckError", "with_numeric_checks"]

# operators whose outputs are uninitialised memory, so may hold any bits
_UNINITIALISED = ("empty", "new_empty", "empty_like", "empty_strided",
                  "new_empty_strided", "resize_")


class NumericCheckError(FloatingPointError):
    """A checked function produced a NaN."""


class _NanChecks(TorchDispatchMode):
    """Raise on the first operator whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALISED:
            return out
        for x in tree_leaves(out):
            if (isinstance(x, torch.Tensor) and x.numel()
                    and (x.is_floating_point() or x.is_complex())
                    and bool(torch.isnan(x).any())):
                raise NumericCheckError(f"NaN produced by {func}")
        return out


def with_numeric_checks(fn):
    """Wrap ``fn`` so that a NaN produced by any operator it runs raises
    :class:`NumericCheckError` (a ``FloatingPointError``).

    Example::

        step = with_numeric_checks(lambda lappr, synd: dec.decode_batched(
            lappr, synd, 10))
        step(lappr, synd)   # raises on the first NaN
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _NanChecks():
            return fn(*args, **kwargs)

    return wrapper
