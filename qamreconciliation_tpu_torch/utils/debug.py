"""Debug-tier numeric guards.

The reference disables safety in its hot paths (``boundscheck(False)``,
reference: qamreconciliation/decoder.pyx:181,240,289,332,399).  The JAX
package inverts that with an opt-in ``checkify`` wrapper; this is its
PyTorch counterpart.  :func:`with_numeric_checks` runs a function under a
``TorchDispatchMode`` that checks every operator the function dispatches,
so a fault produced inside a pipeline and hidden before its result (masked
by a ``where``, summed into an integer count) is caught where it arises.
The checks are named as checkify's: ``nan_checks`` (a floating output holds
a NaN), ``div_checks`` (an integer division, floor division, remainder or
fmod whose divisor holds a zero; torch raises on that by itself on the CPU
but not on the card), ``index_checks`` and ``float_checks = nan_checks |
div_checks``.  Out-of-range gathers already raise in PyTorch itself, so the
index checks add nothing to what PyTorch does.  Each checked operator costs
a reduction and, on the card, a host synchronisation: for debugging LLR
pipelines, not for the production path.  The hand-written CUDA kernels
are called through ctypes and bypass the dispatcher; the operators that
read their outputs are checked.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["NumericCheckError", "with_numeric_checks", "nan_checks",
           "div_checks", "index_checks", "float_checks"]

nan_checks = frozenset({"nan"})
div_checks = frozenset({"div"})
index_checks = frozenset({"index"})
float_checks = nan_checks | div_checks
_ALL_CHECKS = float_checks | index_checks

# operators whose outputs are uninitialised memory, so may hold any bits
_UNINITIALISED = ("empty", "new_empty", "empty_like", "empty_strided",
                  "new_empty_strided", "resize_")
# operators that divide integers when both operands are integers (``div``
# only with a rounding mode: without one it divides in floating point)
_DIVISIONS = ("div", "div_", "floor_divide", "floor_divide_", "remainder",
              "remainder_", "fmod", "fmod_")


class NumericCheckError(FloatingPointError):
    """A checked function produced a NaN or divided an integer by zero."""


def _integral(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex())
    return isinstance(x, int)


def _divides_by_zero(func, args, kwargs) -> bool:
    """Whether ``func(*args, **kwargs)`` is an integer division whose
    divisor holds a zero."""
    name = func.overloadpacket.__name__
    if name not in _DIVISIONS or len(args) < 2:
        return False
    if name.startswith("div") and kwargs.get("rounding_mode") is None:
        return False
    num, den = args[0], args[1]
    if not (_integral(num) and _integral(den)):
        return False
    if isinstance(den, torch.Tensor):
        return bool((den == 0).any())
    return den == 0


class _NumericChecks(TorchDispatchMode):
    """Raise on the first operator that divides an integer by zero (under
    the div checks) or whose floating output holds a NaN (under the NaN
    checks)."""

    def __init__(self, errors):
        super().__init__()
        self.errors = errors

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "div" in self.errors and _divides_by_zero(func, args, kwargs):
            raise NumericCheckError(f"integer division by zero in {func}")
        out = func(*args, **kwargs)
        if ("nan" not in self.errors
                or func.overloadpacket.__name__ in _UNINITIALISED):
            return out
        for x in tree_leaves(out):
            if (isinstance(x, torch.Tensor) and x.numel()
                    and (x.is_floating_point() or x.is_complex())
                    and bool(torch.isnan(x).any())):
                raise NumericCheckError(f"NaN produced by {func}")
        return out


def with_numeric_checks(fn, errors=None):
    """Wrap ``fn`` so that the checks named by ``errors`` raise
    :class:`NumericCheckError` (a ``FloatingPointError``) on the first
    operator they catch.

    ``errors`` is a set of checks (``float_checks``, ``nan_checks``,
    ``div_checks``, ``index_checks`` or a union of them) and defaults to
    ``float_checks | index_checks``, as the JAX package's does.

    Example::

        step = with_numeric_checks(lambda lappr, synd: dec.decode_batched(
            lappr, synd, 10), errors=float_checks)
        step(lappr, synd)   # raises on the first NaN
    """
    errors = float_checks | index_checks if errors is None \
        else frozenset(errors)
    unknown = errors - _ALL_CHECKS
    if unknown:
        raise ValueError(f"unknown checks {sorted(unknown)}; use "
                         f"nan_checks, div_checks, index_checks or "
                         f"float_checks")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _NumericChecks(errors):
            return fn(*args, **kwargs)

    return wrapper
