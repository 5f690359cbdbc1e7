"""BICM / Gray-code tables (host numpy, copied from the JAX package).

The binary-reflected Gray code of symbol ``s`` is ``s ^ (s >> 1)``; column
``k`` of the symbol->bits table is bit ``k`` of that value.
"""

import numpy as np

__all__ = ["generate_table_s_to_b", "generate_error_number_table",
           "gray_bit_masks"]


def generate_table_s_to_b(log_order: int) -> np.ndarray:
    """Symbol-index -> Gray bit table, shape [2**log_order, log_order], uint8.

    ``table[s, k]`` is bit ``k`` of the binary-reflected Gray code of ``s``.
    """
    if log_order <= 0:
        raise ValueError(f"log_order ({log_order}) must be a positive integer")
    s = np.arange(1 << log_order, dtype=np.int64)
    gray = s ^ (s >> 1)
    k = np.arange(log_order, dtype=np.int64)
    return ((gray[:, None] >> k[None, :]) & 1).astype(np.uint8)


def generate_error_number_table(s_to_b: np.ndarray) -> np.ndarray:
    """Pairwise Hamming distance between symbol bit labels.

    ``n_err[i, j]`` = number of bit errors when symbol ``a_i`` is decided
    given ``a_j`` was transmitted.  Symmetric, zero diagonal.
    """
    s_to_b = np.asarray(s_to_b, dtype=np.int64)
    diff = s_to_b[:, None, :] ^ s_to_b[None, :, :]
    return diff.sum(axis=-1).astype(np.int64)


def gray_bit_masks(log_order: int) -> np.ndarray:
    """Float selector masks for Gray-labelled LLR accumulation, shape
    [2**log_order, log_order] float64: ``mask[i, k] = 1`` where bit ``k`` of
    symbol ``i`` is 1 (the LLR denominator group), 0 where it is 0 (the
    numerator group)."""
    return generate_table_s_to_b(log_order).astype(np.float64)
