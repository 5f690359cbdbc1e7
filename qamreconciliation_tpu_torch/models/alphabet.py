"""Probabilistically-shaped M-PAM alphabet.

Host tables are numpy float64 (built once per alphabet); sampling and value
lookup are tensor ops on the caller's device, with randomness from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bicm
from ..config import DEFAULT_DTYPE, INDEX_DTYPE

__all__ = ["PAMAlphabet"]


class PAMAlphabet:
    """M-PAM constellation with optional probabilistic shaping.

    Attributes (numpy float64 on the host):

    * ``bit_per_symbol`` — log2(order)
    * ``order`` — constellation size M = 2**bit_per_symbol
    * ``step`` — grid spacing
    * ``constellation[M]`` — ``(i - (M-1)/2) * step``
    * ``probabilities[M]`` — symbol probabilities (default uniform)
    * ``variance`` — Es = sum p_i |a_i|^2
    * ``thresholds[M+1]`` — decision thresholds: interior midpoints, outer
      sentinels at ``100 * edge``
    * ``s_to_b[M, bps]`` — Gray symbol->bits table
    """

    def __init__(self, bit_per_symbol: int, step: float, probabilities=None):
        if bit_per_symbol <= 0:
            raise ValueError(
                f"Bit per symbol must be at least 1, got {bit_per_symbol}"
            )
        self.bit_per_symbol = int(bit_per_symbol)
        self.order = 1 << self.bit_per_symbol
        self.step = float(step)

        if probabilities is None:
            self.probabilities = np.full(self.order, 1.0 / self.order)
        else:
            probabilities = np.asarray(probabilities, dtype=np.float64)
            if probabilities.size != self.order:
                raise ValueError(
                    "Probability vector does not match constellation size"
                )
            if np.any(probabilities <= 0):
                raise ValueError("Probabilities must be positive")
            if abs(probabilities.sum() - 1.0) > 1e-9:
                raise ValueError("Probabilities do not sum to 1")
            self.probabilities = probabilities

        self.constellation = (
            np.arange(self.order, dtype=np.float64) - (self.order - 1) / 2
        ) * self.step
        self.variance = float(
            np.sum(self.probabilities * np.abs(self.constellation) ** 2)
        )

        self.thresholds = np.empty(self.order + 1, dtype=np.float64)
        self.thresholds[1:self.order] = self.constellation[1:] - self.step / 2
        self.thresholds[0] = self.constellation[0] * 100    # very negative
        self.thresholds[-1] = self.constellation[-1] * 100  # very positive

        self.s_to_b = bicm.generate_table_s_to_b(self.bit_per_symbol)
        self._cum_prob = np.concatenate([[0.0], np.cumsum(self.probabilities)])

    def random_symbols(self, generator: torch.Generator, shape,
                       device) -> torch.Tensor:
        """Shaped symbol indices of ``shape`` on ``device`` (int32).

        Inverse-CDF sampling: index = #{interior cumulative cut points <= u}
        for a float32 uniform ``u``, accumulated one scalar cut at a time.
        """
        if np.isscalar(shape):
            shape = (int(shape),)
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
        idx = torch.zeros(u.shape, dtype=INDEX_DTYPE, device=device)
        for c in self._cum_prob[1:-1]:
            idx += u >= torch.tensor(c, dtype=torch.float32)
        return idx

    def index_to_value(self, index: torch.Tensor,
                       dtype=DEFAULT_DTYPE) -> torch.Tensor:
        """Constellation values for symbol indices (any shape)."""
        table = torch.as_tensor(self.constellation, dtype=dtype,
                                device=index.device)
        return table[index.long()]

    def demap_symbols_to_bits(self, symbol_index: torch.Tensor) -> torch.Tensor:
        """Gray bits (uint8) of symbol indices: ``[..., S]`` -> ``[...,
        S * bit_per_symbol]`` with the per-symbol bit blocks contiguous."""
        table = torch.as_tensor(self.s_to_b, device=symbol_index.device)
        bits = table[symbol_index.long()]              # [..., S, bps]
        return bits.reshape(*bits.shape[:-2], -1)
