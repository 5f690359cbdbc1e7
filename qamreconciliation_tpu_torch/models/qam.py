"""Square QAM as two independent PAM quadratures.

A ``QAMAlphabet`` wraps one :class:`PAMAlphabet` per quadrature, samples
complex symbols, and interleaves the per-quadrature Gray bits as
``[I-bits, Q-bits]`` per symbol, so the PAM reconciliation stack
(NoiseMapper, engines, decoders) runs unchanged on each quadrature's real
stream.  Randomness comes from explicit ``torch.Generator``s.
"""

from __future__ import annotations

import torch

from .alphabet import PAMAlphabet
from ..config import DEFAULT_DTYPE, as_dtype

__all__ = ["QAMAlphabet"]

# the complex dtype of each part dtype; a bf16 part has none, as in
# jax.lax.complex, which accepts float32 and float64 parts only
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _complex(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    if re.dtype not in _COMPLEX:
        raise TypeError(f"complex does not accept dtype {re.dtype}: the "
                        f"parts must be float32 or float64")
    return torch.complex(re, im)


class QAMAlphabet:
    """M-QAM with M = 4^(bit_per_symbol/2), factored into I/Q PAM.

    Args:
      bit_per_symbol: total bits per complex symbol (must be even).
      step: PAM grid spacing per quadrature.
      probabilities: optional per-quadrature PAM probabilities (the complex
        symbol distribution is the product measure).
    """

    def __init__(self, bit_per_symbol: int, step: float, probabilities=None):
        if bit_per_symbol % 2 != 0:
            raise ValueError(
                f"QAM bit_per_symbol must be even, got {bit_per_symbol}"
            )
        self.bit_per_symbol = int(bit_per_symbol)
        self.pam = PAMAlphabet(bit_per_symbol // 2, step, probabilities)
        self.order = self.pam.order ** 2
        self.step = self.pam.step
        # Es of the complex symbol = 2x the per-quadrature PAM variance.
        self.variance = 2.0 * self.pam.variance

    def random_symbols(self, generator: torch.Generator, shape, device):
        """Sample (i_idx, q_idx) PAM index pairs, each of ``shape``: the I
        indices first, then the Q ones, from ``generator``."""
        return (self.pam.random_symbols(generator, shape, device),
                self.pam.random_symbols(generator, shape, device))

    def index_to_value(self, iq_index, dtype=DEFAULT_DTYPE) -> torch.Tensor:
        """(i_idx, q_idx) -> complex constellation points with parts in
        ``dtype`` (float32 -> complex64, float64 -> complex128; bf16 parts
        raise ``TypeError``)."""
        i_idx, q_idx = iq_index
        return _complex(self.pam.index_to_value(i_idx, dtype),
                        self.pam.index_to_value(q_idx, dtype))

    def awgn(self, generator: torch.Generator, values, noise_var_total,
             dtype=DEFAULT_DTYPE) -> torch.Tensor:
        """Complex AWGN with TOTAL variance ``noise_var_total`` (split evenly
        over the quadratures, matching the per-quadrature PAM channel); the
        real parts' noise is drawn first."""
        dtype = as_dtype(dtype)
        s = torch.sqrt(torch.tensor(noise_var_total, dtype=dtype) / 2.0)
        shape, device = values.shape, values.device
        re = s * torch.randn(shape, generator=generator, device=device,
                             dtype=dtype)
        im = s * torch.randn(shape, generator=generator, device=device,
                             dtype=dtype)
        return values + _complex(re, im)

    def quadrature_streams(self, y):
        """Complex samples -> (real stream, imag stream) for the PAM stack."""
        return y.real, y.imag

    def demap_symbols_to_bits(self, iq_index) -> torch.Tensor:
        """(i_idx, q_idx) [..., S] -> bits [..., S * bit_per_symbol] with the
        per-symbol layout ``[I Gray bits, Q Gray bits]``."""
        i_idx, q_idx = iq_index
        h = self.pam.bit_per_symbol
        bi = self.pam.demap_symbols_to_bits(i_idx)      # [..., S * h]
        bq = self.pam.demap_symbols_to_bits(q_idx)
        bits = torch.cat([bi.reshape(*bi.shape[:-1], -1, h),
                          bq.reshape(*bq.shape[:-1], -1, h)], dim=-1)
        return bits.reshape(*bits.shape[:-2], -1)

    def interleave_llrs(self, llr_i, llr_q) -> torch.Tensor:
        """Per-quadrature LLR streams [..., S*bps/2] -> [..., S*bps] matching
        :meth:`demap_symbols_to_bits`'s bit layout."""
        h = self.pam.bit_per_symbol
        si = llr_i.reshape(*llr_i.shape[:-1], -1, h)
        sq = llr_q.reshape(*llr_q.shape[:-1], -1, h)
        out = torch.cat([si, sq], dim=-1)
        return out.reshape(*out.shape[:-2], -1)
