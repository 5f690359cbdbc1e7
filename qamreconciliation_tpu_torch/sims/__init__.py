"""Sweep engines and CLIs."""

from .engine import (
    ReconciliationEngine,
    simulate_softening_snr_dB,
    simulate_direct_snr_dB,
    simulate_hard_reverse_snr_dB,
)
from ..ops.llr import y_to_lappr_gray

# the reference's name of the Bob-side LLR helper
y_to_lappr_grey_array = y_to_lappr_gray

__all__ = [
    "ReconciliationEngine",
    "simulate_softening_snr_dB",
    "simulate_direct_snr_dB",
    "simulate_hard_reverse_snr_dB",
    "y_to_lappr_gray",
    "y_to_lappr_grey_array",
]
