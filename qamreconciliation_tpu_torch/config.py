"""Global numeric configuration (counterpart of ``qamreconciliation_tpu.config``).

Everything in this package takes an explicit ``dtype`` and ``device``;
:data:`DEFAULT_DTYPE` is the default message/LLR dtype.
"""

import numpy as np
import torch

# Default compute dtype for LLR/message tensors.
DEFAULT_DTYPE = torch.float32

# Integer dtype for node/edge/symbol indices.
INDEX_DTYPE = torch.int32

_DTYPE_NAMES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def as_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _DTYPE_NAMES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None


def finite_llr_max(dtype) -> float:
    """A large-but-safe LLR magnitude for the given dtype.

    The reference's "certain bit" sentinel is 1e300; in float32 that would
    overflow to inf and poison sums, so clamp to a quarter of the dtype max.
    """
    return min(1e300, float(torch.finfo(as_dtype(dtype)).max) / 4)
