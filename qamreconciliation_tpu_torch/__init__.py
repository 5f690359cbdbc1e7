"""PyTorch/CUDA port of qamreconciliation_tpu: soft reverse reconciliation.

The port keeps the JAX package's module layout and public names.  Its hot
loop runs hand-written CUDA kernels on an NVIDIA GPU (``ops/kernels.py``,
sources in ``csrc/``, built with nvcc at first use); a tensor on the CPU
runs each kernel's plain PyTorch version.
"""

from .models.alphabet import PAMAlphabet
from .models.decoder import Decoder, TannerGraph
from .models.matrix import Matrix
from .models.noisemapper import NoiseMapper
from .models.qc_decoder import QCDecoder, detect_qc
from .ops.kernels import bp_check_phase_qc

__all__ = ["PAMAlphabet", "NoiseMapper", "QCDecoder", "Decoder",
           "TannerGraph", "Matrix", "detect_qc", "bp_check_phase_qc"]
