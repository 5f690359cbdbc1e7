"""The debug tier (``utils/debug.with_numeric_checks``), the counterpart of
tests/test_debug.py: the NaN guard fires on a NaN produced inside the
wrapped function, also one that never reaches its outputs, and passes
clean pipelines, the BP decoders' included."""

import numpy as np
import pytest
import torch

from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.utils.debug import (
    NumericCheckError, with_numeric_checks,
)
from qamreconciliation_tpu_torch.utils.edgefile import make_regular_ldpc

torch.set_num_threads(1)


def test_clean_function_passes():
    f = with_numeric_checks(
        lambda x: torch.log1p(torch.exp(-torch.abs(x))).sum())
    out = f(torch.linspace(-5, 5, 64))
    assert np.isfinite(float(out))
    # uninitialised buffers are not read as NaNs
    assert with_numeric_checks(lambda: torch.empty(1000).fill_(1.0))() \
        .sum() == 1000


def test_nan_production_raises():
    f = with_numeric_checks(lambda x: torch.log(x).sum())  # log(-1)
    with pytest.raises(NumericCheckError, match="log"):
        f(torch.tensor([-1.0, 2.0]))
    with pytest.raises(FloatingPointError):
        f(torch.tensor([-1.0, 2.0]))


def test_nan_inside_is_caught_though_the_output_is_clean():
    """A NaN that a where() hides before the result still raises, where
    plain execution returns a finite value."""
    def fn(x):
        y = torch.sqrt(x)                          # NaN for x < 0
        return torch.where(torch.isnan(y), torch.zeros_like(y), y).sum()

    x = torch.tensor([-4.0, 9.0])
    assert float(fn(x)) == 3.0
    with pytest.raises(NumericCheckError, match="sqrt"):
        with_numeric_checks(fn)(x)


@pytest.mark.parametrize("which", ["generic", "qc"])
def test_decoder_checks_clean(which):
    """The BP decodes (generic f32 phi, QC bf16 min-sum) produce no NaN."""
    if which == "generic":
        vid, cid = make_regular_ldpc(96, 3, 6, seed=2)
        dec = Decoder(vid, cid, torch.float32, device="cpu")
        dtype = torch.float32
    else:
        base, vid, cid = make_qc_ldpc(8, 12, 3, 6, seed=2)
        dec = QCDecoder(base, 12, torch.bfloat16, device="cpu",
                        check_rule="minsum")
        dtype = torch.bfloat16
    rng = np.random.default_rng(0)
    word = rng.integers(0, 2, (4, len(np.unique(vid))))
    synd = Matrix(vid, cid).eval_syndrome(torch.from_numpy(word))
    llr = torch.from_numpy((1 - 2 * word) * 2.0
                           + rng.normal(0, 1.5, word.shape)).to(dtype)
    step = with_numeric_checks(
        lambda l, s: dec.decode_batched(l.T, s.T, 10)[2])
    out = step(llr, synd)
    assert torch.isfinite(out.float()).all()
