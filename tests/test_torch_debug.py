"""The debug tier (``utils/debug.with_numeric_checks``), the counterpart of
tests/test_debug.py: the NaN guard fires on a NaN produced inside the
wrapped function, also one that never reaches its outputs, and passes
clean pipelines, the BP decoders' included; ``errors=`` names the checks
as checkify does, and the div checks catch an integer division by zero."""

import numpy as np
import pytest
import torch

from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.utils.debug import (
    NumericCheckError, div_checks, float_checks, index_checks, nan_checks,
    with_numeric_checks,
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


def _generic_inputs():
    vid, cid = make_regular_ldpc(96, 3, 6, seed=2)
    dec = Decoder(vid, cid, torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    word = rng.integers(0, 2, (4, dec.vnum))
    synd = Matrix(vid, cid).eval_syndrome(torch.from_numpy(word))
    llr = torch.from_numpy((1 - 2 * word) * 2.0
                           + rng.normal(0, 1.5, word.shape)).float()
    return dec, llr, synd


def test_decoder_round_checks_clean_under_float_checks():
    """tests/test_debug.py's call pattern: ``errors=float_checks`` on a
    generic decode, whose outputs are finite."""
    dec, llr, synd = _generic_inputs()
    step = with_numeric_checks(
        lambda l, s: dec.decode_batched(l.T, s.T, 10)[2],
        errors=float_checks,
    )
    out = step(llr, synd)
    assert torch.isfinite(out).all()


def test_default_errors_raise_on_injected_nan():
    """The default checks (float | index, the reference's) raise on a NaN
    injected into the decoder's LLRs."""
    dec, llr, synd = _generic_inputs()
    llr[1, 5] = float("nan")
    step = with_numeric_checks(
        lambda l, s: dec.decode_batched(l.T, s.T, 10)[2])
    with pytest.raises(NumericCheckError, match="NaN"):
        step(llr, synd)


DIVISIONS = {
    "floordiv": lambda a, b: a // b,
    "floor_divide": torch.floor_divide,
    "remainder": lambda a, b: a % b,
    "fmod": torch.fmod,
    "div trunc": lambda a, b: torch.div(a, b, rounding_mode="trunc"),
}


@pytest.mark.parametrize("name", sorted(DIVISIONS))
def test_div_checks_raise_on_integer_division_by_zero(name):
    """Under ``div_checks`` an integer division by a tensor holding a zero
    raises; one by a divisor without a zero passes."""
    op = with_numeric_checks(DIVISIONS[name], errors=div_checks)
    a = torch.tensor([4, 5, 6], dtype=torch.int32)
    with pytest.raises(NumericCheckError, match="division by zero"):
        op(a, torch.tensor([1, 0, 3], dtype=torch.int32))
    b = torch.tensor([1, 2, 3], dtype=torch.int32)
    assert torch.equal(op(a, b), DIVISIONS[name](a, b))


def test_div_checks_raise_on_a_zero_scalar_divisor():
    a = torch.tensor([4, 5], dtype=torch.int32)
    for fn in (lambda x: x // 0, lambda x: x % 0):
        with pytest.raises(NumericCheckError, match="division by zero"):
            with_numeric_checks(fn, errors=div_checks)(a)


def test_check_sets_select_what_is_checked():
    a = torch.tensor([4, 5], dtype=torch.int64)
    zero = torch.zeros(2, dtype=torch.int64)
    nan = with_numeric_checks(lambda x: torch.log(x), errors=nan_checks)
    with pytest.raises(NumericCheckError):
        nan(torch.tensor([-1.0]))
    # without the div checks the guard leaves integer division to torch
    # (which raises its own error on the CPU)
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        with_numeric_checks(lambda x, y: x // y, errors=nan_checks)(a, zero)
    with pytest.raises(NumericCheckError):
        with_numeric_checks(lambda x, y: x // y)(a, zero)
    # true division of integers is floating point: no integer check
    out = with_numeric_checks(lambda x, y: x / y, errors=div_checks)(a, zero)
    assert torch.isinf(out).all()
    assert float_checks == nan_checks | div_checks
    with pytest.raises(ValueError, match="unknown checks"):
        with_numeric_checks(lambda x: x, errors={"bounds"})
    assert with_numeric_checks(lambda x: x + 1, errors=index_checks)(
        torch.tensor([1.0])).item() == 2.0
