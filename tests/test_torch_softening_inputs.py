"""The softening round's inputs (``ops/kernels.softening_inputs``, its plain
version ``softening_inputs_ref`` and the engine's ``_softening_inputs``) on
the CPU: both held bit for bit to a frozen copy of the engine's code before
the kernel, the rule that decides which rounds take the kernel, the
wrapper's argument checks, the kernel's table, and its work count.  The
kernel itself runs on the card (``tests/test_torch_cuda.py -k
softening``)."""

import math
import types

import numpy as np
import pytest
import torch

from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.noisemapper import (
    _POLY_D, _POLY_DEG, _POLY_NSEG, NoiseMapperFlipSign,
)
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.ops import kernels
from qamreconciliation_tpu_torch.sims.engine import (
    ReconciliationEngine, round_generator,
)
from qamreconciliation_tpu_torch.utils import perf

# a QC (3,6) code of N = 384 (bps 1, 2 and 4 divide it), 8 frames a round
Z, BATCH, SEED = 16, 8, 2 ** 31 + 77
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SIGNS = {"zeros": None, "alternating": [0, 1] * 8}


def frozen_softening_inputs(eng, nm, x, y, alpha):
    """``ReconciliationEngine._softening_inputs`` as it was before the
    kernel, with its ``_bits_nb`` (frozen)."""
    def bits_nb(table_col_fn, idx_sb):
        cols = [table_col_fn(b, idx_sb)
                for b in range(eng.pa.bit_per_symbol)]
        return torch.stack(cols, dim=1).reshape(eng.N, -1)

    x_hat = nm.hard_decide_index(y)
    n_hat = nm.map_noise(y, x_hat)
    word = bits_nb(lambda b, idx: eng._s2b[:, b][idx.long()], x_hat)
    alpha = torch.tensor(alpha, dtype=eng.dtype)
    if eng.llr_mode in ("interp", "search"):
        llr = nm.demap_lappr_array(n_hat.T, x.T, mode=eng.llr_mode)
        return alpha * llr.T.contiguous(), word
    llr_fn = (nm._poly_llr_bits if eng.llr_mode == "poly"
              else nm._table_llr_bits)
    llr_bits = llr_fn(n_hat, x)
    lappr = alpha * bits_nb(lambda b, _: llr_bits[b], x_hat)
    return lappr, word


_DEC = {}


def engine(bps, dtype, llr_mode="poly", fy_mode="erf"):
    if not _DEC:
        torch.set_num_threads(1)
        base, vid, cid = make_qc_ldpc(24, Z, 3, 6, seed=5)
        _DEC["dec"] = QCDecoder(base, Z, "float32", device="cpu")
        _DEC["mat"] = Matrix(vid, cid)
    return ReconciliationEngine(_DEC["dec"], _DEC["mat"],
                                PAMAlphabet(bps, 2.0), batch=BATCH,
                                dtype=dtype, llr_mode=llr_mode,
                                fy_mode=fy_mode)


def samples(eng, snr, r=0, planted=True):
    """A round's symbols and samples; with ``planted``, one sample in 16
    set to an interior threshold or a constellation point."""
    sigma = math.sqrt(eng.noise_var(snr))
    x, y = eng._sample_sb(round_generator(SEED, r, "cpu"), sigma)
    if planted:
        pa = eng.pa
        spots = torch.tensor([float(t) for t in pa.thresholds[1:-1]]
                             + list(pa.constellation), dtype=eng.dtype)
        gen = torch.Generator().manual_seed(r)
        pick = torch.randint(0, spots.numel(), y.shape, generator=gen)
        y = torch.where(torch.rand(y.shape, generator=gen) < 1 / 16,
                        spots[pick], y)
    return x, y.contiguous()


def same_bits(a, b):
    """Bit-equal tensors (zero signs included)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = a.view(ints[a.element_size()]), b.view(ints[b.element_size()])
    return torch.equal(a, b)


@pytest.mark.parametrize("alpha", [1.0, 0.6])
@pytest.mark.parametrize("signs", list(SIGNS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bps", [1, 2, 4])
def test_plain_and_engine_inputs_equal_the_frozen_code(bps, dtype, signs,
                                                        alpha):
    eng = engine(bps, dtype)
    nm = eng.make_noisemapper(3.5, SIGNS[signs])
    x, y = samples(eng, 3.5, r=bps)
    want = frozen_softening_inputs(eng, nm, x, y, alpha)
    for got in (eng._softening_inputs(nm, x, y, alpha),
                kernels.softening_inputs_ref(nm, x, y, alpha, eng._s2b),
                kernels.softening_inputs(nm, x, y, alpha, eng._s2b)):
        assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
    assert want[0].shape == (eng.N, BATCH) and want[1].dtype == torch.int32


OTHER_PATHS = {
    "table LLRs": dict(dtype="bfloat16", llr_mode="table"),
    "interp LLRs": dict(dtype="float32", llr_mode="interp"),
    "erf_flat CDF": dict(dtype="bfloat16", fy_mode="erf_flat"),
    "poly CDF": dict(dtype="float32", fy_mode="poly"),
    "float64": dict(dtype="float64"),
}


@pytest.mark.parametrize("case", list(OTHER_PATHS))
def test_rounds_the_kernel_does_not_take_keep_the_plain_path(case,
                                                             monkeypatch):
    eng = engine(2, **OTHER_PATHS[case])
    nm = eng.make_noisemapper(4.0, SIGNS["alternating"])
    assert not kernels.softening_takes(nm, eng.llr_mode)

    def refuse(*args, **kw):
        raise AssertionError("the wrapper ran a round it does not take")
    monkeypatch.setattr(kernels, "softening_inputs", refuse)
    x, y = samples(eng, 4.0)
    got = eng._softening_inputs(nm, x, y, 0.75)
    want = frozen_softening_inputs(eng, nm, x, y, 0.75)
    assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])


def test_poly_erf_rounds_go_through_the_wrapper(monkeypatch):
    eng = engine(2, "bfloat16")
    nm = eng.make_noisemapper(3.5, SIGNS["zeros"])
    calls = []
    wrapper = kernels.softening_inputs

    def counted(*args, **kw):
        calls.append(args[0])
        return wrapper(*args, **kw)
    monkeypatch.setattr(kernels, "softening_inputs", counted)
    x, y = samples(eng, 3.5)
    eng.round_inputs("softening", nm, x, y, 0.0, 1.0)
    eng.round_inputs("hard", nm, x, y, 0.0, 1.0)
    assert calls == [nm]


def fake(order, dtype=torch.bfloat16, fy_mode="erf"):
    return types.SimpleNamespace(order=order, dtype=dtype, fy_mode=fy_mode)


@pytest.mark.parametrize("nm,llr_mode,takes", [
    (fake(4), "poly", True),
    (fake(4, torch.float32), "poly", True),
    (fake(2), "poly", True),
    (fake(8), "poly", True),
    (fake(16, torch.float32), "poly", True),
    (fake(4, torch.float64), "poly", False),
    (fake(4, torch.float16), "poly", False),
    (fake(4), "table", False),
    (fake(4), "interp", False),
    (fake(4, torch.float32), "search", False),
    (fake(4, fy_mode="erf_flat"), "poly", False),
    (fake(4, fy_mode="poly"), "poly", False),
    (fake(32), "poly", False),
    (fake(64), "poly", False),
], ids=lambda v: str(getattr(v, "order", v)))
def test_which_rounds_the_kernel_takes(nm, llr_mode, takes):
    assert kernels.softening_takes(nm, llr_mode) is takes


def test_cpu_tensors_run_the_plain_version():
    eng = engine(2, "float32")
    nm = eng.make_noisemapper(3.5, SIGNS["alternating"])
    x, y = samples(eng, 3.5)
    launches = kernels.softening_inputs.launches
    got = kernels.softening_inputs(nm, x, y, 1.0, eng._s2b)
    want = kernels.softening_inputs_ref(nm, x, y, 1.0, eng._s2b)
    assert kernels.softening_inputs.launches == launches
    assert same_bits(got[0], want[0]) and torch.equal(got[1], want[1])
    # the table is built for the card only
    assert nm._softening_tab is None


@pytest.mark.parametrize("case", ["float64", "erf_flat CDF"])
def test_the_wrapper_refuses_mappers_it_does_not_take(case):
    eng = engine(2, **OTHER_PATHS[case])
    nm = eng.make_noisemapper(3.5)
    x, y = samples(eng, 3.5, planted=False)
    with pytest.raises(TypeError, match="softening_inputs takes"):
        kernels.softening_inputs(nm, x, y, 1.0, eng._s2b)


def _bad(what):
    eng = engine(2, "bfloat16")
    nm = eng.make_noisemapper(3.5)
    x, y = samples(eng, 3.5, planted=False)
    s2b = eng._s2b
    if what == "shapes":
        x = x[:, :4]
    elif what == "rank":
        x, y = x.reshape(-1), y.reshape(-1)
    elif what == "sample dtype":
        y = y.float()
    elif what == "symbol dtype":
        x = x.long()
    elif what == "bit table shape":
        s2b = s2b[:2]
    elif what == "bit table dtype":
        s2b = s2b.long()
    elif what == "device":
        y = torch.empty(y.shape, dtype=y.dtype, device="meta")
    return nm, x, y, s2b


@pytest.mark.parametrize("what,err", [
    ("shapes", ValueError), ("rank", ValueError),
    ("sample dtype", TypeError), ("symbol dtype", TypeError),
    ("bit table shape", ValueError), ("bit table dtype", ValueError),
    ("device", ValueError),
])
def test_argument_checks(what, err):
    nm, x, y, s2b = _bad(what)
    with pytest.raises(err):
        kernels.softening_inputs(nm, x, y, 1.0, s2b)


def table(nm):
    """The mapper's kernel table, built on first use."""
    nm._ensure_softening_tab()
    return nm._softening_tab


@pytest.mark.parametrize("bps", [1, 2, 4])
def test_the_table_holds_the_plain_paths_values(bps):
    eng = engine(bps, "bfloat16")
    nm = eng.make_noisemapper(4.0, SIGNS["alternating"])
    M = nm.order
    tab = table(nm)
    assert table(nm) is tab                         # built once a mapper
    assert tab.dtype == torch.float32
    assert tab.numel() == kernels.softening_table_size(M, bps) \
        == 7 * M + _POLY_NSEG * M * (_POLY_DEG + 1) * bps
    thr = [float(torch.tensor(t, dtype=nm.dtype)) for t in nm._thr_tuple]
    assert tab[:M - 1].tolist() == thr
    parts = tab[M - 1:7 * M - 1].reshape(6, M)
    for got, want in zip(parts, (nm._c, nm._p * 0.5, nm._F_thr[:-1],
                                 nm._F_thr[1:], nm._delta_F_Y,
                                 nm._g_signs())):
        assert torch.equal(got, want.float())
    den = math.sqrt(2.0) * nm._sigma_dev.to(torch.float32)
    assert float(tab[7 * M - 1]) == float(den)
    assert torch.equal(tab[7 * M:], nm._llr_poly.reshape(-1))
    # a clone with other signs, or a subclass, builds a table of its own
    clone = nm.with_sign_config([1] * M)
    assert clone._softening_tab is None
    assert table(clone)[6 * M - 1:7 * M - 1].tolist() \
        == [1.0] * M
    flip = NoiseMapperFlipSign(eng.pa, eng.noise_var(4.0),
                               dtype="bfloat16", device="cpu")
    assert table(flip)[6 * M - 1:7 * M - 1].tolist() \
        == [1.0] * (M // 2) + [0.0] * (M // 2)


def kernel_model(nm, x, y, alpha, s2b, order):
    """The kernel's arithmetic in plain PyTorch, read from its table, each
    operation rounded on its own; the erf terms summed in ``order``: "halves"
    (the kernel's, torch.sum's on the card) or "sequence"."""
    M, bps = nm.order, nm.bit_per_symbol
    tab = table(nm)
    thr, c, ph, lo, hi, dl, flip = (tab[:M - 1],
                                    *tab[M - 1:7 * M - 1].reshape(6, M))
    den, coef = tab[7 * M - 1], tab[7 * M:].reshape(_POLY_NSEG * M, -1)
    yf = y.float()
    xh = (yf[..., None] >= thr).sum(-1)
    terms = [0.0 + ph[k] * (1.0 + torch.erf(
        (yf - c[k]).to(y.dtype).float() / den)) for k in range(M)]
    if order == "halves":
        h = M // 2
        while h:
            terms = [terms[k] + terms[k + h] for k in range(h)]
            h //= 2
    else:
        for k in range(1, M):
            terms[0] = terms[0] + terms[k]
    F = terms[0]
    n = torch.where(flip[xh] != 0, (hi[xh] - F) / dl[xh],
                    (F - lo[xh]) / dl[xh])
    nf = n.clamp(0.0, 1.0)
    wlo = float(np.log(_POLY_D) - np.log1p(_POLY_D))
    w = torch.log(nf + _POLY_D) - torch.log((1.0 + _POLY_D) - nf)
    t = torch.clamp((w - wlo) * (float(1.0 / (-2.0 * wlo)) * _POLY_NSEG),
                    0.0, _POLY_NSEG * (1.0 - 1e-7))
    seg = torch.floor(t)
    xx = 2.0 * (t - seg) - 1.0
    cf = coef[(seg.long() * M + x.long())]
    llr, word = [], []
    for b in range(bps):
        b1 = b2 = torch.zeros_like(xx)
        for d in range(_POLY_DEG, 0, -1):
            b1, b2 = (2.0 * xx) * b1 - b2 + cf[..., d * bps + b], b1
        v = (xx * b1 - b2 + cf[..., b]).to(y.dtype)
        llr.append((float(torch.tensor(alpha, dtype=y.dtype))
                    * v.float()).to(y.dtype))
        word.append(s2b[:, b][xh])
    return (torch.stack(llr, 1).reshape(-1, y.shape[1]),
            torch.stack(word, 1).reshape(-1, y.shape[1]))


@pytest.mark.parametrize("signs", list(SIGNS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bps", [1, 2, 3])
def test_the_kernels_arithmetic_on_its_table_gives_the_plain_inputs(
        bps, dtype, signs):
    """The kernel's steps on its table, summed in the CPU's order (torch.sum
    adds up to 8 terms in sequence here; on the card it adds by halves, as
    the kernel does), are the plain inputs bit for bit: the table and every
    other rounding step are the plain path's."""
    eng = engine(bps, dtype)
    nm = eng.make_noisemapper(3.5, SIGNS[signs])
    x, y = samples(eng, 3.5, r=7)
    terms = torch.rand((y.numel(), nm.order)) * torch.exp2(
        torch.randint(-30, 2, (y.numel(), nm.order)).float())
    in_sequence = terms[:, 0] + 0.0
    for k in range(1, nm.order):
        in_sequence = in_sequence + terms[:, k]
    assert torch.equal(torch.sum(terms, -1), in_sequence)
    want = kernels.softening_inputs_ref(nm, x, y, 0.6, eng._s2b)
    got = kernel_model(nm, x, y, 0.6, eng._s2b, "sequence")
    assert same_bits(got[0], want[0]) and torch.equal(got[1], want[1])
    halves = kernel_model(nm, x, y, 0.6, eng._s2b, "halves")
    assert torch.equal(halves[1], want[1])


def test_work_and_bound_at_the_cells_shape():
    """[32400, 128] bf16 at 4-PAM: y 8.3 MB and x 16.6 MB in, the LLRs
    16.6 MB and the word 33.2 MB out, the tables 2.9 KB; 119 operations a
    sample; the bound is the bytes', 0.0223 ms."""
    S, B = 32400, 128
    nbytes, ops = perf.softening_inputs_work(S, B, 4, 2, torch.bfloat16)
    assert nbytes == S * B * 6 + 2 * S * B * 6 + 4 * 732 + 4 * 8 \
        == 74_652_560
    assert perf.softening_inputs_ops(4, 2) == 119
    assert ops == 119 * S * B
    ms, by = perf.bound(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(0.022284, abs=1e-6)
    f32 = perf.softening_inputs_work(S, B, 4, 2, torch.float32)[0]
    assert f32 == S * B * 8 + 2 * S * B * 8 + 4 * 732 + 4 * 8


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_the_table_is_a_fit_the_batched_estimator_sets_aside(dtype):
    """Built or not, the kernel's table leaves the mapper's structure (which
    groups mappers for the batched MC-MI estimator) and its shared tables
    as they were."""
    from qamreconciliation_tpu_torch.models import mutual_information as mi

    eng = engine(2, dtype)
    nm = eng.make_noisemapper(4.0, SIGNS["alternating"])
    other = nm.with_sign_config([1, 0, 0, 1])
    before, tables = mi._structure(nm), set(mi._tables(nm))
    table(nm)
    assert mi._structure(nm) == before == mi._structure(other)
    assert set(mi._tables(nm)) == tables
    assert "_softening_tab" in mi._FITS and "_softening_tab" not in tables
