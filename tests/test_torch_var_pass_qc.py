"""The dense QC decoder's variable pass (``ops/kernels.bp_var_pass_qc``).

On the CPU: its plain version equals the loop's earlier two steps, the
prior plus ``QCDecoder.scatter_partials`` rounded to storage and
``gather_totals`` of those totals, bit for bit, zero signs included, on
the regular (3,6) code and a QC-IRA code (irregular check degrees, whose
padded t rows keep +1e30), float32 and bfloat16, B aligned and ragged; a
lane without messages adds +0; it reads nothing on the host; the
decoder's table; which dtypes the loop runs it for; the wrapper's
arguments and its dispatch.  On the card
(marked ``cuda``; no JAX, so ``--noconftest`` runs them): the kernel bit
for bit against the plain version with planted -0 priors and messages,
one launch an iteration in the decode, and the dense decode through the
kernel bit-equal to the benchmark's frozen reference
(``rrbench/decoders/qc_dense.py``)."""

import pytest
import torch

from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ira, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.ops import kernels
from qamreconciliation_tpu_torch.ops.boxplus import BIG
from qamreconciliation_tpu_torch.ops.kernels import (
    bp_var_pass_qc, bp_var_pass_qc_ref,
)

torch.set_num_threads(1)

BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
DTYPES = [torch.float32, torch.bfloat16]


def regular(z=16):
    return make_qc_ldpc(24, z, 3, 6, seed=5)[0]


def ira(z=16):
    return make_qc_ira(12, 6, z, dv=3, seed=2)[0]


CODES = {"regular": regular, "ira": ira}


def gapped(z=8):
    """A QC code whose variable block 2 has no edge (its lanes have no
    messages), the others of degree 1 to 3."""
    return [(0, 0, 1), (0, 1, 3), (0, 3, 0), (1, 0, 5), (1, 3, 2),
            (1, 4, 7), (2, 0, 2), (2, 1, 6), (2, 4, 4)], z


def same_bits(a, b):
    bits = BITS[a.dtype]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(bits), b.contiguous().view(bits))


def pass_inputs(dec, dtype, B, seed, device="cpu"):
    """(prior [nb_v, z, B], c2v [nb_c, dc, z, B], t) in ``dtype``: normal
    priors and messages with a share of exact +-0 (on the padded slots
    too, which the pass never reads), and a t gathered from other totals
    (padded slots +1e30)."""
    g = torch.Generator().manual_seed(seed)

    def draw(shape, scale):
        x = scale * torch.randn(shape, generator=g)
        pick = torch.rand(shape, generator=g)
        return torch.where(pick < 0.05, 0.0, torch.where(pick < 0.1, -0.0,
                                                          x))

    prior, c2v, other = (
        draw(shape, scale).to(device, dtype)
        for shape, scale in (((dec.nb_v, dec.z, B), 3.0),
                             ((dec.nb_c, dec.dc, dec.z, B), 4.0),
                             ((dec.nb_v, dec.z, B), 2.0)))
    return prior, c2v, dec.gather_totals(other)


def two_steps(dec, prior, c2v):
    """The dense loop's variable side before the pass: the prior plus the
    variable sums, rounded to storage, and those totals gathered."""
    total = (prior.to(dec.sum_dtype) + dec.scatter_partials(c2v)).to(
        prior.dtype)
    return total, dec.gather_totals(total)


@pytest.mark.parametrize("B", [8, 5])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("code", list(CODES))
def test_plain_pass_is_the_sum_and_the_gather(code, dtype, B):
    dec = QCDecoder(CODES[code](), 16, dtype, device="cpu")
    prior, c2v, t = pass_inputs(dec, dtype, B, seed=B + len(code))
    want_total, want_t = two_steps(dec, prior, c2v)
    n0 = bp_var_pass_qc.launches
    got = bp_var_pass_qc(prior, c2v, dec._var_rows, dec._var_degree, t)
    assert bp_var_pass_qc.launches == n0
    assert same_bits(got, want_total) and same_bits(t, want_t)
    padded = torch.tensor([[d >= len(row) for d in range(dec.dc)]
                           for row in dec._rows])
    assert bool(padded.any()) == (code == "ira")
    assert bool((t[padded] == BIG).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_a_lane_without_messages_adds_plus_zero(dtype):
    """Every prior and message -0: lanes with messages keep -0 (a fold of
    -0s plus a -0 prior), the lanes of the block without edges come out
    +0, as the earlier zero-filled sums gave."""
    base, z = gapped()
    dec = QCDecoder(base, z, dtype, device="cpu")
    assert dec.nb_v == 5 and int(dec._var_degree.view(5, z)[2].max()) == 0
    B = 4
    prior = torch.full((5, z, B), -0.0, dtype=dtype)
    c2v = torch.full((dec.nb_c, dec.dc, z, B), -0.0, dtype=dtype)
    t = dec.gather_totals(torch.ones((5, z, B), dtype=dtype))
    got = bp_var_pass_qc_ref(prior, c2v, dec._var_rows, dec._var_degree, t)
    want_total, want_t = two_steps(dec, prior, c2v)
    assert same_bits(got, want_total) and same_bits(t, want_t)
    negative = torch.signbit(got.float()).all(dim=(1, 2)).tolist()
    assert negative == [True, True, False, True, True]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16], ids=str)
def test_plain_pass_takes_float32_and_bfloat16_only(dtype):
    """The dtypes of ``VAR_PASS_DTYPES`` alone, as the kernel; the dense
    loop keeps its earlier steps for the others."""
    assert kernels.VAR_PASS_DTYPES == (torch.float32, torch.bfloat16)
    dec = QCDecoder(regular(), 16, device="cpu")
    prior = torch.zeros((dec.nb_v, dec.z, 8), dtype=dtype)
    c2v = torch.zeros((dec.nb_c, dec.dc, dec.z, 8), dtype=dtype)
    t = torch.zeros_like(c2v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bp_var_pass_qc_ref(prior, c2v, dec._var_rows, dec._var_degree, t)


def test_plain_pass_reads_nothing_on_the_host():
    """On meta tensors, which hold no data, the plain pass runs to its
    end: no step of it (a grouping by degree, a list of real slots) waits
    on the device, so run on the card it costs no host sync."""
    dec = QCDecoder(ira(), 16, torch.bfloat16, device="cpu")
    meta = dict(device="meta", dtype=torch.bfloat16)
    shape = (dec.nb_c, dec.dc, dec.z, 8)
    got = bp_var_pass_qc_ref(
        torch.empty((dec.nb_v, dec.z, 8), **meta), torch.empty(shape, **meta),
        dec._var_rows.to("meta"), dec._var_degree.to("meta"),
        torch.empty(shape, **meta))
    assert got.device.type == "meta"
    assert tuple(got.shape) == (dec.nb_v, dec.z, 8)


@pytest.mark.parametrize("code", list(CODES))
def test_the_table_holds_each_lanes_message_rows_in_fold_order(code):
    dec = QCDecoder(CODES[code](), 16, device="cpu")
    rows, degree = dec._var_rows, dec._var_degree
    assert rows.dtype == degree.dtype == torch.int32
    assert tuple(rows.shape) == (int(degree.max()), dec.vnum)
    for vbs, idx, deg in dec._scatter_groups:
        want = idx.view(len(vbs), deg, dec.z).permute(1, 0, 2)
        lanes = (vbs[:, None] * dec.z + torch.arange(dec.z)).reshape(-1)
        assert bool((degree[lanes] == deg).all())
        assert torch.equal(rows[:deg, lanes].long(),
                           want.reshape(deg, -1))


def _counting(dec):
    calls = []
    inner = dec.var_pass

    def var_pass(*args):
        calls.append(args[-1].data_ptr())
        return inner(*args)

    dec.var_pass = var_pass
    return calls


def _decode_inputs(dec, B, seed):
    g = torch.Generator().manual_seed(seed)
    prior = torch.randn((dec.vnum, B), generator=g)
    synd = torch.randint(0, 2, (dec.cnum, B), generator=g,
                         dtype=torch.int32)
    return prior, synd


@pytest.mark.parametrize("kw,runs", [
    (dict(dtype="float32"), True),
    (dict(dtype="bfloat16"), True),
    (dict(dtype="float32", totals_dtype="float32"), True),
    (dict(dtype="bfloat16", totals_dtype="float32"), False),
    (dict(dtype="float64"), False),
    (dict(dtype="bfloat16", sr_messages=True, check_phi="tanhfb"), False),
], ids=["f32", "bf16", "f32-f32", "bf16-f32totals", "f64", "sr"])
def test_the_loop_runs_the_pass_where_totals_are_stored_f32_or_bf16(kw,
                                                                    runs):
    """The pass (one an iteration, on one t gathered once) where the
    totals ride the message dtype, float32 or bfloat16; elsewhere the
    earlier steps, and the loop gathers every iteration.  The end test of
    every check gathers once more."""
    dec = QCDecoder(ira(), 16, device="cpu", **kw)
    calls = _counting(dec)
    gathers = []
    gather = dec._check_inputs
    dec._check_inputs = lambda total: gathers.append(1) or gather(total)
    prior, synd = _decode_inputs(dec, 6, seed=1)
    dec.decode_batched(prior, synd, 12)
    iters = dec.iterations_run
    assert iters == 12
    if runs:
        assert len(calls) == iters and len(set(calls)) == 1
        assert len(gathers) == 1 + 1
    else:
        assert not calls
        assert len(gathers) == iters + 1


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_the_decode_with_the_pass_equals_the_earlier_loop(dtype):
    """The whole dense decode, pass against the earlier two steps (the
    decoder's own fallback, forced), bit for bit on (success, iters,
    final), on the QC-IRA code with converging and failing frames."""
    base = ira()
    dec = QCDecoder(base, 16, dtype, device="cpu")
    old = QCDecoder(base, 16, dtype, device="cpu")
    side = old._variable_side
    old._variable_side = lambda prior, c2v, t: side(prior, c2v, None)
    g = torch.Generator().manual_seed(3)
    word = torch.randint(0, 2, (dec.vnum, 12), generator=g)
    prior = (1 - 2 * word).float() * 2.0 + torch.randn(word.shape,
                                                       generator=g) \
        * torch.linspace(0.5, 3.0, 12)
    synd = dec.syndrome_from_bits(word)
    got = dec.decode_batched(prior, synd, 25)
    want = old.decode_batched(prior, synd, 25)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert same_bits(got[2], want[2])
    assert 0 < int(got[0].sum()) < 12


def test_plain_pass_rejects_what_it_does_not_take():
    dec = QCDecoder(regular(), 16, torch.bfloat16, device="cpu")
    prior, c2v, t = pass_inputs(dec, torch.bfloat16, 8, seed=1)
    rows, degree = dec._var_rows, dec._var_degree
    with pytest.raises(TypeError, match="one dtype"):
        bp_var_pass_qc(prior.float(), c2v, rows, degree, t)
    with pytest.raises(TypeError, match="one dtype"):
        bp_var_pass_qc(prior, c2v, rows, degree, t.float())
    with pytest.raises(ValueError, match="must match"):
        bp_var_pass_qc(prior[..., :4], c2v, rows, degree, t)
    with pytest.raises(ValueError, match="must match"):
        bp_var_pass_qc(prior, c2v, rows, degree, t[..., :4])
    with pytest.raises(ValueError, match="must match"):
        bp_var_pass_qc(prior, c2v, rows, degree[1:], t)
    with pytest.raises(ValueError, match="must be"):
        bp_var_pass_qc(prior, c2v, rows.reshape(-1), degree, t)
    with pytest.raises(ValueError, match="contiguous"):
        bp_var_pass_qc(prior, c2v, rows, degree,
                       t.transpose(0, 1).contiguous().transpose(0, 1))


def test_a_tensor_off_the_cpu_never_reaches_the_plain_pass(monkeypatch):
    """Off the CPU the wrapper runs the kernel or raises: meta tensors (no
    card here) are refused as a device the kernel does not take, and the
    plain version is not called."""
    calls = []
    monkeypatch.setattr(kernels, "bp_var_pass_qc_ref",
                        lambda *a: calls.append(a))
    dec = QCDecoder(regular(), 16, device="cpu")
    meta = dict(device="meta", dtype=torch.bfloat16)
    shape = (dec.nb_c, dec.dc, dec.z, 8)
    args = (torch.empty((dec.nb_v, dec.z, 8), **meta),
            torch.empty(shape, **meta),
            torch.empty(tuple(dec._var_rows.shape), dtype=torch.int32,
                        device="meta"),
            torch.empty((dec.vnum,), dtype=torch.int32, device="meta"),
            torch.empty(shape, **meta))
    n0 = bp_var_pass_qc.launches
    with pytest.raises(ValueError, match="unsupported device"):
        bp_var_pass_qc(*args)
    assert not calls and bp_var_pass_qc.launches == n0


def test_pass_bound_at_the_cell_shape():
    """The bytes bound of the pass at [90, 6, 360, 128] bf16 (194,400
    edges, 64,800 lanes): messages 49.8 MB in, prior 16.6 MB in, totals
    16.6 MB and t 49.8 MB out, indices 1.0 MB, 0.0399 ms at 3.35 TB/s."""
    from qamreconciliation_tpu_torch.utils import perf

    nbytes, ops = perf.var_pass_qc_work(194400, 64800, 128, torch.bfloat16)
    assert nbytes == 133_747_200
    ms, by = perf.bound(nbytes, ops)
    assert by == "bytes" and round(ms, 4) == 0.0399


# ------------------------------------------------------------ on the card


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def card_inputs(dec, dtype, B, seed, offset=0):
    """:func:`pass_inputs` on the card; ``offset`` elements shift c2v off
    16-byte alignment."""
    prior, c2v, t = pass_inputs(dec, dtype, B, seed, device="cuda")
    if offset:
        buf = torch.empty(c2v.numel() + offset, dtype=dtype, device="cuda")
        buf[offset:] = c2v.reshape(-1)
        c2v = buf[offset:].view(c2v.shape)
    return prior, c2v, t


def assert_pass_equal(dec, prior, c2v, t):
    t_plain = t.clone()
    n0 = kernels.bp_var_pass_qc.launches
    got = kernels.bp_var_pass_qc(prior, c2v, dec._var_rows, dec._var_degree,
                                 t)
    assert kernels.bp_var_pass_qc.launches == n0 + 1
    want = bp_var_pass_qc_ref(prior, c2v, dec._var_rows, dec._var_degree,
                              t_plain)
    torch.cuda.synchronize()
    assert same_bits(got, want) and same_bits(t, t_plain)
    return got


# (code, z, B, c2v offset): the cell's code at its B, B off 8 (the f32
# path's 16 bytes still fit at 100, not at 37), B = 1, unaligned, the
# QC-IRA code's padded rows
PASS_SHAPES = [("headline", 360, 128, 0), ("headline", 360, 37, 0),
               ("regular", 16, 100, 0), ("regular", 16, 1, 0),
               ("regular", 16, 128, 1), ("ira", 16, 64, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PASS_SHAPES,
                         ids=["-".join(map(str, s)) for s in PASS_SHAPES])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pass_kernel_bit_equal_to_the_plain_pass(dtype, shape):
    need_cuda()
    code, z, B, offset = shape
    base = (make_qc_ldpc(180, 360, 3, 6, seed=12345)[0] if code == "headline"
            else CODES[code](z))
    dec = QCDecoder(base, z, dtype, device="cuda")
    prior, c2v, t = card_inputs(dec, dtype, B, seed=B, offset=offset)
    assert_pass_equal(dec, prior, c2v, t)
    wide = 16 // c2v.element_size()
    assert kernels.bp_var_pass_qc.vec == (
        wide if offset == 0 and B % wide == 0 else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pass_kernel_keeps_planted_zero_signs(dtype, B):
    """Every prior and message -0 on the code with a block without edges:
    -0 totals where a lane has messages, +0 where it has none, the kernel
    as the plain version, at B = 8 (16 bytes a thread) and 3."""
    need_cuda()
    base, z = gapped()
    dec = QCDecoder(base, z, dtype, device="cuda")
    prior = torch.full((5, z, B), -0.0, dtype=dtype, device="cuda")
    c2v = torch.full((dec.nb_c, dec.dc, z, B), -0.0, dtype=dtype,
                     device="cuda")
    t = dec.gather_totals(torch.ones((5, z, B), dtype=dtype, device="cuda"))
    got = assert_pass_equal(dec, prior, c2v, t)
    negative = torch.signbit(got.float()).all(dim=(1, 2)).tolist()
    assert negative == [True, True, False, True, True]


def _reference_decode(code_spec, B, maxiter, converging, seed):
    """The program's dense decode on the card, its launches of the pass,
    the iterations it ran and the frozen reference's decode."""
    from rrbench import codes, decoders
    from rrbench.decoders import qc_dense
    from rrbench.ref import Precision

    code = codes.build(code_spec)
    spec = {"kind": "qc_dense", "check_rule": "sumproduct",
            "check_phi": "phi"}
    g = torch.Generator().manual_seed(seed)
    n, c = code.vnum, code.cnum
    if converging:
        word = torch.randint(0, 2, (n, B), generator=g, dtype=torch.int32)
        prior = (1 - 2 * word).float() * 2.0 + 0.8 * torch.randn(
            (n, B), generator=g)
        synd = decoders.syndrome(code, word)
    else:
        prior = torch.randn((n, B), generator=g)
        synd = torch.randint(0, 2, (c, B), generator=g, dtype=torch.int32)
    prior, synd = prior.to(torch.bfloat16).cuda(), synd.cuda()
    dec = qc_dense.program(code, spec, "bfloat16", "cuda")
    n0, it0 = kernels.bp_var_pass_qc.launches, dec.iterations_run
    got = dec.decode_batched(prior, synd, maxiter)
    launched = kernels.bp_var_pass_qc.launches - n0
    ref = qc_dense.Reference(code, spec, Precision("bfloat16"), "cuda")
    want = ref.decode(prior, synd, maxiter)
    torch.cuda.synchronize()
    return got, want, launched, dec.iterations_run - it0


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ({"kind": "qc_ldpc", "nb_v": 180, "z": 360, "dv": 3, "dc": 6,
      "seed": 12345}, 128, 50, False),
    ({"kind": "qc_ldpc", "nb_v": 24, "z": 16, "dv": 3, "dc": 6, "seed": 5},
     8, 20, True),
], ids=["cell", "small-converging"])
def test_dense_decode_with_the_pass_kernel_equals_the_frozen_reference(
        case):
    """The benchmark cell's decoder (bf16, phi) on the card against
    ``rrbench/decoders/qc_dense.Reference``, bit for bit on (success,
    iters, final), one launch of the pass an iteration."""
    need_cuda()
    spec, B, maxiter, converging = case
    got, want, launched, iters = _reference_decode(spec, B, maxiter,
                                                   converging, seed=9)
    assert launched == iters > 0
    assert (iters < maxiter) if converging else (iters == maxiter)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert same_bits(got[2], want[2])
