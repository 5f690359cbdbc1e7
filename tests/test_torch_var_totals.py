"""Gather 2 of the generic decoder (``ops/kernels.bp_var_totals_generic``)
on the CPU: its plain version equals the masked fold over every slot that
``Decoder.var_totals`` ran before the kernel, bit for bit, zero signs
included, on an irregular graph with a wide variable, a degree-1 one and one
with no edge; the padded slots' +-0 decides the sign of a fold of -0; the
wrapper's arguments and its dispatch (a tensor off the CPU never reaches the
plain version).  The kernel itself is held to the plain version on the card
by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from qamreconciliation_tpu_torch.models.decoder import Decoder, TannerGraph
from qamreconciliation_tpu_torch.ops import kernels
from qamreconciliation_tpu_torch.ops.kernels import (
    bp_var_totals_generic, bp_var_totals_generic_ref, var_totals_vec,
)

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16, torch.float64]
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
        torch.float64: torch.int64}


def irregular_edges(seed=0, V=48, C=20):
    """(e_to_v, e_to_c) in shuffled edge-id order: variable 0 of degree 10
    (dv_max), variable 1 of degree 1, variable 7 with no edge, the rest of
    degree 2-5, each variable's checks distinct."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(2, 6, V)
    deg[0], deg[1], deg[7] = 10, 1, 0
    vid = np.repeat(np.arange(V), deg)
    cid = np.concatenate([rng.choice(C, d, replace=False) for d in deg])
    order = rng.permutation(vid.size)
    return vid[order], cid[order]


def sum_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def todays_fold(g, prior, c2v, dtype):
    """``Decoder.var_totals`` before the kernel: every one of the dv_max
    slots gathered, widened, multiplied by its 0/1 mask and added in slot
    order, then the prior, rounded once."""
    v_mask_T = torch.as_tensor(g._v_mask_T_np).to(sum_dtype(dtype))
    flat = c2v.reshape(-1, c2v.shape[-1])
    idx = g.on("cpu")["v_from_c_T"]
    acc = None
    for d in range(g.dv_max):
        x = flat.index_select(0, idx[d]).to(sum_dtype(dtype)) \
            * v_mask_T[d][:, None]
        acc = x if acc is None else acc + x
    return (prior + acc).to(dtype)


def fold_inputs(g, dtype, B, seed=1):
    """prior [V, B] (rounded to ``dtype``, held in its sum dtype) and c2v
    [dc_max, C, B] with zero padded slots, as the check phase writes them,
    and a share of exact +-0 messages."""
    rng = np.random.default_rng(seed)
    c2v = rng.normal(0, 4, (g.dc_max, g.cnum, B))
    c2v[rng.random(c2v.shape) < 0.1] = 0.0
    c2v[rng.random(c2v.shape) < 0.1] = -0.0
    c2v *= g._c_mask_T_np[:, :, None]
    prior = rng.normal(0, 3, (g.vnum, B))
    prior[rng.random(prior.shape) < 0.1] = -0.0
    return (torch.from_numpy(prior).to(dtype).to(sum_dtype(dtype)),
            torch.from_numpy(c2v).to(dtype))


def same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(BITS[a.dtype]),
                                              b.view(BITS[b.dtype]))


def test_the_graph_has_the_shapes_the_fold_must_take():
    g = TannerGraph(*irregular_edges())
    assert g.dv_max == 10 and g.dv[1] == 1 and g.dv[7] == 0
    tb = g.on("cpu")
    assert tb["v_from_c_T_i"].dtype == tb["dv_i"].dtype == torch.int32
    # each variable's real slots are the table's first rows
    np.testing.assert_array_equal(
        g._v_mask_T_np, np.arange(g.dv_max)[:, None] < g.dv[None, :])


@pytest.mark.parametrize("B", [1, 5, 16])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_fold_equals_todays_fold(dtype, B):
    g = TannerGraph(*irregular_edges())
    prior, c2v = fold_inputs(g, dtype, B)
    tb = g.on("cpu")
    got = bp_var_totals_generic_ref(prior, c2v, tb["v_from_c_T_i"],
                                    tb["dv_i"])
    want = todays_fold(g, prior, c2v, dtype)
    assert same_bits(got, want)
    # the int64 table of the earlier loop gives the same
    assert same_bits(bp_var_totals_generic_ref(
        prior, c2v, tb["v_from_c_T"], tb["dv_i"]), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decoder_var_totals_on_the_cpu_is_todays_fold(dtype):
    vid, cid = irregular_edges(seed=3)
    dec = Decoder(vid, cid, dtype, device="cpu")
    prior, c2v = fold_inputs(dec.graph, dtype, 12, seed=4)
    n0 = bp_var_totals_generic.launches
    got = dec.var_totals(prior, c2v)
    assert bp_var_totals_generic.launches == n0
    assert same_bits(got, todays_fold(dec.graph, prior, c2v, dtype))


def planted_zero_graph():
    """Six variables on four checks: 0 and 5 of degree 4 (dv_max), 1 and 4
    of degree 2, 2 of degree 1, 3 with no edge.  Edge 0, (0, 0), is c2v's
    row 0 (check 0's first slot)."""
    edges = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (2, 2), (4, 3),
             (4, 1), (5, 0), (5, 1), (5, 2), (5, 3)]
    vid, cid = (np.array(x) for x in zip(*edges))
    return vid, cid


def planted_zero_inputs(g, dtype, row0, B=3):
    """Every message -0 but row 0's (``row0``), every prior -0."""
    c2v = torch.full((g.dc_max, g.cnum, B), -0.0, dtype=torch.float64)
    c2v *= torch.as_tensor(g._c_mask_T_np)[:, :, None]
    c2v[0, 0] = row0
    prior = torch.full((g.vnum, B), -0.0, dtype=torch.float64)
    return prior.to(sum_dtype(dtype)), c2v.to(dtype)


@pytest.mark.parametrize("row0", [1.5, -1.5])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_padded_slots_decide_the_sign_of_a_zero_fold(dtype, row0):
    """A variable whose real messages and prior are all -0 comes out +0
    when it has padded slots and row 0 is positive (its slots add +0),
    -0 when row 0 is negative or when it has no padded slot."""
    g = TannerGraph(*planted_zero_graph())
    assert g.dv_max == 4 and list(g.dv) == [4, 2, 1, 0, 2, 4]
    prior, c2v = planted_zero_inputs(g, dtype, row0)
    tb = g.on("cpu")
    got = bp_var_totals_generic_ref(prior, c2v, tb["v_from_c_T_i"],
                                    tb["dv_i"])
    assert same_bits(got, todays_fold(g, prior, c2v, dtype))
    negative = torch.signbit(got.float()).all(dim=1).tolist()
    padded_sign = row0 < 0
    # variable 0 holds row 0 itself; 5 has no padded slot
    assert negative[1:] == [padded_sign] * 4 + [True]
    assert (got[1:5] == 0).all() and (got[5] == 0).all()


def test_plain_fold_rejects_what_it_does_not_take():
    g = TannerGraph(*irregular_edges())
    prior, c2v = fold_inputs(g, torch.bfloat16, 4)
    tb = g.on("cpu")
    table, dv = tb["v_from_c_T_i"], tb["dv_i"]
    with pytest.raises(TypeError, match="sum dtype"):
        bp_var_totals_generic(prior.bfloat16(), c2v, table, dv)
    with pytest.raises(TypeError, match="sum dtype"):
        bp_var_totals_generic(prior, c2v.double(), table, dv)
    with pytest.raises(ValueError, match="match"):
        bp_var_totals_generic(prior[:, :3], c2v, table, dv)
    with pytest.raises(ValueError, match="match"):
        bp_var_totals_generic(prior, c2v, table[:, 1:], dv)
    with pytest.raises(ValueError, match="must be"):
        bp_var_totals_generic(prior, c2v, table.reshape(-1), dv)


def test_a_tensor_off_the_cpu_never_reaches_the_plain_fold(monkeypatch):
    """Off the CPU the wrapper runs the kernel or raises: meta tensors (no
    card here) are refused as a device the kernel does not take, and the
    plain version is not called."""
    calls = []
    monkeypatch.setattr(kernels, "bp_var_totals_generic_ref",
                        lambda *a: calls.append(a))
    g = TannerGraph(*irregular_edges())
    tb = g.on("cpu")
    meta = dict(device="meta")
    args = (torch.empty((g.vnum, 8), **meta),
            torch.empty((g.dc_max, g.cnum, 8), dtype=torch.bfloat16, **meta),
            torch.empty(tuple(tb["v_from_c_T_i"].shape), dtype=torch.int32,
                        **meta),
            torch.empty((g.vnum,), dtype=torch.int32, **meta))
    n0 = bp_var_totals_generic.launches
    with pytest.raises(ValueError, match="unsupported device"):
        bp_var_totals_generic(*args)
    assert not calls and bp_var_totals_generic.launches == n0


@pytest.mark.parametrize("B,size,aligned,vec", [
    (128, 2, True, 8), (128, 4, True, 4), (8, 2, True, 8), (4, 4, True, 4),
    (100, 2, True, 1), (100, 4, True, 4), (6, 4, True, 1), (1, 2, True, 1),
    (128, 2, False, 1), (128, 4, False, 1)])
def test_frames_a_thread(B, size, aligned, vec):
    """16 bytes of a row a thread where B fills whole 16-byte units and the
    pointers line up, else one frame."""
    assert var_totals_vec(B, size, aligned) == vec


def test_fold_bound_at_the_dvbs2_shape():
    """The bytes bound of the fold on the DVB-S2 rate-1/2 H (226,799 edges,
    64,800 variables, 51,840 of them under dv_max = 8), B = 128 bf16: the
    real rows 58.1 MB, the f32 prior 33.2 MB, the totals 16.6 MB and the
    indices 1.2 MB, 0.0325 ms at 3.35 TB/s."""
    from qamreconciliation_tpu_torch.utils import perf

    nbytes, ops = perf.var_totals_generic_work(226799, 64800, 128,
                                               torch.bfloat16, 51840)
    assert nbytes == 108993596
    ms, by = perf.bound(nbytes, ops)
    assert by == "bytes" and round(ms, 4) == 0.0325
