"""The z-sharded QC decoder's roll windows (``parallel/halo.py``), rank-free.

One process plays D ranks, for D in {1, 2, 4, 8}: each rank packs what
``roll_plan`` says its peers need from its lanes, and each receives, from
every peer, exactly the rows that peer packed for it.  Each rank's
reassembled check input must then be ``torch.equal`` to the single-device
``QCDecoder.gather_totals`` on its lanes, and each rank's variable sums to
``QCDecoder.scatter_partials`` on its lanes (the same messages, folded in
the same order), in float32 and bfloat16.  The plan's counts must equal a
brute-force count of the lanes each roll reads on another rank, and fall
below an all-gather of every rank's messages for D >= 4.  The codes: a
regular ``make_qc_ldpc`` code (z = 16) and an irregular ``make_qc_ira``
code (z = 32, padded short rows), with their own random shifts, all
shifts 0, all z / D, all z - 1, and the four mixed.  Plain torch, no JAX.
"""

import numpy as np
import pytest
import torch

from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ira, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.parallel.halo import roll_plan

torch.set_num_threads(1)

CODES = {
    "regular-z16": (lambda: make_qc_ldpc(nb_v=12, z=16, dv=3, dc=6,
                                         seed=4)[0], 16),
    "irregular-z32": (lambda: make_qc_ira(nb_info=8, nb_acc=4, z=32, dv=3,
                                          seed=2)[0], 32),
}
SHIFTS = ("code", "zero", "z/D", "z-1", "mixed")
WORLDS = (1, 2, 4, 8)
B = 3
CASES = [(c, s, d) for c in CODES for s in SHIFTS for d in WORLDS]


def code_with_shifts(code, shifts, world):
    """The code's base edges with the shift rule ``shifts`` applied."""
    make, z = CODES[code]
    base = make()
    zl = z // world
    rng = np.random.default_rng(11)
    rule = {"zero": lambda k: 0, "z/D": lambda k: zl, "z-1": lambda k: z - 1,
            "mixed": lambda k: (0, zl, z - 1, int(rng.integers(z)))[k % 4]}
    if shifts != "code":
        base = [(c, v, rule[shifts](k) % z) for k, (c, v, _) in
                enumerate(base)]
    return base, z


def simulate(plans, locals_, pack):
    """Every rank's packed rows for each peer, delivered: {rank: {peer:
    rows}}, each rank receiving what its peer packed for it."""
    sent = [pack(plan, x) for plan, x in zip(plans, locals_)]
    return [{q: sent[q][r] for q in range(len(plans)) if r in sent[q]}
            for r in range(len(plans))]


def setup(code, shifts, world):
    base, z = code_with_shifts(code, shifts, world)
    dec = QCDecoder(base, z, "float32", device="cpu")
    plans = [roll_plan(dec._rows, z, world, r) for r in range(world)]
    return dec, z, plans


@pytest.mark.parametrize("code,shifts,world", CASES)
def test_check_windows_equal_gather_totals(code, shifts, world):
    """Each rank's t from its totals and the received windows equals the
    single-device gather on its lanes, sentinel slots included."""
    dec, z, plans = setup(code, shifts, world)
    total = torch.as_tensor(np.random.default_rng(1).normal(
        0, 3, (dec.nb_v, z, B)), dtype=torch.float32)
    lanes = [p.lanes for p in plans]
    locs = [total[:, lo:hi].contiguous() for lo, hi in lanes]
    recvs = simulate(plans, locs, lambda p, x: p.pack_totals(x))
    want = dec.gather_totals(total)
    for plan, loc, rv, (lo, hi) in zip(plans, locs, recvs, lanes):
        assert sorted(rv) == sorted(plan.totals_recv)
        for q, rows in rv.items():
            assert rows.shape == (plan.totals_recv[q], B)
        got = plan.check_inputs(loc, rv)
        assert torch.equal(got, want[:, :, lo:hi])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("code,shifts,world", CASES)
def test_variable_sums_equal_scatter_partials(code, shifts, world, dtype):
    """Each rank's variable sums from its messages and the received
    windows equal the single-device fold on its lanes, bit for bit."""
    dec, z, plans = setup(code, shifts, world)
    dt = getattr(torch, dtype)
    c2v = torch.as_tensor(np.random.default_rng(2).normal(
        0, 2, (dec.nb_c, dec.dc, z, B)), dtype=torch.float32).to(dt)
    c2v[0, 0, 0, 0] = -0.0
    lanes = [p.lanes for p in plans]
    locs = [c2v[:, :, lo:hi].contiguous() for lo, hi in lanes]
    recvs = simulate(plans, locs, lambda p, x: p.pack_messages(x))
    want = dec.scatter_partials(c2v)
    for plan, loc, rv, (lo, hi) in zip(plans, locs, recvs, lanes):
        assert sorted(rv) == sorted(plan.messages_recv)
        got = plan.var_sums(loc, rv, dec.sum_dtype)
        assert got.dtype == torch.float32
        assert torch.equal(got, want[:, lo:hi])


def brute_force(rows, z, world, r):
    """(check-side, variable-side) lanes rank r reads on other ranks: per
    variable block the union over its edges, per edge its roll."""
    zl = z // world
    own = set(range(r * zl, (r + 1) * zl))
    by_vb = {}
    var = 0
    for row in rows:
        for v, s in row:
            by_vb.setdefault(v, set()).update((j - s) % z for j in own)
            var += len({(i + s) % z for i in own} - own)
    return sum(len(lanes - own) for lanes in by_vb.values()), var


@pytest.mark.parametrize("code,shifts,world", CASES)
def test_plan_counts(code, shifts, world):
    """The plan's received rows equal the brute-force count, the rows each
    rank receives equal the rows its peers pack for it, every rank's sends
    mirror its peers' receives, and for D >= 4 the rows received fall below
    an all-gather of the messages."""
    dec, z, plans = setup(code, shifts, world)
    for r, plan in enumerate(plans):
        assert plan.received() == brute_force(dec._rows, z, world, r)
        for q, other in enumerate(plans):
            assert other.totals_send.get(r, torch.zeros(0)).numel() == \
                plan.totals_recv.get(q, 0)
            assert other.messages_send.get(r, torch.zeros(0)).numel() == \
                plan.messages_recv.get(q, 0)
        if world == 1:
            assert plan.received() == (0, 0) and plan.all_gather_rows() == 0
        if world >= 4:
            assert sum(plan.received()) < plan.all_gather_rows()
        if shifts == "zero":
            assert plan.received() == (0, 0)
    # the elements a simulated exchange delivers are the plan's
    total = torch.zeros((dec.nb_v, z, B))
    c2v = torch.zeros((dec.nb_c, dec.dc, z, B))
    got_t = simulate(plans, [total[:, slice(*p.lanes)] for p in plans],
                     lambda p, x: p.pack_totals(x))
    got_m = simulate(plans, [c2v[:, :, slice(*p.lanes)] for p in plans],
                     lambda p, x: p.pack_messages(x))
    for plan, rt, rm in zip(plans, got_t, got_m):
        assert (sum(x.numel() for x in rt.values()),
                sum(x.numel() for x in rm.values())) == tuple(
            B * n for n in plan.received())


def test_plan_headline_counts():
    """The headline code (``make_qc_ldpc(180, 360, 3, 6, seed=12345)``):
    the rows rank 0 receives an iteration, check side and variable side,
    against an all-gather's; at B = 128 that is 10.21 M elements against
    12.44 M at D = 2, 8.45 M against 18.66 M at D = 4 and 5.12 M against
    21.77 M at D = 8."""
    base, _, _ = make_qc_ldpc(180, 360, 3, 6, seed=12345)
    rows = [[] for _ in range(90)]
    for c, v, s in base:
        rows[c].append((v, s))
    want = {2: ((28612, 51124), 97200), 4: ((28202, 37805), 145800),
            8: ((18427, 21600), 170100)}
    for world, (received, gathered) in want.items():
        plan = roll_plan(rows, 360, world, 0)
        assert plan.received() == received
        assert plan.all_gather_rows() == gathered
        assert sum(received) < gathered


def test_plan_rejects_bad_meshes():
    rows = [[(0, 1), (1, 2)], [(1, 0), (0, 3)]]
    with pytest.raises(ValueError, match="divisible"):
        roll_plan(rows, 6, 4, 0)
    with pytest.raises(ValueError, match="outside"):
        roll_plan(rows, 8, 4, 4)
