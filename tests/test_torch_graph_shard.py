"""Port parity: the graph-sharded decoders (``parallel/graph_shard.py``) at
world size 2, against the JAX package's on 2 of the 8 virtual CPU devices
and against the port's single-device decoders; and ``ShardedQCDecoder``
at world size 4, against JAX's on 4 of them.

The port's ranks run once a world size for the whole file (``ranks``,
``ranks4``): processes started by ``parallel.mesh.run_ranks`` (spawn,
gloo, a file store under a temporary directory), which import only the
port and this module, whose JAX imports stay inside the tests.  The
numpy-seeded inputs go to the ranks; their results come back here.

Tiers:
* ``ShardedDecoder`` splits the checks and sums per-rank partial sums of
  the variable totals, which reorders each variable's additions: like the
  JAX package's, it is NOT bit-equal to the single-device decoder.
  ``success`` and ``iters`` are equal; ``final`` agrees within 1e-9 in
  float64 (the JAX file's tolerance), in float32 in every hard decision
  and within ``F32_TOL`` on each converged frame of these inputs (see
  ``F32_TOL``), and within ``BF16_TOL`` in bfloat16.
* ``ShardedQCDecoder`` splits the circulant lanes, each rank holding
  ``z / D`` of them, exchanges only the roll windows it reads, point to
  point, and folds each variable lane's messages in the single-device
  order: bit-equal to the port's single-device ``QCDecoder``, as the JAX
  package's is to its own.  Against JAX's it is equal for min-sum and
  within float32 rounding (``F32_TOL``) for sum-product, whose phi runs on
  each library's libm.
"""

import csv
import os

import numpy as np
import pytest
import torch

from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ira, make_qc_ldpc, save_qc_csv,
)
from qamreconciliation_tpu_torch.parallel import (
    ShardedDecoder, ShardedQCDecoder, make_mesh, run_ranks,
)
from qamreconciliation_tpu_torch.parallel.mesh import Mesh
from qamreconciliation_tpu_torch.sims import sim_reconciliation
from qamreconciliation_tpu_torch.utils.edgefile import (
    make_regular_ldpc, save_edge_csv,
)

torch.set_num_threads(1)

WORLD = 2
WORLD4 = 4
# float32 finals: each total is a sum of at most dv_max + 1 float32 terms
# rounded once, here in another order (the per-rank partial sums), and the
# check nonlinearity carries such differences on from iteration to
# iteration.  Two rules bind them.  (1) Every hard decision of every frame
# is equal (the decoded words, which every counter and the stream's bit
# errors read), with success and iters.  (2) On these test inputs, each
# converged frame's largest |got - want| <= atol + rtol * its largest
# |want| (a reordered sum errs by ulps of its largest terms, not of itself).
# Rule (2) does not hold at every scale: the phi rule's extrinsic
# magnitude is phi(S - phi_i), a difference of nearly equal terms when one
# input dominates a row, so a one-ulp change of S moves that message
# between phi of the smallest representable difference (~15 at |S| ~ 4.6)
# and phi's clamp (~69.8); the exact DVB-S2 rate-1/2 H on the H100 showed
# one element of a converged frame 33.3 apart, every hard decision equal.
# chip_smoke.py holds the card's sharded decodes to rule (1), to at most
# 1e-5 of the elements beyond atol + rtol * |want|, and to each converged
# frame's median element within that bound.  Measured under rule (2): <= 1.6e-5 absolute on these
# inputs (30 iterations), 3.8e-4 of the largest total on a 4096-bit code
# at 50 iterations; 1.3e-3 relative for the one-ulp libm drift of
# sum-product at the headline after 50 iterations (ROADMAP.md, faults
# section); rtol 4e-3 and atol 1e-3 bound them with margin.
F32_TOL = dict(rtol=4e-3, atol=1e-3)
# bfloat16 messages: the totals sum in float32 and round once to bf16;
# partial sums of bf16 terms are exact in float32 unless their exponents
# spread over more than 16 bits, so the sharded total rounds to the same
# bf16 or, at worst, a neighbour: one bf16 ulp (2^-7 relative), elementwise
BF16_TOL = dict(rtol=2.0 ** -7, atol=0.0)


RULES = {
    "phi": {},
    "minsum-offset": dict(check_rule="minsum", minsum_alpha=1.0,
                          minsum_beta=0.3),
    "minsum": dict(check_rule="minsum"),
    "tanhfb": dict(check_phi="tanhfb"),
}


def assert_finals_close(got, want, dtype, success):
    """``final`` [B, V] within the dtype's tolerance: elementwise on every
    frame for float64 (1e-9, the JAX file's) and bf16; for float32 every
    hard decision equal and, per frame, F32_TOL on the frames that
    converged (``success``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if dtype == "float32":
        np.testing.assert_array_equal(got < 0, want < 0)
        diff = np.abs(got - want).max(axis=1)
        bound = F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(want).max(axis=1)
        assert (diff <= bound)[np.asarray(success, bool)].all(), (diff, bound)
        return
    tol = dict(rtol=1e-9, atol=1e-9) if dtype == "float64" else BF16_TOL
    np.testing.assert_allclose(got, want, **tol)


def generic_code(n):
    return make_regular_ldpc(n, 3, 6, seed=31)


def qc_code(irregular, z=16):
    if irregular:
        return make_qc_ira(nb_info=8, nb_acc=4, z=z, dv=3, seed=2)
    return make_qc_ldpc(nb_v=12, z=z, dv=3, dc=6, seed=4)


def generic_inputs(case):
    n, seed, B, scale, sd = case["n"], case["seed"], case["B"], \
        case["scale"], case["sd"]
    vid, cid = generic_code(n)
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 2, (B, mat.vnum))
    synd = np.asarray(mat.eval_syndrome(word))
    if case.get("hopeless"):
        llr = rng.normal(0, 0.5, (B, mat.vnum))
    else:
        llr = (1 - 2 * word) * scale + (rng.normal(0, sd, (B, mat.vnum))
                                        if sd else 0.0)
    return vid, cid, llr, synd


def qc_inputs(case):
    base, vid, cid = qc_code(case["irregular"])
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(23)
    word = rng.integers(0, 2, (6, mat.vnum))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, 2.0, (6, mat.vnum))
    return base, vid, cid, llr, synd


def as_np(out):
    return tuple(x.float().numpy() if x.dtype == torch.bfloat16
                 else x.numpy() for x in out)


# decoded by every test below: generic (n, seed, B, maxiter, rule, dtype),
# QC (irregular, rule, dtype)
GENERIC = {
    f"{n}-{rule}-{dt}": dict(n=n, seed=3 if rule == "phi" else 17,
                             B=6 if rule == "phi" else 5, scale=3.0, sd=2.0,
                             maxiter=30 if rule == "phi" else 25, rule=rule,
                             dtype=dt)
    for n in (240, 246, 252) for rule in RULES
    for dt in ("float64", "float32")
    if n == 240 or rule == "phi"
}
GENERIC.update({f"240-{rule}-bfloat16": dict(
    n=240, seed=17, B=5, scale=3.0, sd=2.0, maxiter=25, rule=rule,
    dtype="bfloat16") for rule in ("phi", "minsum")})
GENERIC["passthrough"] = dict(n=240, seed=5, B=3, scale=5.0, sd=0.0,
                              maxiter=20, rule="phi", dtype="float64")
GENERIC["hopeless"] = dict(n=240, seed=7, B=2, scale=0.0, sd=0.0,
                           maxiter=5, rule="phi", dtype="float64",
                           hopeless=True)
QC = {f"{'irregular' if irr else 'regular'}-{rule}-{dt}": dict(
    irregular=irr, rule=rule, dtype=dt)
    for irr in (False, True) for rule in ("phi", "minsum", "tanhfb")
    for dt in ("float32", "bfloat16")}


def _ranks_body(generic, qc, cli_dir):
    """One rank: every generic and QC case through the sharded decoder and
    the single-device one, an engine sweep with each, and the CLIs."""
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine

    mesh = make_mesh(WORLD, "gs", device="cpu")
    out = {"rank": mesh.rank, "generic": {}, "qc": {}, "rows": {}}
    for name, case in generic.items():
        vid, cid, llr, synd = generic_inputs(case)
        kw = dict(dtype=case["dtype"], **RULES[case["rule"]])
        sdec = ShardedDecoder(vid, cid, mesh, **kw)
        assert sdec.c_per_dev == -(-sdec.cnum // WORLD)
        out["rows"][name] = sdec._c_rows
        got = sdec.decode_batch(llr, synd, case["maxiter"])
        want = Decoder(vid, cid, device="cpu", **kw).decode_batch(
            llr, synd, case["maxiter"])
        out["generic"][name] = (as_np(got), as_np(want))
    for name, case in qc.items():
        base, vid, cid, llr, synd = qc_inputs(case)
        kw = dict(dtype=case["dtype"], **RULES[case["rule"]])
        got = ShardedQCDecoder(base, 16, mesh, **kw).decode_batch(
            llr, synd, 30)
        want = QCDecoder(base, 16, device="cpu", **kw).decode_batch(
            llr, synd, 30)
        out["qc"][name] = (as_np(got), as_np(want))

    # an engine sweep with each sharded decoder against the unsharded one
    pa = PAMAlphabet(2, 2.0)
    run = dict(decoder_iterations=15, simulation_loops=32,
               ferr_count_min=10 ** 9, seed=3, nmconfig=np.zeros(4, np.uint8))
    vid, cid = make_regular_ldpc(240, 3, 6, seed=13)
    base, qvid, qcid = qc_code(False)
    sweeps = {}
    for name, sharded, single, (v, c) in (
            ("generic", ShardedDecoder(vid, cid, mesh, dtype="float64"),
             Decoder(vid, cid, "float64", device="cpu"), (vid, cid)),
            ("qc", ShardedQCDecoder(base, 16, mesh, check_rule="minsum"),
             QCDecoder(base, 16, device="cpu", check_rule="minsum"),
             (qvid, qcid))):
        res = [ReconciliationEngine(dec, Matrix(v, c), pa, batch=16,
                                    dtype=dec.dtype).run_point(
            "softening", 5.0, **run) for dec in (sharded, single)]
        sweeps[name] = [(r.frames, r.ber, r.fer, r.iters) for r in res]
    out["sweeps"] = sweeps

    # the CLI as a rank of this group: --graph-shard over --devices 2
    common = ["--maxiter", "10", "--simloops", "32", "--snr", "6", "6",
              "--nsnr", "1", "--batch", "16", "--device", "cpu"]
    cli = {}
    for name, argv in (
            ("qc", [os.path.join(cli_dir, "qc.csv"), "--qc", "--check-rule",
                    "minsum", "--minsum-alpha", "1.0", "--minsum-beta",
                    "0.25"]),
            ("generic", [os.path.join(cli_dir, "code.csv"), "--dtype",
                         "float64"])):
        res = sim_reconciliation.main(
            argv + common + ["--graph-shard", "--devices", str(WORLD),
                             "--out", os.path.join(cli_dir, f"{name}.csv")])
        cli[name] = [(r.frames, r.ber, r.fer, r.iters) for r in res]
    out["cli"] = cli
    out["state"] = _qc_loop_state(mesh)
    return out


def _qc_loop_state(mesh):
    """One min-sum decode of the regular QC case through a ShardedQCDecoder
    on ``mesh``, recording the shapes of its loop state (the prior its
    variable side keeps, the check phase's t, messages and syndrome, the
    totals each gather reads and each variable side makes, and the finals
    made whole, as pairs of a total's and a final's shape, and the finals
    returned) and the collectives it issues."""
    base, _, _, llr, synd = qc_inputs(QC["regular-minsum-float32"])
    dec = ShardedQCDecoder(base, 16, mesh, check_rule="minsum")
    seen = {"prior": set(), "check": set(), "calls": {}}
    totals, finals = set(), set()

    def counting(name, fn):
        def call(*a, **k):
            seen["calls"][name] = seen["calls"].get(name, 0) + 1
            return fn(*a, **k)
        return call

    phase, gather = dec.check_phase, dec._check_inputs
    var_side, whole = dec._variable_side, dec._whole_finals

    def check_phase(t, c2v, synd, **kw):
        seen["check"].add((tuple(t.shape), tuple(c2v.shape),
                           tuple(synd.shape)))
        return phase(t, c2v, synd, **kw)

    def check_inputs(total):
        seen["calls"]["gather"] = seen["calls"].get("gather", 0) + 1
        totals.add(tuple(total.shape))
        return gather(total)

    def variable_side(prior, c2v, t):
        seen["prior"].add(tuple(prior.shape))
        total, t_next = var_side(prior, c2v, t)
        totals.add(tuple(total.shape))
        key = "pass, no t" if t_next is None else "pass, t"
        seen["calls"][key] = seen["calls"].get(key, 0) + 1
        return total, t_next

    def whole_finals(final):
        finals.add(tuple(final.shape))
        return whole(final)

    dec.check_phase, dec._check_inputs = check_phase, check_inputs
    dec._variable_side, dec._whole_finals = variable_side, whole_finals
    for name in ("all_gather", "exchange", "all_reduce_sum"):
        setattr(mesh, name, counting(name, getattr(mesh, name)))
    try:
        out = dec.decode_batch(llr, synd, 30)
    finally:
        for name in ("all_gather", "exchange", "all_reduce_sum"):
            delattr(mesh, name)
    seen["state"] = {(t, f) for t in totals for f in finals}
    seen["iterations"] = dec.iterations_run
    seen["final"] = tuple(out[2].shape)
    seen["plan"] = dict(dec.plan.totals_recv), dict(dec.plan.messages_recv)
    return seen


def _ranks4_body(qc):
    """One of four ranks: every QC case through ShardedQCDecoder and the
    single-device QCDecoder, the SR option, the loop state's shapes, and
    Mesh.exchange on bf16 bytes."""
    mesh = make_mesh(WORLD4, "gs", device="cpu")
    out = {"rank": mesh.rank, "qc": {}}
    for name, case in qc.items():
        base, vid, cid, llr, synd = qc_inputs(case)
        kw = dict(dtype=case["dtype"], **RULES[case["rule"]])
        got = ShardedQCDecoder(base, 16, mesh, **kw).decode_batch(
            llr, synd, 30)
        want = QCDecoder(base, 16, device="cpu", **kw).decode_batch(
            llr, synd, 30)
        out["qc"][name] = (as_np(got), as_np(want))
    base, _, _, llr, synd = qc_inputs(QC["regular-tanhfb-bfloat16"])
    kw = dict(dtype="bfloat16", check_phi="tanhfb", sr_messages=True)
    out["sr"] = (as_np(ShardedQCDecoder(base, 16, mesh, **kw).decode_batch(
        llr, synd, 30)), as_np(QCDecoder(base, 16, device="cpu", **kw)
                              .decode_batch(llr, synd, 30)))
    out["state"] = _qc_loop_state(mesh)

    # each rank sends each peer a bf16 row holding -0.0, NaN and its own
    # and the peer's numbers; rank r sends nothing to r + 1 (mod 4), so
    # the exchange's peers differ from rank to rank
    r = mesh.rank

    def row(src, dst):
        x = torch.tensor([-0.0, float("nan"), src + 0.5, dst - 0.25, 1e-40],
                         dtype=torch.float32).to(torch.bfloat16)
        return x.repeat(src + dst + 1)

    skip = lambda src: (src + 1) % WORLD4
    sends = {q: row(r, q) for q in range(WORLD4)
             if q != r and q != skip(r)}
    shapes = {q: tuple(row(q, r).shape) for q in range(WORLD4)
              if q != r and skip(q) != r}
    got = mesh.exchange(sends, shapes, torch.bfloat16)
    out["exchange"] = (sorted(got), all(
        torch.equal(got[q].view(torch.int16), row(q, r).view(torch.int16))
        for q in got))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cli_dir = str(tmp_path_factory.mktemp("graph_shard_cli"))
    base, _, _ = qc_code(False)
    save_qc_csv(os.path.join(cli_dir, "qc.csv"), base, 16)
    save_edge_csv(os.path.join(cli_dir, "code.csv"),
                  *make_regular_ldpc(240, 3, 6, seed=13))
    results = run_ranks(_ranks_body, WORLD, (GENERIC, QC, cli_dir),
                        device="cpu", timeout=240)
    assert [r["rank"] for r in results] == list(range(WORLD))
    return results, cli_dir


@pytest.fixture(scope="module")
def ranks4():
    results = run_ranks(_ranks4_body, WORLD4, (QC,), device="cpu",
                        timeout=240)
    assert [r["rank"] for r in results] == list(range(WORLD4))
    return results


def _jax_mesh(world=WORLD):
    import jax
    from jax.sharding import Mesh as JMesh

    return JMesh(np.array(jax.devices()[:world]), ("gs",))


def _jax_generic(case):
    import jax.numpy as jnp
    from qamreconciliation_tpu.parallel.graph_shard import (
        ShardedDecoder as JSharded,
    )

    vid, cid, llr, synd = generic_inputs(case)
    dec = JSharded(vid, cid, _jax_mesh(), dtype=jnp.dtype(case["dtype"]),
                   **RULES[case["rule"]])
    return tuple(np.asarray(x) for x in dec.decode_batch(
        llr, synd, case["maxiter"]))


def test_ranks_replicate_their_results(ranks):
    """Every rank returns the same decodes: frames stay whole and the
    outputs are replicated."""
    (r0, r1), _ = ranks
    for kind in ("generic", "qc"):
        for name in r0[kind]:
            for a, b in zip(r0[kind][name][0], r1[kind][name][0]):
                np.testing.assert_array_equal(a, b)
    assert r0["sweeps"] == r1["sweeps"] and r0["cli"] == r1["cli"]


@pytest.mark.parametrize("name", [k for k in GENERIC
                                  if k not in ("passthrough", "hopeless")])
def test_sharded_decoder_matches_jax_and_single_device(ranks, name):
    """Check-sharded decoder against JAX's ShardedDecoder (2 devices) and
    the port's single-device Decoder: success and iters equal, final
    within 1e-9 (float64), F32_TOL (float32) or BF16_TOL (bf16, against
    the single device); min-sum, offset min-sum, tanh-F/B and phi.  The
    240- and 252-bit codes split their 120 and 126 checks evenly; the
    246-bit code pads its 123 checks to 2 x 62, so rank 1 holds one
    padded check (no real slot, syndrome 0)."""
    case = GENERIC[name]
    rows = [r["rows"][name] for r in ranks[0]]
    cnum = case["n"] // 2
    assert sum(rows) == cnum
    if cnum % WORLD:
        assert rows == [cnum // WORLD + 1, cnum // WORLD]
    got, single = ranks[0][0]["generic"][name]
    s, i, f = got
    # JAX's bf16 decoder is held to the port's elsewhere; here bf16 is held
    # to the port's single device
    wants = [single] if case["dtype"] == "bfloat16" \
        else [_jax_generic(case), single]
    for want in wants:
        np.testing.assert_array_equal(s, want[0])
        np.testing.assert_array_equal(i, want[1])
        assert_finals_close(f, want[2], case["dtype"], want[0])
    assert int(s.sum()) > 0


def test_sharded_consistent_passthrough(ranks):
    """A consistent input passes through: success, iters 0, final = LLRs."""
    s, i, f = ranks[0][0]["generic"]["passthrough"][0]
    _, _, llr, _ = generic_inputs(GENERIC["passthrough"])
    assert s.all()
    np.testing.assert_array_equal(i, np.zeros(3, np.int32))
    np.testing.assert_allclose(f, llr)


def test_sharded_failure_semantics(ranks):
    """Frames that fail report max_iterations, as JAX's sharded decoder."""
    (s, i, _), single = ranks[0][0]["generic"]["hopeless"]
    js, ji, _ = _jax_generic(GENERIC["hopeless"])
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(i, single[1])
    assert all(int(i[k]) == 5 for k in range(2) if not s[k])


def _chip_smoke():
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", [k for k, c in GENERIC.items()
                                  if c["dtype"] == "float32"])
def test_card_finals_rule_catches_a_wrong_exchange(ranks, name):
    """The rule that chip_smoke.py holds the card's float32 ShardedDecoder
    finals to (``shard_finals``) accepts the world-2 decodes of these
    inputs and rejects a wrong exchange that leaves the hard decisions
    alone: the check-to-variable sums counted twice, or scaled by 0.9, on
    the frames already decided, wherever that keeps the sign."""
    shard_finals = _chip_smoke().shard_finals
    (_, _, f), (ws, _, wf) = ranks[0][0]["generic"][name]
    got, want = torch.as_tensor(f.T), torch.as_tensor(wf.T)
    success = torch.as_tensor(ws)
    assert shard_finals(got, want, success, torch.float32)[0]
    _, _, llr, _ = generic_inputs(GENERIC[name])
    ext = want - torch.as_tensor(llr.T, dtype=torch.float32)
    for wrong in (want + ext, want - 0.1 * ext):
        bad = torch.where(success & ((wrong < 0) == (want < 0)), wrong, want)
        assert torch.equal(bad < 0, want < 0)
        assert not shard_finals(bad, want, success, torch.float32)[0]


@pytest.mark.parametrize("name", list(QC))
def test_sharded_qc_bit_equal_single_device_and_matches_jax(ranks, name):
    """z-sharded QC decoder (lanes split, roll windows exchanged and each
    variable lane folded in the single-device order): bit-equal to the
    port's single-device QCDecoder, regular and irregular (QC-IRA) codes;
    against JAX's ShardedQCDecoder equal for min-sum, within F32_TOL for
    sum-product (float32 cases; bf16 ones are held to the port's single
    device)."""
    case = QC[name]
    got, single = ranks[0][0]["qc"][name]
    for a, b in zip(got, single):
        np.testing.assert_array_equal(a, b)
    assert int(got[0].sum()) > 0
    if case["dtype"] != "float32":
        return
    js, ji, jf = _jax_sharded_qc(case, WORLD)
    np.testing.assert_array_equal(got[0], js)
    np.testing.assert_array_equal(got[1], ji)
    if case["rule"] == "minsum":
        np.testing.assert_array_equal(got[2], jf)
    else:
        assert_finals_close(got[2], jf, "float32", js)


def _jax_sharded_qc(case, world):
    import jax.numpy as jnp
    from qamreconciliation_tpu.parallel.graph_shard import (
        ShardedQCDecoder as JShardedQC,
    )

    base, _, _, llr, synd = qc_inputs(case)
    dec = JShardedQC(base, 16, _jax_mesh(world), dtype=jnp.float32,
                     **RULES[case["rule"]])
    return tuple(np.asarray(x) for x in dec.decode_batch(llr, synd, 30))


@pytest.mark.parametrize("name", list(QC))
def test_sharded_qc_world4_bit_equal_single_device_and_matches_jax(ranks4,
                                                                   name):
    """At world size 4 (z = 16: four lanes a rank, so most rolls read
    other ranks' lanes): every rank returns the same decode, bit-equal to
    the port's single-device QCDecoder; against JAX's ShardedQCDecoder on
    4 devices equal for min-sum, within F32_TOL for sum-product (float32
    cases; bf16 ones are held to the port's single device)."""
    case = QC[name]
    got, single = ranks4[0]["qc"][name]
    for r in ranks4[1:]:
        for a, b in zip(r["qc"][name][0], got):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(got, single):
        np.testing.assert_array_equal(a, b)
    assert int(got[0].sum()) > 0
    if case["dtype"] != "float32":
        return
    js, ji, jf = _jax_sharded_qc(case, WORLD4)
    np.testing.assert_array_equal(got[0], js)
    np.testing.assert_array_equal(got[1], ji)
    if case["rule"] == "minsum":
        np.testing.assert_array_equal(got[2], jf)
    else:
        assert_finals_close(got[2], jf, "float32", js)


def test_sharded_qc_sr_messages_bit_equal_at_world4(ranks4):
    """With stochastically rounded bf16 messages each rank draws every
    lane's bits and keeps its own: bit-equal to the single device."""
    for r in ranks4:
        got, single = r["sr"]
        for a, b in zip(got, single):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [WORLD, WORLD4])
def test_sharded_qc_loop_state_has_z_over_d_lanes(ranks, ranks4, world):
    """Each rank's loop state holds z / D lanes: the prior it keeps and the
    totals and finals [nb_v, z / D, B], the check phase's t and messages
    [nb_c, dc, z / D, B] and syndrome [nb_c, z / D, B].  An iteration
    issues two exchanges (the roll windows of the totals, then of the
    messages) and one all-reduce of the violation counts; the decode's one
    all-gather makes the finals [B, V] after the last iteration, and the
    end test of every check costs one more exchange and all-reduce."""
    results = ranks[0] if world == WORLD else ranks4
    zl, B = 16 // world, 6
    for r in results:
        st = r["state"]
        its = st["iterations"]
        assert its > 0
        assert st["prior"] == {(12, zl, B)}
        assert st["check"] == {((6, 6, zl, B), (6, 6, zl, B), (6, zl, B))}
        assert st["state"] == {((12, zl, B), (12, zl, B))}
        assert st["final"] == (B, 12 * 16)
        calls = {k: v for k, v in st["calls"].items()
                 if k in ("exchange", "all_reduce_sum", "all_gather")}
        assert calls == {"exchange": 2 * its + 1,
                         "all_reduce_sum": its + 1, "all_gather": 1}
        assert st["plan"][0] and st["plan"][1]


@pytest.mark.parametrize("world", [WORLD, WORLD4])
def test_sharded_qc_gathers_its_check_input_every_iteration(ranks, ranks4,
                                                            world):
    """The single-device dense loop gathers t once a decode and lets its
    variable pass write the next; a ShardedQCDecoder rank keeps the two
    earlier steps: its variable side hands back no t, so it gathers (and
    exchanges) the totals' windows every iteration, and once more for the
    end test of every check."""
    results = ranks[0] if world == WORLD else ranks4
    for r in results:
        st = r["state"]
        its = st["iterations"]
        assert st["calls"]["gather"] == its + 1
        assert st["calls"]["pass, no t"] == its
        assert "pass, t" not in st["calls"]


def test_mesh_exchange_moves_raw_bytes(ranks4):
    """Mesh.exchange between four ranks whose peers differ (rank r sends
    nothing to r + 1): each receives exactly the peers that send to it,
    bf16 rows with -0.0, NaN and a subnormal bit for bit."""
    for r in ranks4:
        peers, exact = r["exchange"]
        rank = r["rank"]
        assert peers == sorted(q for q in range(WORLD4)
                               if q != rank and (q + 1) % WORLD4 != rank)
        assert exact


@pytest.mark.parametrize("kind", ["generic", "qc"])
def test_sharded_engine_sweep_matches_unsharded(ranks, kind):
    """A softening sweep with a graph-sharded decoder (the engine's
    _build_decode duck type) gives the unsharded engine's counters: the
    same seed draws the same frames on every rank."""
    sharded, single = ranks[0][0]["sweeps"][kind]
    assert sharded == single and sharded[0] == 32


@pytest.mark.parametrize("kind", ["qc", "generic"])
def test_graph_shard_cli_writes_one_csv(ranks, kind):
    """``--graph-shard --devices 2`` on the CLI (QC: z-sharded min-sum with
    offset; generic: check-sharded float64): rank 0 writes one CSV with
    the JAX CLI's columns, no journal left behind."""
    (r0, _), cli_dir = ranks
    assert len(r0["cli"][kind]) == 1 and r0["cli"][kind][0][0] == 32
    path = os.path.join(cli_dir, f"{kind}.csv")
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["", "EsN0dB", "ber", "fer", "iters"] and len(rows) == 2
    assert not os.path.exists(path + ".partial.jsonl")


def test_sharded_qc_rejects_bad_configs():
    """JAX's rejections (z not divisible by the mesh, resident, layered,
    use_pallas=True, compressed); an explicit use_pallas=None passes and
    reads False.  A two-rank mesh object needs no process group to be
    built."""
    mesh = Mesh(None, 0, WORLD, "cpu", "gs", "gloo")
    base15, _, _ = qc_code(False, z=15)
    with pytest.raises(ValueError, match="divisible"):
        ShardedQCDecoder(base15, 15, mesh)
    base, _, _ = qc_code(False)
    for bad in (dict(resident=True), dict(schedule="layered"),
                dict(use_pallas=True), dict(compressed=True,
                                            check_rule="minsum")):
        with pytest.raises(ValueError):
            ShardedQCDecoder(base, 16, mesh, **bad)
    with pytest.raises(ValueError, match="check_phase"):
        ShardedQCDecoder(base, 16, mesh, use_pallas=True)
    dec = ShardedQCDecoder(base, 16, mesh, use_pallas=None)
    assert dec.use_pallas is False and dec.z_local == 8
    with pytest.raises(ValueError, match="check_rule"):
        ShardedDecoder(*generic_code(240), mesh, check_rule="bogus")
