"""Port parity: frame-shard data parallelism on ``torch.distributed``
(``parallel/mesh.py``, ``parallel/sweep.py``, the engines' ``mesh_axis``,
the CLIs' ``--devices``, the frame-sharded ``stream_fused`` and
``entry.dryrun_multichip``) at world size 2 on the CPU with gloo.

The port's two ranks run once for most of the file (``ranks``): two
processes started by ``parallel.mesh.run_ranks`` (spawn, gloo, a file
store under a temporary directory), which import only the port and this
module, whose JAX imports stay inside the tests.  Their results come back
here; the JAX side runs here on 2 of the 8 virtual CPU devices.

Tiers:
* exact, the port against itself: shard invariance (the counters summed
  over the ranks equal the sums of single-rank rounds on the ranks'
  generators, ``round_generator(seed, k, rank=r)``) for softening, hard,
  BSC and batched-point ([P, 4]) rounds and with rounds per dispatch; the
  frame-sharded ``stream_fused`` against the single-device one;
* exact, against JAX's frame-sharded stream on the same (y, x): success,
  iterations and bit errors (float64 generic decoder);
* torch generators cannot reproduce ``jax.random`` streams, so the sharded
  rounds are not compared with JAX's draws.
"""

import argparse
import csv
import math
import os
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc, save_qc_csv,
)
from qamreconciliation_tpu_torch.parallel import (
    make_mesh, mesh as tmesh, run_ranks, shard_round, sharded_sweep,
)
from qamreconciliation_tpu_torch.sims import common, sim_bsc
from qamreconciliation_tpu_torch.sims import sim_reconciliation
from qamreconciliation_tpu_torch.sims.bitchannel import BitChannelEngine
from qamreconciliation_tpu_torch.sims.engine import (
    ReconciliationEngine, point_result, point_seed, round_generator,
)
from qamreconciliation_tpu_torch.sims.streaming import StreamReconciler
from qamreconciliation_tpu_torch.utils.checkpoint import SweepState
from qamreconciliation_tpu_torch.utils.edgefile import (
    make_regular_ldpc, save_edge_csv,
)

torch.set_num_threads(1)

WORLD = 2
B = 16
STREAM_SNR = 6.0
CFG = np.zeros(4, np.uint8)


def generic_setup(dtype="float64", device="cpu"):
    vid, cid = make_regular_ldpc(120, 3, 6, seed=2)
    return (Decoder(vid, cid, dtype, device=device), Matrix(vid, cid),
            PAMAlphabet(2, 2.0))


def local_totals(round_fn, seed, rounds, ranks=range(WORLD)):
    """Sum of ``round_fn(generator)`` over the ranks' generators of rounds
    0 .. rounds - 1: what the mesh's counters must equal."""
    total = 0
    for r in ranks:
        for k in range(rounds):
            total = total + round_fn(round_generator(seed, k, "cpu", rank=r))
    return total.tolist()


def stream_data(pa, mat, frames, seed=3):
    rng = np.random.default_rng(seed)
    S = mat.vnum // pa.bit_per_symbol
    x = rng.integers(0, pa.order, frames * S)
    sigma = math.sqrt(pa.variance * 10 ** (-STREAM_SNR / 10) / 2)
    y = pa.constellation[x] + sigma * rng.standard_normal(x.size)
    # chunks that do not line up with frames
    cuts = np.cumsum(rng.integers(20, 90, x.size // 20))
    cuts = cuts[cuts < x.size]
    return x, y, np.split(y, cuts), np.split(x, cuts)


def stream_view(res):
    return (res.frames, res.success, res.iterations, res.bit_errors,
            [w.tolist() for w in res.decoded_words])


def _ranks_body(cli_dir):
    """One rank: the shard-invariance checks, the sharded stream, the CLIs
    as ranks of this group, and the dry run."""
    from qamreconciliation_tpu_torch.entry import dryrun_multichip

    mesh = make_mesh(WORLD, "dp", device="cpu")
    out = {"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend}
    dec, mat, pa = generic_setup()
    local = ReconciliationEngine(dec, mat, pa, batch=B, dtype="float64")
    sharded = ReconciliationEngine(dec, mat, pa, batch=B, dtype="float64",
                                   mesh_axis=(mesh, "dp"))
    out["frames_per_round"] = sharded.frames_per_round
    snr = 5.0
    nm = local.make_noisemapper(snr, CFG)
    sigma = math.sqrt(local.noise_var(snr))

    def soft(gen):
        return local.round("softening", nm, sigma, 1.0, 20, generator=gen)

    inv = {"shard_round": (shard_round(soft, mesh)(42, 0).tolist(),
                           local_totals(soft, 42, 1))}
    # run_point over 3 dispatches, and with 2 rounds a dispatch, no early
    # exit: the summed counters of every round of every rank
    for mode, R in (("softening", 1), ("hard", 1), ("softening", 2)):
        eng = ReconciliationEngine(dec, mat, pa, batch=B, dtype="float64",
                                   rounds_per_dispatch=R,
                                   mesh_axis=(mesh, "dp"))
        pnm = eng.mode_noisemapper(mode, snr, CFG)
        r = eng.run_point(mode, snr, 20, 3 * R * B * WORLD, 10 ** 9,
                          nmconfig=CFG, seed=7)
        want = point_result(snr, local_totals(
            lambda gen: local.round(mode, pnm, sigma, 1.0, 20, generator=gen),
            7, 3 * R), 3 * R * B * WORLD, 1.0, local.K)
        inv[f"run_point {mode} R={R}"] = (
            (r.frames, r.ber, r.fer, r.iters),
            (want.frames, want.ber, want.fer, want.iters))
    # a BSC point
    beng = BitChannelEngine(dec, mat, batch=B, dtype="float64",
                            mesh_axis=(mesh, "dp"))
    blocal = BitChannelEngine(dec, mat, batch=B, dtype="float64")
    r = beng.run_bsc_point(0.06, 10, 2 * B * WORLD, 10 ** 9)
    want = point_result(0.06, local_totals(
        lambda gen: blocal.bsc_round(0.06, 10, generator=gen), 0, 2),
        2 * B * WORLD, 1.0, blocal.N)
    inv["bsc"] = ((r.frames, r.ber, r.fer, r.iters),
                  (want.frames, want.ber, want.fer, want.iters))
    # the batched points: every rank runs all P points, [P, 4] summed
    snrs = [3.0, 5.0, 7.0]
    got = sharded.run_sweep_batched("softening", snrs, 20, 2 * B * WORLD,
                                    10 ** 9, nmconfig=CFG, seed=11)
    rows = []
    for p, s in enumerate(snrs):
        pnm = local.make_noisemapper(s, CFG)
        psig = math.sqrt(local.noise_var(s))
        w = point_result(s, local_totals(
            lambda gen: local.round("softening", pnm, psig, 1.0, 20,
                                    generator=gen), point_seed(11, p), 2),
            2 * B * WORLD, 1.0, local.K)
        rows.append(((got[p].frames, got[p].ber, got[p].fer, got[p].iters),
                     (w.frames, w.ber, w.fer, w.iters)))
    inv["batched"] = rows
    out["invariance"] = inv
    # an early exit read from the summed counters (every rank stops at the
    # same dispatch), and sharded_sweep's seeds
    early = sharded.run_point("softening", 2.0, 20, 50 * B * WORLD, 8,
                              nmconfig=CFG)
    sweep = sharded_sweep(sharded, "direct", [7.0, 8.0], mesh,
                          decoder_iterations=20, simulation_loops=128,
                          ferr_count_min=10 ** 9, seed=0)
    out["early"] = (early.frames, early.fer)
    out["sweep"] = [(r.frames, r.ber) for r in sweep]
    out["sweep_seeded"] = [
        sharded.run_point("direct", s, 20, 128, 10 ** 9,
                          seed=point_seed(0, i)).ber
        for i, s in enumerate([7.0, 8.0])]

    # the frame-sharded fused stream against the single-device one
    s_mesh = make_mesh(WORLD, "sdp", device="cpu")
    nm64 = NoiseMapper(pa, pa.variance * 10 ** (-STREAM_SNR / 10) / 2,
                       dtype="float64", device="cpu")
    x, y, ych, xch = stream_data(pa, mat, 10)
    res = {}
    for name, kw in (("single", {}), ("sharded",
                                      dict(mesh_axis=(s_mesh, "sdp")))):
        sr = StreamReconciler(dec, mat, pa, nm64, batch=4, **kw)
        res[name] = (stream_view(sr.stream_fused(ych, xch, 20)),
                     sr.decode_dispatches)
    base, qvid, qcid = make_qc_ldpc(12, 16, 3, 6, seed=4)
    qmat = Matrix(qvid, qcid)
    bnm = NoiseMapper(pa, pa.variance * 10 ** (-5.0 / 10) / 2,
                      dtype="bfloat16", device="cpu")
    _, _, ych, xch = stream_data(pa, qmat, 9, seed=8)
    for name, kw in (("qc single", {}), ("qc sharded",
                                         dict(mesh_axis=(s_mesh, "sdp")))):
        qdec = QCDecoder(base, 16, "bfloat16", device="cpu",
                         check_rule="minsum", resident=True,
                         resident_chunk=5)
        sr = StreamReconciler(qdec, qmat, pa, bnm, batch=4, **kw)
        res[name] = (stream_view(sr.stream_fused(ych, xch, 20)),
                     sr.decode_dispatches)
    out["stream"] = res

    # the CLIs as ranks of this group (run_cli sees the group and runs)
    cli = {}
    code = os.path.join(cli_dir, "qc.csv")
    for name, argv in (
            ("dense", [code, "--qc"]),
            ("resident", [code, "--qc", "--resident", "--resident-chunk",
                          "5"]),
            ("point-batch", [code, "--qc", "--point-batch"])):
        res = sim_reconciliation.main(
            argv + ["--devices", str(WORLD), "--device", "cpu", "--snr", "3",
                    "5", "--nsnr", "2", "--simloops", "64", "--batch", "16",
                    "--maxiter", "10", "--out",
                    os.path.join(cli_dir, f"{name}.csv")])
        cli[name] = [(r.frames, r.ber, r.fer, r.iters) for r in res]
    try:
        sim_bsc.main([code, "--qc", "--devices", "3", "--device", "cpu",
                      "--out", os.path.join(cli_dir, "bad.csv")])
        cli["devices 3"] = None
    except SystemExit as e:
        cli["devices 3"] = str(e)
    out["cli"] = cli
    out["dryrun"] = dryrun_multichip(WORLD, "cpu")
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cli_dir = str(tmp_path_factory.mktemp("parallel_cli"))
    base, _, _ = make_qc_ldpc(12, 16, 3, 6, seed=4)
    save_qc_csv(os.path.join(cli_dir, "qc.csv"), base, 16)
    results = run_ranks(_ranks_body, WORLD, (cli_dir,), device="cpu",
                        timeout=240)
    return results, cli_dir


def test_ranks_form_a_gloo_mesh(ranks):
    results, _ = ranks
    assert [(r["rank"], r["world"], r["backend"]) for r in results] == [
        (0, 2, "gloo"), (1, 2, "gloo")]
    assert results[0]["frames_per_round"] == B * WORLD


@pytest.mark.parametrize("case", [
    "shard_round", "run_point softening R=1", "run_point hard R=1",
    "run_point softening R=2", "bsc", "batched"])
def test_shard_invariance(ranks, case):
    """The counters summed over the ranks equal the sum of single-rank
    rounds run on the same rank generators (tests/test_parallel.py's
    check), on every rank."""
    results, _ = ranks
    got = results[0]["invariance"][case]
    assert got == results[1]["invariance"][case]
    rows = got if case == "batched" else [got]
    for sharded, want in rows:
        assert sharded == want
    if case.startswith("run_point") or case == "bsc":
        assert got[0][0] > 0 and 0.0 < got[0][2] <= 1.0


def test_early_exit_and_sharded_sweep(ranks):
    """The stopping rule reads the summed counters, so every rank stops at
    the same dispatch; sharded_sweep seeds point i as the CLIs do."""
    results, _ = ranks
    r0, r1 = results
    assert r0["early"] == r1["early"]
    frames, fer = r0["early"]
    assert frames % (B * WORLD) == 0 and frames < 50 * B * WORLD and fer > 0
    assert [f for f, _ in r0["sweep"]] == [128, 128]
    assert [b for _, b in r0["sweep"]] == r0["sweep_seeded"]


@pytest.mark.parametrize("name", ["", "qc "])
def test_sharded_stream_equals_single_device(ranks, name):
    """stream_fused with frames sharded over the ranks (batch 4, 2 a rank,
    a padded tail) equals the single-device driver on every rank: success,
    iterations, words, bit errors, dispatches (float64 generic; bf16
    resident min-sum QC)."""
    results, _ = ranks
    for r in results:
        sharded = r["stream"][name + "sharded"]
        assert sharded == r["stream"][name + "single"]
        assert sharded[0][0] in (9, 10) and sum(sharded[0][1]) > 0


def test_sharded_stream_matches_jax(ranks):
    """The frame-sharded stream agrees with the JAX package's on 2 virtual
    devices on the same (y, x): success, iterations, bit errors."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from qamreconciliation_tpu import Decoder as JDecoder
    from qamreconciliation_tpu import Matrix as JMatrix
    from qamreconciliation_tpu import PAMAlphabet as JPAM
    from qamreconciliation_tpu.models.noisemapper import NoiseMapper as JNM
    from qamreconciliation_tpu.sims.streaming import StreamReconciler as JSR

    results, _ = ranks
    vid, cid = make_regular_ldpc(120, 3, 6, seed=2)
    jpa = JPAM(2, 2.0)
    jsr = JSR(JDecoder(vid, cid, dtype=jnp.float64), JMatrix(vid, cid), jpa,
              JNM(jpa, jpa.variance * 10 ** (-STREAM_SNR / 10) / 2,
                  dtype=jnp.float64),
              batch=4, mesh_axis=(JMesh(np.array(jax.devices()[:WORLD]),
                                        ("sdp",)), "sdp"))
    _, _, ych, xch = stream_data(PAMAlphabet(2, 2.0), Matrix(vid, cid), 10)
    want = jsr.stream_fused(ych, xch, 20)
    got = results[0]["stream"]["sharded"][0]
    assert got[:4] == (want.frames, want.success, want.iterations,
                       want.bit_errors)


@pytest.mark.parametrize("name", ["dense", "resident", "point-batch"])
def test_cli_devices_writes_one_csv(ranks, name):
    """``sim_reconciliation --devices 2`` (dense, --resident,
    --point-batch) as ranks of a group: 64 frames a point over the two
    ranks, rank 0 writes the one CSV with the JAX CLI's columns."""
    results, cli_dir = ranks
    rows = results[0]["cli"][name]
    assert rows == results[1]["cli"][name]
    assert [r[0] for r in rows] == [64, 64]
    path = os.path.join(cli_dir, f"{name}.csv")
    with open(path) as f:
        table = list(csv.reader(f))
    assert table[0] == ["", "EsN0dB", "ber", "fer", "iters"]
    assert [float(r[1]) for r in table[1:]] == [3.0, 5.0]
    assert not os.path.exists(path + ".partial.jsonl")


def test_cli_devices_must_equal_world_size(ranks):
    results, _ = ranks
    msg = results[0]["cli"]["devices 3"]
    assert msg is not None and "world size 2" in msg


def test_dryrun_multichip_two_ranks(ranks):
    """dryrun_multichip(2) on the CPU: the seven modes, one line each."""
    results, _ = ranks
    lines = results[0]["dryrun"]
    assert len(lines) == 7 and lines == results[1]["dryrun"]
    for text in ("frame-shard softening round", "graph-shard sweep round",
                 "layered-QC frame-shard round",
                 "resident QC frame-shard round", "z-sharded QC graph round",
                 "frame-sharded fused stream", "DVB-S2-construction"):
        assert any(text in line for line in lines), text


def test_plain_command_starts_its_ranks_and_resumes(tmp_path):
    """``sim_bsc --devices 2`` from a plain process starts its two ranks;
    with ``--resume`` a point the journal holds is skipped (its row comes
    back) and the others run; one CSV, written by rank 0."""
    code = str(tmp_path / "code.csv")
    save_edge_csv(code, *make_regular_ldpc(120, 3, 6, seed=9))
    out = str(tmp_path / "o.csv")
    SweepState(out).record(0.01, dict(ber=0.123, fer=0.5, iters=1.0,
                                      frames=99))
    res = sim_bsc.main([code, "--out", out, "--maxiter", "5", "--simloops",
                        "64", "--rber", "0.01", "0.03", "--rpoints", "2",
                        "--batch", "16", "--dtype", "float64", "--devices",
                        "2", "--device", "cpu", "--resume"])
    assert [r.frames for r in res] == [99, 64]
    assert (res[0].ber, res[0].fer) == (0.123, 0.5)
    assert sorted(os.listdir(tmp_path)) == ["code.csv", "o.csv"]
    with open(out) as f:
        assert next(csv.reader(f)) == ["", "f", "ber", "fer", "iters"]


class TestMaybeDistributedInit:
    """The launcher wiring (tests/test_parallel.py's class)."""

    def test_noop_without_launcher(self, monkeypatch):
        for var in tmesh.LAUNCHER_VARS:
            monkeypatch.delenv(var, raising=False)
        assert not dist.is_initialized()
        assert tmesh.maybe_distributed_init() is False

    def test_failure_warns_not_silent(self, monkeypatch):
        """A failed init is loud (a silent single-rank run would report one
        rank's frames as the mesh's), and a CLI asked for --devices 2 under
        that launcher refuses to run."""
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("MASTER_ADDR", "203.0.113.1")

        def boom(*a, **k):
            raise RuntimeError("no rendezvous reachable")

        monkeypatch.setattr(dist, "init_process_group", boom)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            assert tmesh.maybe_distributed_init(device="cpu") is False
        assert any("FALLING BACK" in str(w.message) for w in rec)
        args = argparse.Namespace(devices=2, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(SystemExit, match="did not start"):
                common.ranks_to_start(args)

    def test_cli_reaches_init(self, monkeypatch, tmp_path):
        """Every sweep CLI calls maybe_distributed_init before device use."""
        calls = []
        monkeypatch.setattr(tmesh, "maybe_distributed_init",
                            lambda *a, **k: calls.append(k) or False)
        path = str(tmp_path / "code.csv")
        save_edge_csv(path, *make_regular_ldpc(120, 3, 6, seed=9))
        sim_bsc.main([path, "--out", str(tmp_path / "o.csv"), "--maxiter",
                      "5", "--simloops", "32", "--rber", "0.01", "0.01",
                      "--rpoints", "1", "--batch", "32", "--dtype",
                      "float64", "--device", "cpu"])
        assert calls and calls[0]["device"] == "cpu"


def test_mesh_without_a_group():
    """One rank needs no process group; more raise with the way out."""
    mesh = make_mesh(1, "dp", device="cpu")
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    x = torch.arange(6, dtype=torch.bfloat16).view(2, 3)
    assert torch.equal(mesh.all_gather(x), x[None])
    assert torch.equal(mesh.all_reduce_sum(x.clone()), x)
    with pytest.raises(RuntimeError, match="run_ranks"):
        make_mesh(2, "dp", device="cpu")
    with pytest.raises(ValueError, match="axis"):
        ReconciliationEngine(*generic_setup(), mesh_axis=(mesh, "gs"))
    assert tmesh.backend_for(2, "cpu") == "gloo"
