"""Time the BP kernels and the decode rounds around them on one GPU.

    python -m qamreconciliation_tpu_torch.sims.time_check_phase
    python path/to/time_check_phase.py --root OTHER_CHECKOUT
    python path/to/time_check_phase.py --root CHECKOUT --parts resident \
        --inputs FILE

Times kernel 1 (``bp_check_phase_qc``) at the dense QC headline shape
[90, 6, 360, 128] and kernel 4 (``bp_check_phase_generic``) at the exact
DVB-S2 rate-1/2 shape [7, 32400, 128], for f32 phi, f32 min-sum and bf16
tanh-F/B, and kernel 5 (``check_node_update_fused``, f32 phi) at the same
code's check-major shape [32400, 7, 128] (CUDA events over runs of 10
calls, the median of 10 runs), gather 2's fold (``bp_var_totals_generic``,
f32 and bf16, beside its plain version and its bytes bound) on that code
and the dense QC variable pass (``bp_var_pass_qc``, the same) on the
headline code,
then the softening rounds of the two main paths that run them: the
dense QC decoder on the headline code (f32 and bf16 messages) and the
generic decoder on the exact rate-1/2 H, phi, 128 frames at 3.5 and 4.0
dB (host clock over 4 rounds after a warm-up; preamble, then decode +
count, then the counters' host read, and the ms per BP iteration).  The
resident part times kernel 2 (``bp_decode_rounds_qc``, bf16 tanh-F/B,
one 50-iteration call) and kernel 3
(``bp_layered_sweeps_qc``, bf16 min-sum, one 4-sweep call) per step on the
headline code and the z = 360 QC-IRA code (numpy-seeded LLRs, B = 128
and 8; at B = 128 also calls of 1 and 16 sweeps and of 1 iteration, whose
difference gives a call's fixed part), then the decode + count of the two
resident main paths (``--resident
--dtype bfloat16``, chunk 50; ``--schedule layered --resident
--check-rule minsum --dtype bfloat16``) on the same softening rounds at 3.5
and 4.0 dB (float32 samples; with ``--inputs FILE`` made once and kept in
FILE, so that every checkout decodes the same tensors), with each round's
counters.  Prints one JSON line.

``--root`` imports the port from another checkout (an earlier commit
unpacked with ``git archive``, say), whose wrappers and decoders have the
same interface; run one process per checkout, in turns, on one card.
``--parts resident`` times only the resident part (a checkout without the
generic decoder has no other).  ``--parts sharded`` times only the
z-sharded QC decoder (``ShardedQCDecoder``) at world 2, two gloo ranks on
the one card: on the headline code, f32 phi and bf16 min-sum, 128 frames
of BI-AWGN LLRs (sigma 0.8, numpy-seeded), each rank's ms an iteration
(host clock) and ``torch.cuda.max_memory_allocated`` over the decode,
beside the single-device dense decoder's on the same rank and inputs, and
whether the two decodes are torch.equal.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ALTERNATING = np.array([0, 1, 0, 1], np.uint8)
KERNEL_CASES = (("sumproduct", "float32"), ("minsum", "float32"),
                ("tanhfb", "bfloat16"))


def events_ms(*fns, reps=20, warmup=3, run=1):
    """Median ms per call of each of ``fns``, timed with CUDA events in
    turns over ``reps`` runs of ``run`` calls each, so that a short
    kernel's time is its device time and not the host's launch overhead."""
    import torch

    for _ in range(warmup):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, acc in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(run):
                fn()
            stop.record()
            stop.synchronize()
            acc.append(start.elapsed_time(stop) / run)
    return tuple(statistics.median(acc) for acc in times)


def dvbs2_half():
    """(vid, cid) of the exact DVB-S2 rate-1/2 H (seed-0 table)."""
    from qamreconciliation_tpu_torch.models.dvbs2 import (
        expanded_edges, make_table,
    )

    return expanded_edges(make_table("1/2", seed=0))


def headline_qc():
    """Base edges of the dense QC headline code, z = 360."""
    from qamreconciliation_tpu_torch.models.qc_decoder import make_qc_ldpc

    return make_qc_ldpc(180, 360, 3, 6, seed=12345)[0]


def kernel_times():
    """ms per call of kernels 1 and 4 at their main-path shapes, of kernel
    5 at the check-major shape of kernel 4's code, and of gather 2's fold
    on that code."""
    import torch

    from qamreconciliation_tpu_torch.models.decoder import TannerGraph
    from qamreconciliation_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (90, 6, 360, 128)
    t1 = 3.0 * torch.randn(shape, generator=gen, device="cuda")
    c1 = torch.randn(shape, generator=gen, device="cuda")
    s1 = torch.randint(0, 2, (90, 360, 128), generator=gen, device="cuda",
                       dtype=torch.int32)
    g = TannerGraph(*dvbs2_half(), device="cuda")
    mask = torch.as_tensor(g._c_mask_T_np, dtype=torch.float32,
                           device="cuda")
    dc, C = mask.shape
    t4 = 3.0 * torch.randn((dc, C, 128), generator=gen, device="cuda")
    c4 = torch.randn((dc, C, 128), generator=gen, device="cuda") \
        * mask[:, :, None]
    s4 = torch.randint(0, 2, (C, 128), generator=gen, device="cuda",
                       dtype=torch.int32)
    out = {}
    for rule, dt in KERNEL_CASES:
        dtype = getattr(torch, dt)
        a1 = (t1.to(dtype), c1.to(dtype), s1)
        a4 = (t4.to(dtype), c4.to(dtype), s4, mask)
        out[f"kernel1 {rule} {dt}"], = events_ms(
            lambda: K.bp_check_phase_qc(*a1, rule=rule), reps=10, run=10)
        out[f"kernel4 {rule} {dt}"], = events_ms(
            lambda: K.bp_check_phase_generic(*a4, rule=rule), reps=10,
            run=10)
    a5 = (t4.transpose(0, 1).contiguous(), s4, mask.T.contiguous())
    out["kernel5 sumproduct float32"], = events_ms(
        lambda: K.check_node_update_fused(*a5), reps=10, run=10)
    if hasattr(K, "bp_var_totals_generic"):
        out.update(fold_times(g, c4, gen))
    if hasattr(K, "bp_var_pass_qc"):
        out.update(var_pass_times(c1, gen))
    return out


def fold_times(g, c2v, gen):
    """Gather 2's fold (``bp_var_totals_generic``) and its plain version on
    ``g`` with the messages ``c2v`` [dc_max, C, B], float32 and bfloat16,
    beside the bound of its bytes (``utils/perf``)."""
    import torch

    from qamreconciliation_tpu_torch.ops import kernels as K
    from qamreconciliation_tpu_torch.utils import perf

    tb = g.on("cuda")
    V, B = g.vnum, c2v.shape[-1]
    prior = 3.0 * torch.randn((V, B), generator=gen, device="cuda")
    out = {}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        a = (prior.to(dtype).float(), c2v.to(dtype), tb["v_from_c_T_i"],
             tb["dv_i"])
        out[f"fold {dt}"], out[f"fold plain {dt}"] = events_ms(
            lambda: K.bp_var_totals_generic(*a),
            lambda: K.bp_var_totals_generic_ref(*a), reps=10, run=10)
        nbytes, ops = perf.var_totals_generic_work(
            g.ednum, V, B, dtype, int((g.dv < g.dv_max).sum()))
        out[f"fold bound {dt}"] = perf.bound(nbytes, ops)[0]
    return out


def var_pass_times(c2v, gen):
    """The dense QC variable pass (``bp_var_pass_qc``) and its plain
    version on the headline code with the messages ``c2v`` [90, 6, 360,
    B], float32 and bfloat16, beside the bound of its bytes
    (``utils/perf``)."""
    import torch

    from qamreconciliation_tpu_torch.models.qc_decoder import QCDecoder
    from qamreconciliation_tpu_torch.ops import kernels as K
    from qamreconciliation_tpu_torch.utils import perf

    dec = QCDecoder(headline_qc(), 360, device="cuda")
    B = c2v.shape[-1]
    prior = 3.0 * torch.randn((dec.nb_v, dec.z, B), generator=gen,
                              device="cuda")
    out = {}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        t = dec.gather_totals(prior.to(dtype))
        a = (prior.to(dtype), c2v.to(dtype), dec._var_rows, dec._var_degree,
             t)
        out[f"var pass {dt}"], out[f"var pass plain {dt}"] = events_ms(
            lambda: K.bp_var_pass_qc(*a), lambda: K.bp_var_pass_qc_ref(*a),
            reps=10, run=10)
        nbytes, ops = perf.var_pass_qc_work(int(dec._var_degree.sum()),
                                            dec.vnum, B, dtype)
        out[f"var pass bound {dt}"] = perf.bound(nbytes, ops)[0]
    return out


def rows_of(base):
    rows = [[] for _ in range(max(c for c, _, _ in base) + 1)]
    for c, v, s in base:
        rows[c].append((v, s))
    return rows


def resident_codes():
    """Base edges of the headline code and of the z = 360 QC-IRA code."""
    from qamreconciliation_tpu_torch.models.qc_decoder import make_qc_ira

    return {"headline": headline_qc(),
            "ira z=360": make_qc_ira(120, 60, 360, dv=3, seed=1)[0]}


def resident_kernel_times(frames=(128, 8)):
    """ms per step of kernels 2 and 3 on each resident code, from a fresh
    state on numpy-seeded LLRs (the same in every checkout), their noise
    rising across the frames so that some converge within a few steps and
    the others never: a block's frame that never converges runs every
    pass of every step, as at 3.5 dB on the main path.  Timed at each B of
    ``frames``: the main path's 128, and 8, where the card holds a few
    frames and a step's time is one frame's latency."""
    import torch

    from qamreconciliation_tpu_torch.ops import kernels as K

    out = {}
    for label, base in resident_codes().items():
        tables = K.QCTables(rows_of(base), 360)
        z = tables.z
        for B in frames:
            key = label if B == 128 else f"{label} B={B}"
            rng = np.random.default_rng(3)
            word = rng.integers(0, 2, (tables.nb_v, z, B))
            llr = ((1 - 2 * word) * 2.0 + rng.normal(0, 1.0, word.shape)
                   * np.linspace(1.0, 3.0, B)).astype(np.float32)
            synd = np.zeros((tables.nb_c, z, B), np.int8)
            for cb, row in enumerate(tables.rows):
                for v, sh in row:
                    synd[cb] ^= np.roll(word[v], sh, axis=0).astype(np.int8)
            prior = torch.from_numpy(llr).cuda()
            synd8 = torch.from_numpy(synd).cuda()

            def flags():
                return [torch.zeros(B, dtype=torch.int32, device="cuda")
                        for _ in range(2)]

            bf16 = prior.bfloat16()
            rounds = [bf16.clone(), torch.zeros((tables.E, z, B),
                                                dtype=torch.bfloat16,
                                                device="cuda"),
                      bf16, synd8, *flags()]
            sweeps = [prior.clone(), torch.zeros((tables.E, z, B),
                                                 dtype=torch.bfloat16,
                                                 device="cuda"),
                      synd8, *flags()]
            ms, = events_ms(lambda: K.bp_decode_rounds_qc(
                tables, 0, 50, *rounds, rule="tanhfb", k_rounds=50),
                reps=5, warmup=1)
            out[f"kernel2 tanhfb bfloat16 {key} ms per iteration"] = ms / 50
            ms, = events_ms(lambda: K.bp_layered_sweeps_qc(
                tables, 0, 50, *sweeps, rule="minsum", k_sweeps=4),
                reps=10, warmup=2)
            out[f"kernel3 minsum bfloat16 {key} ms per sweep"] = ms / 4
            if B != 128:
                continue
            # the host's share of a call: the wrapper's enqueue time, from
            # an idle card (median of 5)
            host = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                K.bp_layered_sweeps_qc(tables, 0, 50, *sweeps,
                                       rule="minsum", k_sweeps=4)
                host.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            out[f"kernel3 {label} host ms per call"] = statistics.median(host)
            # calls of 1 and 16 steps beside the ones above: a call's fixed
            # part (the copies of the state in and out, the launches) is
            # what they do not share with the steps
            for k in (1, 16):
                ms, = events_ms(lambda: K.bp_layered_sweeps_qc(
                    tables, 0, 50, *sweeps, rule="minsum", k_sweeps=k),
                    reps=10, warmup=1)
                out[f"kernel3 minsum bfloat16 {label} K={k} ms per call"] = ms
            ms, = events_ms(lambda: K.bp_decode_rounds_qc(
                tables, 0, 50, *rounds, rule="tanhfb", k_rounds=1),
                reps=10, warmup=1)
            out[f"kernel2 tanhfb bfloat16 {label} K=1 ms per call"] = ms
    return out


def softening_rounds(path=None, snrs=(3.5, 4.0), rounds=4):
    """{snr: [(lappr, word)] * rounds}: softening rounds of 128 frames of
    the headline code on float32 samples; with ``path``, loaded from it
    when it exists, else made and saved there."""
    import torch

    if path and os.path.exists(path):
        return torch.load(path, map_location="cuda")
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.qc_decoder import QCDecoder
    from qamreconciliation_tpu_torch.sims.engine import (
        ReconciliationEngine, round_generator,
    )

    dec = QCDecoder(headline_qc(), 360, device="cuda")
    eng = ReconciliationEngine(dec, Matrix(dec.vid, dec.cid),
                               PAMAlphabet(2, 2.0), batch=128,
                               dtype=torch.float32)
    data = {}
    for snr in snrs:
        nm = eng.make_noisemapper(snr, ALTERNATING)
        sigma = math.sqrt(eng.noise_var(snr))
        data[snr] = [eng._softening_inputs(
            nm, *eng._sample_sb(round_generator(11, r, "cuda"), sigma), 1.0)
            for r in range(rounds)]
    if path:
        torch.save(data, path)
    return data


RESIDENT_PATHS = {
    "resident bf16 tanh-F/B": dict(dtype="bfloat16", resident=True,
                                   resident_chunk=50),
    "resident layered bf16 min-sum": dict(dtype="bfloat16",
                                          schedule="layered", resident=True,
                                          check_rule="minsum"),
}


def resident_round_times(inputs):
    """Host-clock decode + count ms of the resident main paths on the same
    rounds (the first a warm-up), BP iterations (sweeps) per round and
    each round's counters [bit errors, frame errors, iterations of the
    successes, successes]."""
    import torch

    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.qc_decoder import QCDecoder
    from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine

    out = {}
    for label, kw in RESIDENT_PATHS.items():
        dec = QCDecoder(headline_qc(), 360, device="cuda", **kw)
        eng = ReconciliationEngine(dec, Matrix(dec.vid, dec.cid),
                                   PAMAlphabet(2, 2.0), batch=128,
                                   dtype=torch.float32)
        for snr, rounds in inputs.items():
            dcd, its, counters = [], [], []
            for r, (lappr, word) in enumerate(rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                it0 = dec.iterations_run
                c = eng._decode_and_count_nb(lappr, word, 50).tolist()
                t1 = time.perf_counter()
                if r:
                    dcd.append(1e3 * (t1 - t0))
                    its.append(dec.iterations_run - it0)
                    counters.append(c)
            out[f"{label} {snr} dB"] = dict(
                decode_ms=statistics.median(dcd), iterations=its,
                ms_per_iteration=statistics.median(dcd)
                / max(statistics.median(its), 1), counters=counters)
    return out


def round_breakdown(dec, mat, snr, rounds=4, mode="softening", *,
                    batch=128, dtype="float32", nmconfig=ALTERNATING,
                    maxiter=50, seed=11, bps=2, llr_mode="poly"):
    """Host-clock ms per ``mode`` round of ``batch`` frames (2^bps-PAM,
    sign configuration ``nmconfig``, samples and LLRs in ``dtype``, the
    softening LLRs by ``llr_mode``) on ``dec``,
    on its device, after a warm-up round: (preamble, decode + count, host
    read of the counters, BP iterations per round), each part ending in a
    synchronisation of the device."""
    import torch

    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.sims.engine import (
        ReconciliationEngine, round_generator,
    )

    dev = dec.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    eng = ReconciliationEngine(dec, mat, PAMAlphabet(bps, 2.0), batch=batch,
                               dtype=dtype, llr_mode=llr_mode)
    nm = eng.mode_noisemapper(mode, snr, nmconfig)
    sigma = math.sqrt(eng.noise_var(snr))
    pre, dcd, read, its = [], [], [], []
    for r in range(rounds + 1):
        sync()
        t0 = time.perf_counter()
        x, y = eng._sample_sb(round_generator(seed, r, dev), sigma)
        lappr, word = eng.round_inputs(mode, nm, x, y, sigma, 1.0)
        sync()
        t1 = time.perf_counter()
        it0 = dec.iterations_run
        counters = eng._decode_and_count_nb(lappr, word, maxiter)
        sync()
        t2 = time.perf_counter()
        counters.tolist()
        t3 = time.perf_counter()
        if r:
            pre.append(1e3 * (t1 - t0))
            dcd.append(1e3 * (t2 - t1))
            read.append(1e3 * (t3 - t2))
            its.append(dec.iterations_run - it0)
    return (statistics.median(pre), statistics.median(dcd),
            statistics.median(read), its)


def round_times():
    """Per main path and point: preamble and decode ms per round, BP
    iterations per round, ms per iteration and frames/s of the rounds."""
    from qamreconciliation_tpu_torch.models.decoder import Decoder
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.qc_decoder import QCDecoder

    qc = QCDecoder(headline_qc(), 360, device="cuda")
    qc16 = QCDecoder(headline_qc(), 360, "bfloat16", device="cuda")
    vid, cid = dvbs2_half()
    paths = {"dense QC f32 phi": (qc, Matrix(qc.vid, qc.cid)),
             "dense QC bf16 phi": (qc16, Matrix(qc.vid, qc.cid)),
             "generic DVB-S2 1/2 f32 phi": (Decoder(vid, cid,
                                                    device="cuda"),
                                            Matrix(vid, cid))}
    out = {}
    for label, (dec, mat) in paths.items():
        for snr in (3.5, 4.0):
            pre, dcd, read, its = round_breakdown(dec, mat, snr)
            out[f"{label} {snr} dB"] = dict(
                preamble_ms=pre, decode_ms=dcd, read_ms=read,
                iterations=its,
                ms_per_iteration=dcd / max(statistics.median(its), 1),
                frames_per_s=128e3 / (pre + dcd + read))
    return out


def _sharded_rank(world):
    """One rank of ``--parts sharded``: {case: figures} (see the module
    docstring)."""
    import torch

    from qamreconciliation_tpu_torch.models.qc_decoder import QCDecoder
    from qamreconciliation_tpu_torch.parallel import (
        ShardedQCDecoder, make_mesh,
    )

    mesh = make_mesh(world, "gs", device="cuda")
    base, z, B = headline_qc(), 360, 128
    rng = np.random.default_rng(5)
    word = rng.integers(0, 2, (180 * z, B))
    y = (1 - 2 * word) + 0.8 * rng.standard_normal(word.shape)
    llr = torch.as_tensor(2 * y / 0.8 ** 2, dtype=torch.float32,
                          device=mesh.device)
    one = QCDecoder(base, z, device=mesh.device)
    synd = one.syndrome_from_bits(torch.as_tensor(word, device=mesh.device))

    def run(dec):
        dec.decode_batched(llr, synd, 50)          # warm-up
        dec.iterations_run = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = dec.decode_batched(llr, synd, 50)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        over = torch.cuda.max_memory_allocated() - before
        return out, 1e3 * secs / max(dec.iterations_run, 1), \
            dec.iterations_run, over

    res = {}
    for name, dt, kw in (("float32 phi", torch.float32, {}),
                         ("bfloat16 min-sum", torch.bfloat16,
                          dict(check_rule="minsum"))):
        want, ms1, _, over1 = run(QCDecoder(base, z, dt, device=mesh.device,
                                            **kw))
        mesh.barrier()
        got, ms, its, over = run(ShardedQCDecoder(base, z, mesh, dtype=dt,
                                                  **kw))
        res[name] = dict(equal=all(map(torch.equal, got, want)),
                         iterations=its, ms_per_iteration=ms,
                         ms_per_iteration_world1=ms1, peak_over_decode=over,
                         peak_over_decode_world1=over1)
    return res


def sharded_times():
    """``--parts sharded``: each rank's figures, in rank order."""
    from qamreconciliation_tpu_torch.parallel.mesh import run_ranks

    return run_ranks(_sharded_rank, 2, (2,), device="cuda", timeout=600)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", help="checkout of the port to import")
    p.add_argument("--parts", choices=("all", "resident", "sharded"),
                   default="all",
                   help="what to time (default all)")
    p.add_argument("--inputs", help="file keeping the resident rounds' "
                   "softening inputs, made by the first run")
    args = p.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_check_phase needs a CUDA GPU")
    import qamreconciliation_tpu_torch as port

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    result = dict(port=os.path.dirname(os.path.abspath(port.__file__)),
                  device=smi)
    if args.parts == "sharded":
        result.update(sharded=sharded_times())
        print(json.dumps(result))
        return result
    if args.parts == "all":
        result.update(kernels_ms=kernel_times(), rounds=round_times())
    result.update(resident_kernels_ms=resident_kernel_times(),
                  resident_rounds=resident_round_times(
                      softening_rounds(args.inputs)))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
