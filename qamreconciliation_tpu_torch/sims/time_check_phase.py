"""Time the check-phase kernels and the decode rounds around them on one GPU.

    python -m qamreconciliation_tpu_torch.sims.time_check_phase
    python path/to/time_check_phase.py --root OTHER_CHECKOUT

Times kernel 1 (``bp_check_phase_qc``) at the dense QC headline shape
[90, 6, 360, 128] and kernel 4 (``bp_check_phase_generic``) at the exact
DVB-S2 rate-1/2 shape [7, 32400, 128], for f32 phi, f32 min-sum and bf16
tanh-F/B, and kernel 5 (``check_node_update_fused``, f32 phi) at the same
code's check-major shape [32400, 7, 128] (CUDA events over runs of 10
calls, the median of 10 runs), then the softening rounds of the two main paths that run them: the
dense QC decoder on the headline code and the generic decoder on the exact
rate-1/2 H, f32 phi, 128 frames at 3.5 and 4.0 dB (host clock over 4
rounds after a warm-up; preamble, then decode + count, and the ms per BP
iteration).  Prints one JSON line.

``--root`` imports the port from another checkout (an earlier commit
unpacked with ``git archive``, say), whose wrappers and decoders have the
same interface; run one process per checkout, in turns, on one card.
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
    """ms per call of kernels 1 and 4 at their main-path shapes, and of
    kernel 5 at the check-major shape of kernel 4's code."""
    import torch

    from qamreconciliation_tpu_torch.models.decoder import TannerGraph
    from qamreconciliation_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (90, 6, 360, 128)
    t1 = 3.0 * torch.randn(shape, generator=gen, device="cuda")
    c1 = torch.randn(shape, generator=gen, device="cuda")
    s1 = torch.randint(0, 2, (90, 360, 128), generator=gen, device="cuda",
                       dtype=torch.int32)
    mask = torch.as_tensor(TannerGraph(*dvbs2_half(), device="cuda")
                           ._c_mask_T_np, dtype=torch.float32, device="cuda")
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
    return out


def round_breakdown(dec, mat, snr, rounds=4):
    """Host-clock ms per softening round of 128 frames on ``dec``, after a
    warm-up round: (preamble, decode + count, BP iterations per round)."""
    import torch

    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.sims.engine import (
        ReconciliationEngine, round_generator,
    )

    eng = ReconciliationEngine(dec, mat, PAMAlphabet(2, 2.0), batch=128,
                               dtype=torch.float32)
    nm = eng.make_noisemapper(snr, ALTERNATING)
    sigma = math.sqrt(eng.noise_var(snr))
    pre, dcd, its = [], [], []
    for r in range(rounds + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, y = eng._sample_sb(round_generator(11, r, "cuda"), sigma)
        lappr, word = eng._softening_inputs(nm, x, y, 1.0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        it0 = dec.iterations_run
        eng._decode_and_count_nb(lappr, word, 50).tolist()
        t2 = time.perf_counter()
        if r:
            pre.append(1e3 * (t1 - t0))
            dcd.append(1e3 * (t2 - t1))
            its.append(dec.iterations_run - it0)
    return statistics.median(pre), statistics.median(dcd), its


def round_times():
    """Per main path and point: preamble and decode ms per round, BP
    iterations per round, ms per iteration and frames/s of the rounds."""
    from qamreconciliation_tpu_torch.models.decoder import Decoder
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.qc_decoder import QCDecoder

    qc = QCDecoder(headline_qc(), 360, device="cuda")
    vid, cid = dvbs2_half()
    paths = {"dense QC f32 phi": (qc, Matrix(qc.vid, qc.cid)),
             "generic DVB-S2 1/2 f32 phi": (Decoder(vid, cid,
                                                    device="cuda"),
                                            Matrix(vid, cid))}
    out = {}
    for label, (dec, mat) in paths.items():
        for snr in (3.5, 4.0):
            pre, dcd, its = round_breakdown(dec, mat, snr)
            out[f"{label} {snr} dB"] = dict(
                preamble_ms=pre, decode_ms=dcd, iterations=its,
                ms_per_iteration=dcd / max(statistics.median(its), 1),
                frames_per_s=128e3 / (pre + dcd))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", help="checkout of the port to import")
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
                  device=smi, kernels_ms=kernel_times(),
                  rounds=round_times())
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
