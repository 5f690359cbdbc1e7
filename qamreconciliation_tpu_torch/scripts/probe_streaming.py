"""Streaming-pipeline probe: end-to-end symbols/s through the
``StreamReconciler`` drivers.

The port's counterpart of the JAX package's ``scripts/probe_streaming.py``
(the round-3/4 baseline streaming protocol): the QC(3,6) code
``make_qc_ldpc(36, n / 36, 3, 6, seed=12345)`` with bf16 min-sum (kernel 1
on the card), ``--bps``-bit PAM at ``--snr`` dB, ``--frames`` frames of
numpy ``default_rng(0)`` symbols and samples, fed in deliberately
frame-misaligned chunks of ``--chunk-frames`` frames.  One driver:

  default       ``bob_process`` -> ``alice_process`` per chunk, then the
                flushes, with ``defer=--defer`` (host round trip of Bob's
                outputs);
  --fused 1     ``stream_fused`` over the chunk lists (Bob -> Alice on the
                device, bit-packed downloads);
  --handoff 1   ``bob_step`` -> ``alice_step`` per chunk, then
                ``bob_step_flush`` (Bob's outputs stay on the device;
                ``--defer`` is not used).

An untimed pass over one batch comes first (the kernels' build and load);
then a fresh reconciler runs the whole stream on the host clock, which
ends with the results read back.

    python -m qamreconciliation_tpu_torch.scripts.probe_streaming \\
        [--frames 256 --batch 64] [--fused 1 | --handoff 1] \\
        [--device cuda]

One record after the device record, with the JAX probe's keys: ``{frames,
decoded_frames, batch, chunk_frames, defer | fused | handoff, snr_dB,
success, bit_errors, dispatches, elapsed_s, symbols_per_s}``.  Exits 2
without a card unless ``--device cpu``.
"""

import argparse
import math
import sys
import time

import numpy as np
import torch

from ._probe import add_device, emit, open_device
from ..models.alphabet import PAMAlphabet
from ..models.matrix import Matrix
from ..models.noisemapper import NoiseMapper
from ..models.qc_decoder import QCDecoder, make_qc_ldpc
from ..sims.streaming import StreamReconciler

__all__ = ["main"]


class _Tally:
    """Frames, successes and bit errors summed over StreamResults."""

    def __init__(self):
        self.frames = self.succ = self.bit_errors = 0

    def add(self, r):
        self.frames += r.frames
        self.succ += sum(r.success)
        self.bit_errors += r.bit_errors


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_streaming")
    ap.add_argument("--n", type=int, default=64800)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--chunk-frames", type=float, default=2.33)
    ap.add_argument("--snr", type=float, default=4.0)
    ap.add_argument("--bps", type=int, default=2)
    ap.add_argument("--maxiter", type=int, default=50)
    ap.add_argument("--defer", type=int, default=1)
    ap.add_argument("--fused", type=int, default=0,
                    help="use the one-pass stream_fused driver (Bob->Alice "
                    "hand-off on the device, packed-word downloads)")
    ap.add_argument("--handoff", type=int, default=0,
                    help="use the bob_step/alice_step device hand-off pair "
                    "(split-call structure, Bob's outputs stay on the "
                    "device; defer is not used)")
    add_device(ap)
    args = ap.parse_args(argv)
    device = open_device("probe_streaming", args.device)
    if device is None:
        return 2

    z = args.n // 36
    base, vid, cid = make_qc_ldpc(36, z, dv=3, dc=6, seed=12345)
    dec = QCDecoder(base, z, dtype=torch.bfloat16, device=device,
                    check_rule="minsum")
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(args.bps, 2)
    N0 = pa.variance * (10.0 ** (-args.snr / 10.0)) / 2.0
    nm = NoiseMapper(pa, N0, dtype=torch.bfloat16, device=device)

    def reconciler(defer=False):
        return StreamReconciler(dec, mat, pa, nm, batch=args.batch,
                                defer=defer)

    N_symb = mat.vnum // pa.bit_per_symbol
    rng = np.random.default_rng(0)
    F = args.frames
    x = rng.choice(pa.order, size=F * N_symb,
                   p=np.asarray(pa.probabilities))
    y = np.asarray(pa.constellation)[x] + math.sqrt(N0) * \
        rng.standard_normal(F * N_symb)
    chunk = int(args.chunk_frames * N_symb)
    spans = [(lo, min(lo + chunk, F * N_symb))
             for lo in range(0, F * N_symb, chunk)]
    wf = args.batch * N_symb
    tally = _Tally()

    if args.fused:
        reconciler().stream_fused(y[:wf], x[:wf], args.maxiter)
        sr = reconciler()
        _sync(device)
        t0 = time.perf_counter()
        tally.add(sr.stream_fused([y[a:b] for a, b in spans],
                                  [x[a:b] for a, b in spans], args.maxiter))
        mode = {"fused": True}
    elif args.handoff:
        warm = reconciler()
        r = warm.alice_step(warm.bob_step(y[:wf]), x[:wf], args.maxiter)
        assert r.frames == args.batch, r.frames
        sr = reconciler()
        _sync(device)
        t0 = time.perf_counter()
        for lo, hi in spans:
            tally.add(sr.alice_step(sr.bob_step(y[lo:hi]), x[lo:hi],
                                    args.maxiter))
        tally.add(sr.alice_step(sr.bob_step_flush(), np.empty(0, np.int64),
                                args.maxiter))
        mode = {"handoff": True}
    else:
        # one batch through both sides, flushed: in defer mode the batch
        # stays pending otherwise and Alice's first decode would land in
        # the timed loop
        warm = reconciler(bool(args.defer))
        w, s, nh = warm.bob_process(y[:wf])
        if w.shape[0] == 0:
            w, s, nh = warm.bob_flush()
        r = warm.alice_process(nh, x[:wf], s, args.maxiter, bob_words=w)
        r2 = warm.alice_flush(args.maxiter)
        assert r.frames + r2.frames == args.batch, (r.frames, r2.frames)
        sr = reconciler(bool(args.defer))
        _sync(device)
        t0 = time.perf_counter()
        for lo, hi in spans:
            w, s, nh = sr.bob_process(y[lo:hi])
            tally.add(sr.alice_process(nh, x[lo:hi], s, args.maxiter,
                                       bob_words=w))
        w, s, nh = sr.bob_flush()
        if w.shape[0]:
            tally.add(sr.alice_process(nh, np.empty(0, np.int64), s,
                                       args.maxiter, bob_words=w))
        tally.add(sr.alice_flush(args.maxiter))
        mode = {"defer": bool(args.defer)}
    _sync(device)
    elapsed = time.perf_counter() - t0

    emit({
        "frames": F, "decoded_frames": tally.frames, "batch": args.batch,
        "chunk_frames": args.chunk_frames, **mode, "snr_dB": args.snr,
        "success": tally.succ, "bit_errors": tally.bit_errors,
        "dispatches": sr.decode_dispatches,
        "elapsed_s": round(elapsed, 2),
        "symbols_per_s": round(F * N_symb / elapsed, 1),
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
