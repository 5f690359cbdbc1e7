"""The ``stream_fused`` decode-engine grid at z = 360, then resident decode
probes, in one process.

The port's counterpart of the JAX package's
``scripts/run_r5_stream_grid.py``: ``sims/streaming.StreamReconciler.
stream_fused`` over ``--frames`` frames of 4-PAM at 4.0 dB in 2.33-frame
chunks, with the dense, resident (chunk 25 and 50) and resident layered
min-sum decoders at B = 64 and 128 (a warm-up call on one batch, then the
best of ``--reps`` streams), then four min-over-4 decode probes at B = 128:
resident sum-product (also with ``resident_double``, which the port accepts
and ignores), resident min-sum and dense min-sum.

    python -m qamreconciliation_tpu_torch.scripts.run_r5_stream_grid \\
        [--configs "stream resident"] [--skip-decode-probes 1] \\
        [--device cuda] > r5_grid1.jsonl

``--configs`` filters the stream configs only, as in the JAX script.  One
JSON record a config after the device record; exit 1 when one failed.
"""

import argparse
import math
import sys
import time

import numpy as np
import torch

from . import _codes
from ._runner import Campaign, add_args, sync, time_decode
from ..models.alphabet import PAMAlphabet
from ..models.matrix import Matrix
from ..models.noisemapper import NoiseMapper
from ..models.qc_decoder import QCDecoder, make_qc_ldpc
from ..sims.streaming import StreamReconciler

__all__ = ["ENGINES", "GRID", "PROBES", "main"]

# each engine's decoder keywords (bf16 min-sum), given the resident chunk
ENGINES = {
    "dense": lambda rc: dict(check_rule="minsum"),
    "resident": lambda rc: dict(check_rule="minsum", resident=True,
                                resident_chunk=rc),
    "layered": lambda rc: dict(check_rule="minsum", schedule="layered",
                               resident=True),
}
# (name, engine, batch, resident chunk)
GRID = [
    ("stream dense b64", "dense", 64, 25),
    ("stream resident25 b64", "resident", 64, 25),
    ("stream resident25 b128", "resident", 128, 25),
    ("stream resident50 b128", "resident", 128, 50),
    ("stream layered b128", "layered", 128, 0),
    ("stream layered b64", "layered", 64, 0),
]
# (name, decoder keywords) of the decode probes
PROBES = [
    ("sp resident baseline",
     dict(check_rule="sumproduct", resident=True, resident_chunk=50)),
    ("sp resident doubled",
     dict(check_rule="sumproduct", resident=True, resident_chunk=50,
          resident_double=True)),
    ("minsum resident c50",
     dict(check_rule="minsum", resident=True, resident_chunk=50)),
    ("minsum dense", dict(check_rule="minsum")),
]
PROBE_ITERS = 250
PROBE_REPS = 4


def log(m):
    print(m, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_r5_stream_grid")
    ap.add_argument("--n", type=int, default=64800)
    ap.add_argument("--nbv", type=int, default=180)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--snr", type=float, default=4.0)
    ap.add_argument("--maxiter", type=int, default=50)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--chunk-frames", type=float, default=2.33)
    ap.add_argument("--skip-decode-probes", type=int, default=0)
    ap.add_argument("--configs", default="",
                    help="comma list to filter config names (substring)")
    add_args(ap)
    args = ap.parse_args(argv)

    camp = Campaign("run_r5_stream_grid", args.device)
    z = args.n // args.nbv
    base, vid, cid = make_qc_ldpc(args.nbv, z, dv=3, dc=6, seed=_codes.SEED)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2)
    N0 = pa.variance * (10.0 ** (-args.snr / 10.0)) / 2.0
    nm = NoiseMapper(pa, N0, dtype=torch.bfloat16, device=args.device)
    N_symb = args.n // 2
    rng = np.random.default_rng(0)
    F = args.frames
    x = rng.choice(pa.order, size=F * N_symb, p=np.asarray(pa.probabilities))
    y = (np.asarray(pa.constellation)[x]
         + math.sqrt(N0) * rng.standard_normal(F * N_symb))
    chunk = int(args.chunk_frames * N_symb)
    y_chunks = [y[a:a + chunk] for a in range(0, F * N_symb, chunk)]
    x_chunks = [x[a:a + chunk] for a in range(0, F * N_symb, chunk)]

    def decoder(**kw):
        return QCDecoder(base, z, dtype=torch.bfloat16, device=args.device,
                         **kw)

    flt = [s for s in args.configs.split(",") if s]
    for name, engine, B, rc in GRID:
        if flt and not any(s in name for s in flt):
            continue
        with camp.config({"config": name}):
            dec = decoder(**ENGINES[engine](rc))
            t0 = time.perf_counter()
            StreamReconciler(dec, mat, pa, nm, batch=B).stream_fused(
                y[: B * N_symb], x[: B * N_symb], args.maxiter)
            compile_s = time.perf_counter() - t0
            log(f"{name}: warm-up {compile_s:.1f}s")
            els = []
            for _ in range(args.reps):
                sr = StreamReconciler(dec, mat, pa, nm, batch=B)
                sync(args.device)
                t0 = time.perf_counter()
                r = sr.stream_fused(y_chunks, x_chunks, args.maxiter)
                sync(args.device)
                els.append(time.perf_counter() - t0)
            camp.emit({
                "config": name, "engine": engine, "batch": B,
                "resident_chunk": rc, "z": z, "nbv": args.nbv,
                "frames": r.frames, "fer": round(r.fer, 4),
                "bit_errors": r.bit_errors,
                "compile_s": round(compile_s, 1),
                "rep_s": [round(e, 2) for e in els],
                "symbols_per_s": round(F * N_symb / min(els), 1),
            })

    if args.skip_decode_probes:
        return camp.status()

    rng = np.random.default_rng(0)
    B = 128
    lappr = rng.normal(0, 3.0, (args.n, B))
    synd = rng.integers(0, 2, (args.n // 2, B))
    for name, kw in PROBES:
        with camp.config({"config": name}):
            dec = decoder(**kw)
            compile_s, ms = time_decode(
                dec, torch.as_tensor(lappr, dtype=torch.bfloat16,
                                     device=dec.device),
                torch.as_tensor(synd, dtype=torch.int32, device=dec.device),
                PROBE_ITERS, PROBE_REPS)
            camp.emit({
                "config": name, "z": z, "batch": B,
                "compile_s": round(compile_s, 1),
                "ms_per_iter": round(min(ms) / PROBE_ITERS, 4),
                "reps_ms_per_iter": [round(m / PROBE_ITERS, 4) for m in ms],
            })
    return camp.status()


if __name__ == "__main__":
    sys.exit(main())
