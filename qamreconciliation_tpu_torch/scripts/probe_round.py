"""Cost breakdown of the engine's softening round (the bench workload).

The port's counterpart of the JAX package's ``scripts/probe_round.py``:
four stages of one round of ``ReconciliationEngine`` on the QC(3,6) code
``make_qc_ldpc(36, n / 36, 3, 6, seed=12345)`` (the dense QCDecoder,
sum-product, kernel 1), ``--batch`` frames of ``--bps``-bit PAM at
``--snr`` dB (default 3.5 for bps 2, else 10), so that round - decode -
preamble(+synd) exposes the counting and overhead residue:

  (a) syndrome_from_bits -- the generic graph's syndrome gather
      (``TannerGraph.syndrome_from_bits``, the JAX ``dec.graph``'s) of a
      random word;
  (b) preamble+synd      -- the draw, Bob's decision and softened noise,
      his word, Alice's poly LLRs and the word's syndrome (no decode);
  (c) full_round         -- ``ReconciliationEngine.softening_round``;
  (d) decode_only        -- the decoder's ``_build_decode()`` entry on
      random LLRs and syndrome.

Draws come from a ``torch.Generator`` seeded 0 at each call, as every JAX
call reuses ``jax.random.key(0)``; the word and the decode's inputs from
numpy's ``default_rng(0)``, in the JAX order.

    python -m qamreconciliation_tpu_torch.scripts.probe_round \\
        [--bps 4] [--device cuda]

One record a stage after the device record: ``{stage, bps, ms,
compile_s}``: ``compile_s`` the first call's host seconds, ``ms`` the mean
of ``--reps`` calls in one CUDA-event window.  Exits 2 without a card
unless ``--device cpu``.
"""

import argparse
import math
import sys

import numpy as np
import torch

from ._probe import add_device, emit, first_call, open_device, window_ms
from ..config import as_dtype
from ..models.alphabet import PAMAlphabet
from ..models.decoder import TannerGraph
from ..models.matrix import Matrix
from ..models.noisemapper import NoiseMapper
from ..models.qc_decoder import QCDecoder, make_qc_ldpc
from ..sims.engine import ReconciliationEngine

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_round")
    ap.add_argument("--n", type=int, default=64800)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--bps", type=int, default=4)
    ap.add_argument("--snr", type=float, default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--maxiter", type=int, default=50)
    add_device(ap)
    args = ap.parse_args(argv)
    device = open_device("probe_round", args.device)
    if device is None:
        return 2
    snr = args.snr if args.snr is not None else (3.5 if args.bps == 2
                                                 else 10.0)

    dt = as_dtype(args.dtype)
    z = args.n // 36
    base, vid, cid = make_qc_ldpc(36, z, dv=3, dc=6, seed=12345)
    dec = QCDecoder(base, z, dtype=dt, device=device)
    graph = TannerGraph(vid, cid, device=device)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(args.bps, 2.0)
    eng = ReconciliationEngine(dec, mat, pa, batch=args.batch, dtype=dt,
                               llr_mode="poly")
    N0 = pa.variance * (10.0 ** (-snr / 10.0)) / 2.0
    nm = NoiseMapper(pa, N0, np.zeros(pa.order, np.uint8), dtype=dt,
                     device=device)
    nm._ensure_llr_poly()
    sigma, alpha = math.sqrt(N0), 1.0
    gen = torch.Generator(device=device)
    B = args.batch

    rng = np.random.default_rng(0)
    word = torch.as_tensor(rng.integers(0, 2, (eng.N, B)), dtype=torch.int32,
                           device=device)

    def timeit(name, fn):
        compile_s = first_call(fn, device)
        ms = window_ms(fn, args.reps, device)
        emit({"stage": name, "bps": args.bps, "ms": round(ms, 2),
              "compile_s": round(compile_s, 1)})

    # (a) the generic syndrome gather alone
    timeit("syndrome_from_bits", lambda: graph.syndrome_from_bits(word))

    # (b) preamble + syndrome, no decode: the round up to the decode call
    def preamble_synd():
        gen.manual_seed(0)
        x, y = eng._sample_sb(gen, sigma)
        lappr, w = eng._softening_inputs(nm, x, y, alpha)
        return lappr, graph.syndrome_from_bits(w.to(torch.int32))

    timeit("preamble+synd", preamble_synd)

    # (c) the full round
    def full_round():
        gen.manual_seed(0)
        return eng.softening_round(nm, sigma, alpha, args.maxiter,
                                   generator=gen)

    timeit("full_round", full_round)

    # (d) the decode alone
    f = dec._build_decode()
    lappr = torch.as_tensor(rng.normal(0, 3.0, (eng.N, B)), dtype=dt,
                            device=device)
    synd = torch.as_tensor(rng.integers(0, 2, (dec.cnum, B)),
                           dtype=torch.int32, device=device)
    timeit("decode_only", lambda: f(lappr, synd, args.maxiter))
    return 0


if __name__ == "__main__":
    sys.exit(main())
