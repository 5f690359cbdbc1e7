"""Decode-only probe: ms per BP iteration of one decoder configuration.

The port's counterpart of the JAX package's ``scripts/probe_decode.py``.
The decoder decodes ``--batch`` frames of ``default_rng(0)`` LLRs ~ N(0, 3)
and a random syndrome, so every call runs exactly ``--maxiter``
iterations: a first call (``compile_s``: on the card the kernels' build,
load and first launches), then ``--reps`` calls, each in a CUDA-event
window; ``ms_per_iter`` is the best call over ``--maxiter``.

  --qc 1 (default): ``QCDecoder`` of ``make_qc_ldpc(nbv, n / nbv, 3, 6,
      seed=12345)``, or with ``--ira 1`` of ``make_qc_ira(nbv / 2, nbv / 2,
      n / nbv, 3, seed=12345)``: the dense flooding loop (kernel 1),
      ``--resident 1`` (kernel 2), ``--schedule layered`` (the plain
      layered loop) or ``--schedule layered --resident 1`` (kernel 3);
  --qc 0: the generic ``Decoder`` of ``make_regular_ldpc(n, 3, 6,
      seed=12345)`` (kernel 4).
  --pallas 0: the decoder's kernel hooks run their plain PyTorch versions
      (``bench.plain_twin``), the counterpart of the JAX package's XLA
      path; no kernel is launched.

``--resident-double``, ``--zchunk`` and ``--rowgroup`` are the JAX
decoder's TPU layout knobs: they are passed to ``QCDecoder``, which takes
them and picks its own Hopper launch shape.

    python -m qamreconciliation_tpu_torch.scripts.probe_decode \\
        [--qc 0] [--resident 1] [--schedule layered] [--device cuda]

One JSON record after the device record, with the JAX probe's keys; where
the JAX record of a resident QC decode has ``resident_double`` (a TPU
buffer) the port's has ``plan``, the launch plan of the resident kernel the
decode ran (``ops.kernels.resident_plan``; null when none ran), beside
``totals_f32``.  Exits 2 without a card unless ``--device cpu``.
"""

import argparse
import sys

import numpy as np
import torch

from ._probe import add_device, each_ms, emit, first_call, open_device
from .run_r5_sp_grid import kernel_plan
from ..bench import plain_twin
from ..config import as_dtype
from ..models.decoder import Decoder
from ..models.qc_decoder import QCDecoder, make_qc_ira, make_qc_ldpc
from ..ops import kernels as K
from ..utils.edgefile import make_regular_ldpc

__all__ = ["build_decoder", "main"]


def build_decoder(args, device):
    """The decoder ``args`` (the probe's flags) configure on ``device``."""
    dt = as_dtype(args.dtype)
    if args.qc:
        z = args.n // args.nbv
        if args.ira:
            base, _, _ = make_qc_ira(nb_info=args.nbv // 2,
                                     nb_acc=args.nbv // 2, z=z, dv=3,
                                     seed=12345)
        else:
            base, _, _ = make_qc_ldpc(args.nbv, z, dv=3, dc=6, seed=12345)
        dec = QCDecoder(
            base, z, dtype=dt, device=device, check_rule=args.check,
            schedule=args.schedule, layered_chunk=args.layered_chunk,
            layered_groups=(None if args.layered_groups < 0
                            else bool(args.layered_groups)),
            resident=bool(args.resident),
            resident_chunk=args.resident_chunk,
            resident_double=(None if args.resident_double < 0
                             else bool(args.resident_double)),
            resident_zchunk=args.zchunk or None,
            resident_rowgroup=None if args.rowgroup < 0 else args.rowgroup,
            totals_dtype=args.totals_dtype, check_phi=args.phi)
    else:
        vid, cid = make_regular_ldpc(args.n, dv=3, dc=6, seed=12345)
        dec = Decoder(vid, cid, dtype=dt, device=device,
                      check_rule=args.check, check_phi=args.phi)
    return dec if args.pallas else plain_twin(dec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_decode")
    ap.add_argument("--n", type=int, default=64800)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--qc", type=int, default=1)
    ap.add_argument("--pallas", type=int, default=1)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--maxiter", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--check", default="sumproduct",
                    choices=["sumproduct", "minsum"])
    ap.add_argument("--schedule", default="flooding",
                    choices=["flooding", "layered"])
    ap.add_argument("--resident", type=int, default=0)
    ap.add_argument("--phi", default="phi", choices=["phi", "tanhfb"])
    ap.add_argument("--resident-chunk", type=int, default=50)
    ap.add_argument("--totals-dtype", default="storage",
                    choices=["storage", "float32"])
    ap.add_argument("--resident-double", type=int, default=-1,
                    help="-1 auto, 0 off, 1 on (a TPU buffer: accepted, "
                    "without effect)")
    ap.add_argument("--zchunk", type=int, default=0,
                    help="0 = auto (a TPU z-chunk: accepted, without "
                    "effect)")
    ap.add_argument("--ira", type=int, default=0,
                    help="1 = irregular QC-IRA code (nb_info = nb_acc = "
                    "nbv/2, dv=3: mixed check degrees)")
    ap.add_argument("--nbv", type=int, default=36,
                    help="variable blocks; z = n/nbv (nbv=180: the DVB-S2 "
                    "shape, z=360, 90 check block rows)")
    ap.add_argument("--rowgroup", type=int, default=-1,
                    help="resident_rowgroup: -1 auto, 0 off, >=2 cap (a TPU "
                    "split: accepted, without effect)")
    ap.add_argument("--layered-groups", type=int, default=-1,
                    help="layered schedule: -1 auto, 0 serial, 1 grouped")
    ap.add_argument("--layered-chunk", type=int, default=4,
                    help="layered sweeps per host check")
    add_device(ap)
    args = ap.parse_args(argv)
    if args.n % args.nbv:
        ap.exit(1, f"--n {args.n} must be divisible by --nbv {args.nbv}\n")
    if args.ira and args.nbv % 2:
        ap.exit(1, "--ira needs an even --nbv (nb_info = nb_acc = nbv/2)\n")
    device = open_device("probe_decode", args.device)
    if device is None:
        return 2

    dt = as_dtype(args.dtype)
    dec = build_decoder(args, device)
    rng = np.random.default_rng(0)
    lappr = torch.as_tensor(rng.normal(0, 3.0, (args.n, args.batch)),
                            dtype=dt, device=device)
    synd = torch.as_tensor(rng.integers(0, 2, (dec.cnum, args.batch)),
                           dtype=torch.int32, device=device)
    f = dec._build_decode()
    K.bp_decode_rounds_qc.plan = K.bp_layered_sweeps_qc.plan = None
    compile_s = first_call(lambda: f(lappr, synd, args.maxiter), device)
    print(f"compile+first: {compile_s:.1f}s", file=sys.stderr, flush=True)
    rep_ms = each_ms(lambda: f(lappr, synd, args.maxiter), args.reps,
                     device)
    ms_iter = min(rep_ms) / args.maxiter
    extras = {}
    if args.qc and args.resident:
        extras = {"plan": kernel_plan(dec),
                  "totals_f32": dec._resident_layout(args.batch)[1]}
    emit({
        "n": args.n, "nbv": args.nbv, "batch": args.batch, "qc": args.qc,
        "pallas": args.pallas, "dtype": args.dtype, "check": args.check,
        "schedule": args.schedule, "resident": args.resident,
        "phi": args.phi, "resident_chunk": args.resident_chunk,
        "totals_dtype": args.totals_dtype,
        "ms_per_iter": round(ms_iter, 3),
        "decode_fps": round(args.batch / (ms_iter * args.maxiter) * 1e3, 1),
        "compile_s": round(compile_s, 1),
        **extras,
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
