"""Split the dense QC flooding iteration into its data movement and its
check phase.

The port's counterpart of the JAX package's ``scripts/probe_qc_parts.py``.
Two 50-step loops on the (3, 6) QC code ``make_qc_ldpc(36, n / 36, 3, 6,
seed=12345)``, each step fed by the last:

  rolls -- the two halves of the port's own dense iteration that move data:
           ``QCDecoder.gather_totals`` (one index-select over the totals)
           and ``scatter_partials`` (the ``(cb, slot)`` fold of each
           variable's messages), as ``prior + scatter(gather(total) *
           0.33)``.  The fold sums in the decoder's ``sum_dtype`` (float32
           for bf16 messages) and the step rounds once to the dtype, where
           the JAX probe adds bf16 slabs: the bf16 figure is the port's f32
           fold.
  check -- the check phase on ``t0 + c2v * 0.01``: kernel 1
           (``ops.kernels.bp_check_phase_qc``) with ``--pallas 1``, the
           plain PyTorch phi update (``ops.kernels._check_messages``, no
           violation counts) on ``t0 + c2v * 0.01 - c2v`` with
           ``--pallas 0``.

Constants are tensors of the working dtype, as JAX's weak-typed ones are.

    python -m qamreconciliation_tpu_torch.scripts.probe_qc_parts \\
        --part rolls|check [--pallas 0] [--dtype float32] [--device cuda]

One record after the device record: ``{part, batch, pallas, dtype,
ms_per_iter, compile_s}`` (the mean of ``--reps`` loops in one CUDA-event
window, divided by ``--iters``).  Exits 2 without a card unless ``--device
cpu``.
"""

import argparse
import sys

import numpy as np
import torch

from ._probe import add_device, emit, first_call, open_device, window_ms
from ..config import as_dtype
from ..models.qc_decoder import QCDecoder, make_qc_ldpc
from ..ops import kernels as K
from ..ops.boxplus import MINSUM_ALPHA

__all__ = ["rolls_body", "check_body", "plain_check_update", "main"]


def rolls_body(dec, prior):
    """``total -> prior + scatter_partials(gather_totals(total) * 0.33)``,
    summed in the decoder's ``sum_dtype`` and rounded to prior's dtype."""
    c = torch.tensor(0.33, dtype=prior.dtype, device=prior.device)

    def body(total):
        acc = dec.scatter_partials(dec.gather_totals(total) * c)
        return (prior.to(acc.dtype) + acc).to(prior.dtype)

    return body


def plain_check_update(v2c, synd):
    """The phi check update of the JAX probe's ``--pallas 0`` loop: float32
    math for bf16 messages, result in v2c's dtype."""
    out_dtype = v2c.dtype
    if out_dtype == torch.bfloat16:
        v2c = v2c.float()
    return K._check_messages(v2c, synd, 1, "sumproduct", 1e-30,
                             MINSUM_ALPHA, 0.0).to(out_dtype)


def check_body(t0, synd, pallas: bool):
    """``c2v -> `` the new messages of the check phase on ``t0 + c2v *
    0.01`` (kernel 1) or on ``t0 + c2v * 0.01 - c2v`` (the plain update)."""
    c = torch.tensor(0.01, dtype=t0.dtype, device=t0.device)
    if pallas:
        return lambda c2v: K.bp_check_phase_qc(t0 + c2v * c, c2v, synd)[0]
    return lambda c2v: plain_check_update(t0 + c2v * c - c2v, synd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_qc_parts")
    ap.add_argument("--part", choices=["rolls", "check"], required=True)
    ap.add_argument("--n", type=int, default=64800)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--pallas", type=int, default=1)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    add_device(ap)
    args = ap.parse_args(argv)
    device = open_device("probe_qc_parts", args.device)
    if device is None:
        return 2

    dt = as_dtype(args.dtype)
    z = args.n // 36
    base, _, _ = make_qc_ldpc(36, z, dv=3, dc=6, seed=12345)
    dec = QCDecoder(base, z, dtype=dt, device=device)
    nb_c, nb_v, dc = dec.nb_c, dec.nb_v, dec.dc
    B = args.batch

    rng = np.random.default_rng(0)
    synd = torch.as_tensor(rng.integers(0, 2, (nb_c, z, B)),
                           dtype=torch.int32, device=device)
    prior = torch.as_tensor(rng.normal(0, 3.0, (nb_v, z, B)), dtype=dt,
                            device=device)
    if args.part == "rolls":
        body = rolls_body(dec, prior)
        arg = prior
    else:
        t0 = torch.as_tensor(rng.normal(0, 3.0, (nb_c, dc, z, B)), dtype=dt,
                             device=device)
        body = check_body(t0, synd, bool(args.pallas))
        arg = torch.zeros((nb_c, dc, z, B), dtype=dt, device=device)

    def loop():
        x = arg
        for _ in range(args.iters):
            x = body(x)
        return x

    compile_s = first_call(loop, device)
    print(f"compile+first: {compile_s:.1f}s", file=sys.stderr, flush=True)
    ms = window_ms(loop, args.reps, device) / args.iters
    emit({"part": args.part, "batch": B, "pallas": args.pallas,
          "dtype": args.dtype, "ms_per_iter": round(ms, 4),
          "compile_s": round(compile_s, 1)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
