"""What each piece of the resident decoder's bookkeeping costs: kernel 9 in
four variants.

The port's counterpart of the JAX package's
``scripts/probe_resident_vmem.py``, which bisected the TPU kernel's VMEM
spills.  Kernel 9 (``ops.kernels.resident_bookkeeping_probe``) runs K
normalized min-sum flooding iterations (alpha 0.8125) of the QC(3,6) code
``make_qc_ldpc(36, n / 36, 3, 6, seed=12345)`` in bf16, the 18 block rows
of the JAX probe, with the bookkeeping of one cumulative variant:

  nobook     the check pass and the variable pass only;
  violonly   + the per-frame violation count (stored, read by nothing);
  nocapture  + conv / newly / iters / done;
  full       + the capture of the totals of newly converged frames.

Inputs are the JAX probe's, from numpy's ``default_rng(0)``: totals ~ N(0,
3) in bf16 (also the prior and the initial final), zero messages, a random
syndrome; ``it0 = 0`` and ``maxiter = 10^6``.  The JAX kernel's 8-sublane
replication of done and iters and its ``--zc`` z-chunk are TPU layout:
here done, iters and the violation count are [B], and ``--zc`` is only
recorded.

    python -m qamreconciliation_tpu_torch.scripts.probe_resident_vmem \\
        --variant nocapture [--k 8] [--device cuda]

Prints, after the device record, the JAX probe's lines ``<variant>:
COMPILED+RAN in Xs`` (the first call: build, load and run) and
``<variant>: X ms/iter (K iters/call, 6 calls)`` (a CUDA-event window
over 6 chained calls), then the Hopper meaning of the Mosaic spill and
out-of-memory lines the JAX probe looks for: the instance's registers and
spill bytes from ptxas's report, with the launch plan.  An error raises.
Exits 2 without a card unless ``--device cpu``.
"""

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ._probe import add_device, first_call, open_device, window_ms
from ..models.qc_decoder import make_qc_ldpc
from ..ops import cuda_build
from ..ops import kernels as K

__all__ = ["VARIANTS", "CALLS", "code_tables", "inputs", "mixed_state",
           "instance_key", "main"]

VARIANTS = list(K.BOOKKEEPING_VARIANTS)
CALLS = 6          # chained calls in the timed window
NB_C = 18          # the JAX probe's block rows


def code_tables(n: int):
    """:class:`~..ops.kernels.QCTables` of the probe's code at length n."""
    z = n // 36
    base, _, _ = make_qc_ldpc(36, z, dv=3, dc=6, seed=12345)
    rows = [[] for _ in range(NB_C)]
    for c, v, s in base:
        rows[c].append((v, s))
    return K.QCTables(rows, z)


def inputs(tables, B: int, device):
    """The JAX probe's state, in its draw order: ``(total, c2v, prior,
    synd8, final, done, iters, viol)``; prior and final are copies of the
    totals, as the JAX arrays are the same value."""
    rng = np.random.default_rng(0)
    nb_v, z = tables.nb_v, tables.z
    total = torch.as_tensor(rng.normal(0, 3, (nb_v, z, B)),
                            dtype=torch.bfloat16, device=device)
    synd8 = torch.as_tensor(rng.integers(0, 2, (tables.nb_c, z, B)),
                            dtype=torch.int8, device=device)
    c2v = torch.zeros((tables.E, z, B), dtype=torch.bfloat16, device=device)
    ints = [torch.zeros(B, dtype=torch.int32, device=device)
            for _ in range(3)]
    return (total, c2v, total.clone(), synd8, total.clone(), *ints)


def mixed_state(tables, B: int, seed: int, device):
    """A state in which frames converge at different iterations: totals ~
    N(0, 3) in bf16, a syndrome equal to the hard decisions' in the first
    half of the frames (they converge at once) and in the second quarter
    two of those decisions flipped at magnitude 0.5 (they converge after
    a few iterations, when the min-sum messages correct them); the last
    half keeps a random syndrome.  Returns the tuple of :func:`inputs`."""
    rng = np.random.default_rng(seed)
    nb_v, z = tables.nb_v, tables.z
    tot = rng.normal(0, 3, (nb_v, z, B))
    synd = rng.integers(0, 2, (tables.nb_c, z, B))
    bits = torch.as_tensor(tot < 0, dtype=torch.int32).reshape(-1, B)
    for cbs, gidx, _, deg in tables.row_groups([range(tables.nb_c)], "cpu"):
        par = bits.index_select(0, gidx.reshape(-1)).view(
            len(cbs), deg, z, B).sum(1) & 1
        synd[cbs.numpy(), :, :B // 2] = par[:, :, :B // 2].numpy()
    flat = tot.reshape(-1, B)
    for b in range(B // 4, B // 2):
        at = rng.choice(flat.shape[0], 2, replace=False)
        flat[at, b] = -0.5 * np.sign(flat[at, b])
    total = torch.as_tensor(tot, dtype=torch.bfloat16, device=device)
    synd8 = torch.as_tensor(synd, dtype=torch.int8, device=device)
    c2v = torch.zeros((tables.E, z, B), dtype=torch.bfloat16, device=device)
    ints = [torch.zeros(B, dtype=torch.int32, device=device)
            for _ in range(3)]
    return (total, c2v, total.clone(), synd8, total.clone(), *ints)


def instance_key(variant: str, plan) -> str:
    """The mangled-name key of kernel 9's instance for ``variant`` under a
    :class:`~..ops.kernels.StagedRowsPlan` (its totals, ``"shared"`` or
    ``"global"``, and its path, ``"bulk"`` or ``"thread"``)."""
    return (f"bookkeeping_kernelILi{K.BOOKKEEPING_VARIANTS[variant]}"
            f"ELb{int(plan.totals == 'shared')}ELb{int(plan.path == 'bulk')}"
            "EE")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_resident_vmem")
    ap.add_argument("--variant", default="full")
    ap.add_argument("--zc", type=int, default=360)
    ap.add_argument("--n", type=int, default=64800)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--k", type=int, default=8)
    add_device(ap)
    args = ap.parse_args(argv)
    device = open_device("probe_resident_vmem", args.device)
    if device is None:
        return 2

    tables = code_tables(args.n)
    total, c2v, prior, synd8, final, done, iters, viol = inputs(
        tables, args.batch, device)

    def step():
        return K.resident_bookkeeping_probe(
            tables, 0, 10 ** 6, total, c2v, prior, synd8, final, done,
            iters, viol, variant=args.variant, k_rounds=args.k)

    K.resident_bookkeeping_probe.plan = None
    print(f"{args.variant}: COMPILED+RAN in "
          f"{first_call(step, device):.1f}s", flush=True)
    ms_iter = window_ms(step, CALLS, device) / args.k
    print(f"{args.variant}: {ms_iter:.3f} ms/iter ({args.k} iters/call, "
          f"{CALLS} calls)", flush=True)
    plan = K.resident_bookkeeping_probe.plan
    if plan is None:
        print(f"{args.variant}: ptxas none (the plain version ran on "
              f"{device.type}); --zc {args.zc} not used", flush=True)
        return 0
    report = cuda_build.ptxas_report(
        cuda_build.build("resident_bookkeeping_probe"))
    use = cuda_build.ptxas_usage(report,
                                 instance_key(args.variant, plan))
    print(f"{args.variant}: ptxas {use['registers']} registers, "
          f"{use['spill_stores']} bytes spill stores, {use['spill_loads']} "
          f"bytes spill loads; plan {dataclasses.asdict(plan)}; --zc "
          f"{args.zc} not used (a TPU VMEM z-chunk)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
