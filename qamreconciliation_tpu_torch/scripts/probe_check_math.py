"""Is the QC check phase (kernel 1) bound by its slot math or by its bytes?

The port's counterpart of the JAX package's ``scripts/probe_check_math.py``:
a 50-step loop of kernel 6 (``ops.kernels.check_math_probe``, kernel 1's
memory pattern on warp-specialised staged tiles of its own, plan
``ops.kernels.probe_tile_plan``) with one of three slot maths,

  phi    -- kernel 1's phi sum-product (the baseline),
  copy   -- out = t - c2v (no transcendentals: the floor of the memory
            pattern),
  minsum -- the probe's normalized min-sum (min1/min2 and the sign product,
            no phi),

at the JAX probe's shapes: t and c2v [18, 6, n / 36, B], syndrome [18,
n / 36, B], drawn from numpy's ``default_rng(0)`` (t ~ N(0, 3), c2v ~ N(0, 1),
bits).  Each step feeds the next (t <- t + 0.001 out, c2v <- out, the
constant in the working dtype), so no step can be skipped.

    python -m qamreconciliation_tpu_torch.scripts.probe_check_math \\
        --math copy [--dtype float32] [--device cuda]

One record after the device record: ``{math, zb, dtype, ms_per_iter,
compile_s}``; ``zb`` is the checks per tile of the kernel's plan (the JAX
probe's z-block; null on the CPU, where the plain version runs), and
``ms_per_iter`` the mean of ``--reps`` loops in one CUDA-event window,
divided by ``--iters``.  Exits 2 without a card unless ``--device cpu``.
"""

import argparse
import sys

import numpy as np
import torch

from ._probe import add_device, emit, first_call, open_device, window_ms
from ..config import as_dtype
from ..ops import kernels as K

__all__ = ["NB_C", "DC", "inputs", "step", "main"]

NB_C, DC = 18, 6    # the probe's block rows and check degree


def inputs(n: int, B: int, dtype, device):
    """(t, c2v, synd) of the JAX probe: [18, 6, n / 36, B] in ``dtype``
    and int32 bits, from ``default_rng(0)``."""
    z = n // 36
    rng = np.random.default_rng(0)
    t = rng.normal(0, 3, (NB_C, DC, z, B))
    c2v = rng.normal(0, 1, (NB_C, DC, z, B))
    synd = rng.integers(0, 2, (NB_C, z, B))
    return (torch.as_tensor(t, dtype=dtype, device=device),
            torch.as_tensor(c2v, dtype=dtype, device=device),
            torch.as_tensor(synd, dtype=torch.int32, device=device))


def step(t, c2v, synd, math: str, eps):
    """One step of the loop: ``(t + eps * out, out)``, ``eps`` the 0.001
    of the working dtype (a tensor made once: a host scalar copied to the
    card each step would synchronize the stream)."""
    out, _ = K.check_math_probe(t, c2v, synd, math)
    return t + eps * out, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_check_math")
    ap.add_argument("--math", choices=["phi", "copy", "minsum"],
                    required=True)
    ap.add_argument("--n", type=int, default=64800)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    add_device(ap)
    args = ap.parse_args(argv)
    device = open_device("probe_check_math", args.device)
    if device is None:
        return 2

    t, c2v, synd = inputs(args.n, args.batch, as_dtype(args.dtype), device)
    eps = torch.tensor(0.001, dtype=t.dtype, device=device)

    def loop():
        tc, cc = t, c2v
        for _ in range(args.iters):
            tc, cc = step(tc, cc, synd, args.math, eps)
        return tc, cc

    K.check_math_probe.plan = None
    compile_s = first_call(loop, device)
    ms = window_ms(loop, args.reps, device) / args.iters
    plan = K.check_math_probe.plan
    emit({"math": args.math, "zb": None if plan is None else plan.checks,
          "dtype": args.dtype, "ms_per_iter": round(ms, 4),
          "compile_s": round(compile_s, 1)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
