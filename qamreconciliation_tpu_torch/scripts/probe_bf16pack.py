"""Does the card run bf16 elementwise arithmetic two elements at a time?

The port's counterpart of the JAX package's ``scripts/probe_bf16pack.py``:
kernel 7 (``ops.kernels.elementwise_chain``) runs ``iters * chain``
elementwise steps on a [rows, cols] array held in registers, one read and
one write, in float32 and then in bfloat16 (packed ``bf16x2``
instructions), for two step kinds, the resident decoder's op classes:

  mac -- x = x * a + b
  exp -- x = exp(-|x|) * a + x * b

with a = 1 - 2^-8 and b = 2^-6, every operation rounded to the dtype.  A
bf16 column near twice the f32 one says the packed pair pays off; near 1,
it does not.  Inputs are ``default_rng(0)`` normals, one draw a (mode,
dtype) in the JAX probe's order.  On the CPU, where the plain version
runs one PyTorch operation a step, ``--iters`` is capped at 4.

    python -m qamreconciliation_tpu_torch.scripts.probe_bf16pack \\
        [--iters 8000] [--device cuda]

One record a mode after the device record: ``{mode, rows, cols, iters,
chain, f32_compile_s, f32_ms, f32_gops, bf16_compile_s, bf16_ms,
bf16_gops, bf16_speedup}``: ``*_ms`` the best of ``--reps`` calls, each
in a CUDA-event window, and ``*_gops`` the JAX probe's element operations
(rows * cols * iters * chain, times 3 for exp) per second, in 1e9.  Exits
2 without a card unless ``--device cpu``.
"""

import argparse
import sys

import numpy as np
import torch

from ._probe import add_device, each_ms, emit, first_call, open_device
from ..ops import kernels as K

__all__ = ["elem_ops", "main"]


def elem_ops(rows: int, cols: int, iters: int, chain: int, mode: str):
    """The JAX probe's count of element operations (a mac as one)."""
    return rows * cols * iters * chain * (1 if mode == "mac" else 3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_bf16pack")
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=8000)
    ap.add_argument("--chain", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    add_device(ap)
    args = ap.parse_args(argv)
    device = open_device("probe_bf16pack", args.device)
    if device is None:
        return 2
    if device.type == "cpu":
        args.iters = min(args.iters, 4)

    rng = np.random.default_rng(0)
    for mode in ("mac", "exp"):
        out = {"mode": mode, "rows": args.rows, "cols": args.cols,
               "iters": args.iters, "chain": args.chain}
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = torch.as_tensor(rng.normal(0, 1, (args.rows, args.cols)),
                                dtype=dtype, device=device)

            def run(x=x):
                return K.elementwise_chain(x, mode, args.iters, args.chain)

            out[f"{tag}_compile_s"] = round(first_call(run, device), 1)
            best = min(each_ms(run, args.reps, device))
            ops = elem_ops(args.rows, args.cols, args.iters, args.chain,
                           mode)
            out[f"{tag}_ms"] = round(best, 4)
            out[f"{tag}_gops"] = round(ops / best / 1e6, 1)
        out["bf16_speedup"] = round(out["f32_ms"] / out["bf16_ms"], 3)
        emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
