"""Monte-Carlo mutual-information throughput over math modes and masks.

The port's counterpart of the JAX package's ``scripts/run_r5_mi_grid.py``:
``models/mutual_information.montecarlo_information`` at bps 2 (and one bps
4 row), 2^21 samples at 8 dB, across the g^-1 forms (interp, poly), the
CDF forms (erf, poly) and the ``which`` masks that split the cost between
the sampling preamble, the closed-form estimators and I(X,N;Xhat).  A
``torch.Generator`` seeded 0 stands in for the JAX key; every call draws
fresh samples from it.

    python -m qamreconciliation_tpu_torch.scripts.run_r5_mi_grid \\
        [--n 2097152] [--reps 3] [--device cuda] > r5_mi_grid.jsonl

One JSON record a config after the device record; exit 1 when one failed.
"""

import argparse
import sys
import time

import torch

from ._runner import Campaign, add_args, sync
from ..models import mutual_information as mi
from ..models.alphabet import PAMAlphabet
from ..models.noisemapper import NoiseMapper

__all__ = ["GRID", "main"]

W = (True, True, True)
# (name, bps, which, ginv, fy, n or None for --n)
GRID = [
    ("r2-baseline interp/erf", 2, W, "interp", "erf", None),
    ("cli-default poly/erf", 2, W, "poly", "erf", None),
    ("poly/poly", 2, W, "poly", "poly", None),
    ("no-IXN (preamble+closed)", 2, (True, True, False), "poly", "erf", None),
    ("only-IXN", 2, (False, False, True), "poly", "erf", None),
    ("only-IXXhat (preamble floor)", 2, (True, False, False), "poly", "erf",
     None),
    ("bps4 default", 4, W, "poly", "erf", 1 << 19),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_r5_mi_grid")
    ap.add_argument("--n", type=int, default=1 << 21)
    ap.add_argument("--snr", type=float, default=8.0)
    ap.add_argument("--reps", type=int, default=3)
    add_args(ap)
    args = ap.parse_args(argv)

    camp = Campaign("run_r5_mi_grid", args.device)
    for name, bps, which, ginv, fy, n in GRID:
        n = n or args.n
        with camp.config({"config": name}):
            pa = PAMAlphabet(bps, 2)
            N0 = pa.variance * (10.0 ** (-args.snr / 10.0)) / 2.0
            nm = NoiseMapper(pa, N0, dtype=torch.float32, device=args.device,
                             fy_mode=fy)
            if ginv == "poly":
                nm._ensure_ginv_poly()
            if fy == "poly":
                nm._ensure_fy_poly()
            p_Xhat = mi.P_xhat(nm)
            gen = torch.Generator(device=nm.device).manual_seed(0)
            ts = []
            for _ in range(args.reps + 1):
                sync(nm.device)
                t0 = time.perf_counter()
                mi.montecarlo_information(gen, pa, nm, p_Xhat, n,
                                          which=which, ginv_mode=ginv)
                sync(nm.device)
                ts.append(time.perf_counter() - t0)
            camp.emit({
                "config": name, "bps": bps, "which": list(which),
                "ginv": ginv, "fy": fy, "n": n,
                "compile_s": round(ts[0], 1),
                "rep_s": [round(t, 3) for t in ts[1:]],
                "samples_per_s": round(n / min(ts[1:]), 1),
            })
    return camp.status()


if __name__ == "__main__":
    sys.exit(main())
