"""The 16-PAM (bps 4) mode and CDF-form throughput grid in one process.

The port's counterpart of the JAX package's ``scripts/run_bps4_grid.py``:
two near-identical points a config (the first absorbs the warm-up, the
second is the clean frames/s), 4096 frames at ``--rounds-per-dispatch 4``,
early exit off, min-sum bf16 everywhere so that the configs differ in the
round preamble alone: softening with ``--fy-mode`` erf, erf_flat and poly,
soft direct and hard reverse, on the QC(3,6) z = 1800 code.

    python -m qamreconciliation_tpu_torch.scripts.run_bps4_grid \\
        [--snr 12.0] [--simloops 4096] [--device cuda] > bps4_grid.jsonl

Each config's CSV goes to the temporary directory as ``bps4_<name>.csv``;
one JSON record a config (its CSV, wall time, each point's FER and
frames/s) after the device record; exit 1 when one failed.
"""

import argparse
import os
import sys
import tempfile
import time

from . import _codes
from ._runner import Campaign, add_args

__all__ = ["CONFIGS", "main"]

CONFIGS = [
    ("soft-erf", ["--fy-mode", "erf"]),
    ("soft-erf_flat", ["--fy-mode", "erf_flat"]),
    ("soft-poly", ["--fy-mode", "poly"]),
    ("direct", ["--direct"]),
    ("hard", ["--hard"]),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_bps4_grid")
    ap.add_argument("--snr", type=float, default=12.0)
    ap.add_argument("--simloops", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=128)
    add_args(ap)
    args = ap.parse_args(argv)

    camp = Campaign("run_bps4_grid", args.device)
    code_csv = _codes.qc_ldpc(36)
    common = [code_csv, "--qc", "--snr", str(args.snr),
              str(args.snr + 0.01), "--nsnr", "2",
              "--simloops", str(args.simloops),
              "--batch", str(args.batch), "--maxiter", "50",
              "--bps", "4", "--dtype", "bfloat16",
              "--check-rule", "minsum", "--rounds-per-dispatch", "4",
              "--ferr-count-min", "1000000000"]
    for name, extra in CONFIGS:
        out = os.path.join(tempfile.gettempdir(), f"bps4_{name}.csv")
        print(f"=== {name} ===", file=sys.stderr, flush=True)
        with camp.config({"config": name}):
            t0 = time.perf_counter()
            res = camp.cli("sim_reconciliation", common + ["--out", out]
                           + extra)
            camp.emit({"config": name, "csv": out,
                       "wall_s": round(time.perf_counter() - t0, 1),
                       "fer": [r.fer for r in res],
                       "frames_per_s": [r.frames_per_s for r in res]})
    return camp.status()


if __name__ == "__main__":
    sys.exit(main())
