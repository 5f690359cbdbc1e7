"""The knee-quality campaign: five decoders at the knee of the z = 1800
code.

The port's counterpart of the JAX package's ``scripts/run_r5_knee.py``:
the QC(3,6) code of ``--nbv`` block columns (default 36, z = 1800, seed
12345), 1024 frames at 3.5 dB, maxiter 50, the Alternating sign
configuration, early exit off, through the port's ``sim_reconciliation``:

  dense bf16 tanh-F/B with round-to-nearest messages (the control) and
  with stochastically rounded ones (``--sr-messages``); the layered
  schedule in bf16 and in float32; dense float32 (the target).

    python -m qamreconciliation_tpu_torch.scripts.run_r5_knee \\
        [--configs "dense f32,layered bf16"] [--device cuda] > r5_knee.jsonl

``--configs`` keeps the configs whose name holds one of its substrings.
One JSON record a config after the device record; exit 1 when one failed.
"""

import argparse
import os
import sys
import tempfile
import time

from . import _codes
from ._runner import Campaign, add_args, first_row

__all__ = ["GRID", "main"]

# (name, extra argv)
GRID = [
    ("dense bf16 tanhfb RTN (control)",
     ["--dtype", "bfloat16", "--check-phi", "tanhfb"]),
    ("dense bf16 tanhfb SR",
     ["--dtype", "bfloat16", "--check-phi", "tanhfb", "--sr-messages"]),
    ("layered bf16", ["--dtype", "bfloat16", "--schedule", "layered"]),
    ("layered f32", ["--dtype", "float32", "--schedule", "layered"]),
    ("dense f32 (target)", ["--dtype", "float32"]),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_r5_knee")
    ap.add_argument("--nbv", type=int, default=36)
    ap.add_argument("--snr", type=float, default=3.5)
    ap.add_argument("--simloops", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--maxiter", type=int, default=50)
    ap.add_argument("--configs", default="",
                    help="substring filter on config names")
    add_args(ap)
    args = ap.parse_args(argv)

    camp = Campaign("run_r5_knee", args.device)
    code_csv = _codes.qc_ldpc(args.nbv, f"qc{args.nbv}_knee.csv")
    flt = [s for s in args.configs.split(",") if s]
    for name, extra in GRID:
        if flt and not any(s in name for s in flt):
            continue
        out_csv = os.path.join(
            tempfile.gettempdir(),
            "knee_" + name.replace(" ", "_").replace("(", "").replace(
                ")", "") + ".csv",
        )
        with camp.config({"config": name}):
            t0 = time.perf_counter()
            camp.cli("sim_reconciliation", [
                code_csv, "--qc", "--out", out_csv,
                "--snr", str(args.snr), str(args.snr), "--nsnr", "1",
                "--simloops", str(args.simloops),
                "--batch", str(args.batch),
                "--maxiter", str(args.maxiter),
                "--ferr-count-min", "1000000000"] + extra)
            row = first_row(out_csv)
            camp.emit({"config": name, "snr_dB": args.snr,
                       "frames": args.simloops,
                       "fer": row["fer"], "ber": row["ber"],
                       "iters": row["iters"],
                       "wall_s": round(time.perf_counter() - t0, 1)})
    return camp.status()


if __name__ == "__main__":
    sys.exit(main())
