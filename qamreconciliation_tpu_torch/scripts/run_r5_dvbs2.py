"""DVB-S2 construction campaign: three measurements in one process.

The port's counterpart of the JAX package's ``scripts/run_r5_dvbs2.py``,
on the port's ``models/dvbs2`` codes (the structure-exact synthetic
tables):

  ``wf``: the rate-1/2 softening waterfall (full-wrap z = 360 QC base,
     the resident engine with ``--resident-rowgroup 4``, bf16 tanh-F/B)
     -> ``OUTDIR/wf_dvbs2_12.csv``.  One engine: a failure is reported,
     not retried on the dense one;
  ``equiv``: full-wrap QC (kernel 1) against the exact H (the generic
     decoder, kernel 4) at one point on identical seeds;
  ``bsc``: the rate-3/4 BSC sweep -> ``OUTDIR/bsc_dvbs2_34.csv``.

    python -m qamreconciliation_tpu_torch.scripts.run_r5_dvbs2 \\
        [--steps wf,equiv,bsc] [--device cuda] [--outdir DIR] > r5_dvbs2.jsonl

One JSON record a step after the device record; exit 1 when a step failed.
"""

import argparse
import os
import sys
import tempfile
import time

from . import _codes
from ._runner import Campaign, add_args, first_row

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_r5_dvbs2")
    ap.add_argument("--simloops", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--maxiter", type=int, default=50)
    ap.add_argument("--snr", type=float, nargs=2, default=[3.0, 4.25])
    ap.add_argument("--nsnr", type=int, default=6)
    ap.add_argument("--equiv-snr", type=float, default=3.75)
    ap.add_argument("--steps", default="wf,equiv,bsc")
    add_args(ap, outdir=True)
    args = ap.parse_args(argv)

    steps = args.steps.split(",")
    camp = Campaign("run_r5_dvbs2", args.device)
    qc12 = _codes.dvbs2_qc("1/2")
    if "wf" in steps or "bsc" in steps:
        os.makedirs(args.outdir, exist_ok=True)

    if "wf" in steps:
        out_csv = os.path.join(args.outdir, "wf_dvbs2_12.csv")
        with camp.config({"step": "wf_dvbs2_12", "engine": "resident-rg4"}):
            t0 = time.perf_counter()
            camp.cli("sim_reconciliation", [
                qc12, "--qc", "--out", out_csv,
                "--snr", str(args.snr[0]), str(args.snr[1]),
                "--nsnr", str(args.nsnr),
                "--simloops", str(args.simloops),
                "--batch", str(args.batch),
                "--maxiter", str(args.maxiter),
                "--ferr-count-min", "1000000000",
                "--dtype", "bfloat16", "--check-phi", "tanhfb",
                "--resident", "--resident-rowgroup", "4",
            ])
            camp.emit({"step": "wf_dvbs2_12", "csv": out_csv,
                       "engine": "resident-rg4",
                       "wall_s": round(time.perf_counter() - t0, 1)})

    if "equiv" in steps:
        # the same softening protocol at one point, identical engine seeds
        res = {}
        for tag in ("qc_full", "exact_generic"):
            with camp.config() as err:
                code = ([qc12, "--qc"] if tag == "qc_full"
                        else [_codes.dvbs2_exact("1/2")])
                out_csv = os.path.join(tempfile.gettempdir(),
                                       f"dvbs2_equiv_{tag}.csv")
                t0 = time.perf_counter()
                camp.cli("sim_reconciliation", code + [
                    "--dtype", "bfloat16", "--check-phi", "tanhfb",
                    "--out", out_csv,
                    "--snr", str(args.equiv_snr), str(args.equiv_snr),
                    "--nsnr", "1", "--simloops", str(args.simloops),
                    "--batch", str(args.batch),
                    "--maxiter", str(args.maxiter),
                    "--ferr-count-min", "1000000000",
                ])
                row = first_row(out_csv)
                res[tag] = {"fer": row["fer"], "ber": row["ber"],
                            "iters": row["iters"],
                            "wall_s": round(time.perf_counter() - t0, 1)}
            if err:
                res[tag] = err
        camp.emit({"step": "wrap_equivalence", "snr_dB": args.equiv_snr,
                   **res})

    if "bsc" in steps:
        out_csv = os.path.join(args.outdir, "bsc_dvbs2_34.csv")
        with camp.config({"step": "bsc_dvbs2_34"}):
            qc34 = _codes.dvbs2_qc("3/4")
            t0 = time.perf_counter()
            camp.cli("sim_bsc", [
                qc34, "--qc", "--out", out_csv,
                "--rber", "0.010", "0.040", "--rpoints", "7",
                "--simloops", str(args.simloops),
                "--batch", str(args.batch), "--maxiter", str(args.maxiter),
                "--minerr", "1000000000",
                "--dtype", "bfloat16",
            ])
            camp.emit({"step": "bsc_dvbs2_34", "csv": out_csv,
                       "wall_s": round(time.perf_counter() - t0, 1)})
    return camp.status()


if __name__ == "__main__":
    sys.exit(main())
