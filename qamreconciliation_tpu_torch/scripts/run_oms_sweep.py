"""Min-sum (alpha, beta) grid at the knee of the z = 1800 code, journaled.

The port's counterpart of the JAX package's ``scripts/run_oms_sweep.py``:
the normalized (alpha) and offset (beta) min-sum knobs at the knee points
3.5 and 3.75 dB of the QC(3,6) N = 64800 code, bf16, one JSON line a
(alpha, beta) appended to ``--out``, so that a cut sweep resumes: a pair
already in the file is skipped.  alpha < 1 with beta > 0 is left out (it
penalizes twice): the grid is the beta = 0 column and the pure-offset
alpha = 1 row.  ``--resident`` runs it on the resident min-sum kernel.

    python -m qamreconciliation_tpu_torch.scripts.run_oms_sweep \\
        [--out OUTDIR/oms_grid.jsonl] [--resident] [--device cuda]

The device record goes to stdout, each journal line to stderr too; a
config that fails prints its ``"error"`` record, is not journaled, and the
sweep exits 1 after the rest.
"""

import argparse
import json
import os
import sys
import tempfile

from . import _codes
from ._runner import Campaign, add_args
from ..sims._display import read_table

__all__ = ["grid", "main"]


def grid(alphas, betas):
    """The (alpha, beta) pairs run: beta = 0 or alpha = 1."""
    return [(a, b) for a in alphas for b in betas if b == 0.0 or a == 1.0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_oms_sweep")
    ap.add_argument("--out", default=None,
                    help="the journal (default OUTDIR/oms_grid.jsonl)")
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.75, 13.0 / 16.0, 0.875, 1.0])
    ap.add_argument("--betas", type=float, nargs="+",
                    default=[0.0, 0.15, 0.3, 0.5])
    ap.add_argument("--snr", type=float, nargs=2, default=[3.5, 3.75])
    ap.add_argument("--simloops", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--maxiter", type=int, default=50)
    ap.add_argument("--resident", action="store_true",
                    help="run the grid on the resident min-sum kernel")
    add_args(ap, outdir=True)
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.outdir, "oms_grid.jsonl")

    camp = Campaign("run_oms_sweep", args.device)
    code_csv = _codes.qc_ldpc(36)
    done = set()
    if os.path.exists(out):
        with open(out) as fh:
            for line in fh:
                r = json.loads(line)
                done.add((r["alpha"], r["beta"]))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)

    for a, b in grid(args.alphas, args.betas):
        if (round(a, 6), round(b, 6)) in done:
            print(f"skip alpha={a} beta={b} (journaled)", file=sys.stderr)
            continue
        out_csv = os.path.join(tempfile.gettempdir(),
                               f"oms_{a:.4f}_{b:.4f}.csv")
        argv = [code_csv, "--qc", "--out", out_csv,
                "--snr", str(args.snr[0]), str(args.snr[1]), "--nsnr", "2",
                "--simloops", str(args.simloops),
                "--batch", str(args.batch),
                "--maxiter", str(args.maxiter),
                "--check-rule", "minsum",
                "--minsum-alpha", str(a), "--minsum-beta", str(b),
                "--dtype", "bfloat16"]
        if args.resident:
            argv.append("--resident")
        with camp.config({"alpha": round(a, 6), "beta": round(b, 6)}):
            camp.cli("sim_reconciliation", argv)
            t = read_table(out_csv)
            rec = {"alpha": round(a, 6), "beta": round(b, 6),
                   "resident": bool(args.resident)}
            for snr, fer, ber, iters in zip(t["EsN0dB"], t["fer"], t["ber"],
                                            t["iters"]):
                tag = f"{snr:g}dB"
                rec[f"fer@{tag}"] = float(fer)
                rec[f"ber@{tag}"] = float(ber)
                rec[f"iters@{tag}"] = float(iters)
            with open(out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), file=sys.stderr)
    return camp.status()


if __name__ == "__main__":
    sys.exit(main())
