"""The JAX package's own FERs at the mode quality watches, on the CPU.

Three 1024-frame points, each through the JAX package's CLI on the dense
QC path, maxiter 50, early exit off:

  hard    sim_reconciliation --hard on the DVB-S2 rate-1/2 full-wrap QC code
          (models/dvbs2.to_qc_base(make_table("1/2", seed=0), wrap="full"),
          z = 360), --dtype bfloat16 --check-phi tanhfb (the configuration
          of docs/img/wf_dvbs2_12_hard.csv);
  direct  the same with --direct (docs/img/wf_dvbs2_12_direct.csv);
  bsc     sim_bsc on the rate-3/4 full-wrap code, --dtype bfloat16
          (docs/img/bsc_dvbs2_34.csv).

chip_smoke.py holds the PyTorch port's CLIs to these figures.  One JSON
line per point on stdout.

Usage: JAX_PLATFORMS=cpu python scripts/run_mode_watches_cpu.py
           [--watches hard:4.5,direct:3.0,bsc:0.0275]
"""

import argparse
import csv
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--watches", default="hard:4.5,direct:3.0,bsc:0.0275",
                    help="comma-separated MODE:POINT (dB, or raw BER for bsc)")
    ap.add_argument("--simloops", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--maxiter", type=int, default=50)
    args = ap.parse_args()

    import jax

    if os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from qamreconciliation_tpu.models.dvbs2 import Z, make_table, to_qc_base
    from qamreconciliation_tpu.models.qc_decoder import save_qc_csv
    from qamreconciliation_tpu.sims import sim_bsc, sim_reconciliation

    tmp = tempfile.mkdtemp()
    codes = {}
    for rate in ("1/2", "3/4"):
        path = os.path.join(tmp, f"dvbs2_{rate.replace('/', '')}_qc.csv")
        save_qc_csv(path, to_qc_base(make_table(rate, seed=0), wrap="full"),
                    Z)
        codes[rate] = path
    common = ["--simloops", str(args.simloops), "--batch", str(args.batch),
              "--maxiter", str(args.maxiter)]
    for watch in args.watches.split(","):
        mode, point = watch.split(":")
        out = os.path.join(tmp, f"{mode}.csv")
        t0 = time.perf_counter()
        if mode == "bsc":
            sim_bsc.main([codes["3/4"], "--qc", "--out", out, "--rber",
                          point, point, "--rpoints", "1", "--minerr",
                          "1000000000", "--dtype", "bfloat16", *common])
        else:
            sim_reconciliation.main([
                codes["1/2"], "--qc", f"--{mode}", "--out", out, "--snr",
                point, point, "--nsnr", "1", "--ferr-count-min",
                "1000000000", "--dtype", "bfloat16", "--check-phi",
                "tanhfb", *common])
        with open(out) as f:
            row = list(csv.DictReader(f))[0]
        print(json.dumps({
            "mode": mode, "point": float(point), "fer": float(row["fer"]),
            "ber": float(row["ber"]), "iters": float(row["iters"]),
            "frames": args.simloops, "backend": jax.default_backend(),
            "wall_s": round(time.perf_counter() - t0, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
