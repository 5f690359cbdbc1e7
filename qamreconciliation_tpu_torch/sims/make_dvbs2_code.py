"""Generate DVB-S2 LDPC code files (models/dvbs2.py) for the sweep CLIs.

The port's counterpart of the JAX package's ``scripts/make_dvbs2_code.py``,
built on the port's own ``models/dvbs2`` and ``utils/edgefile`` (no JAX);
it writes byte-identical files.

Writes, per rate:
  dvbs2_<rate>_exact.csv — the exact expanded H edge list (blocked
      quasi-cyclic ordering; reference CSV format eid,cid,vid with the
      first-row totals convention) — consumable by every CLI's generic
      path, e.g.
      ``python -m qamreconciliation_tpu_torch.sims.sim_bsc
      dvbs2_34_exact.csv``
  dvbs2_<rate>_qc.csv — the full-wrap QC base-edge CSV (z=360) for the
      ``--qc`` fast paths (one extra edge vs the exact H; see
      models/dvbs2.to_qc_base).

The tables are the structure-exact SYNTHETIC ones unless --annex-b FILE
provides the standard's real rows (one whitespace row per bit-group).

Usage:
    python -m qamreconciliation_tpu_torch.sims.make_dvbs2_code --rate 1/2 \
        --rate 3/4 --out-dir codes
"""

import argparse
import os

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="make_dvbs2_code")
    ap.add_argument("--rate", action="append", default=None,
                    choices=["1/2", "2/3", "3/4", "5/6"])
    ap.add_argument("--n", type=int, default=64800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--annex-b", default=None,
                    help="path to a file with the standard's Annex B rows "
                    "for --rate (exactly one rate then)")
    args = ap.parse_args(argv)
    rates = args.rate or ["1/2", "3/4"]

    from ..models.dvbs2 import (
        Z, expanded_edges, make_table, parse_address_table, to_qc_base,
    )
    from ..models.qc_decoder import save_qc_csv
    from ..utils.edgefile import save_edge_csv

    os.makedirs(args.out_dir, exist_ok=True)
    for rate in rates:
        if args.annex_b:
            if len(rates) != 1:
                raise SystemExit("--annex-b covers exactly one --rate")
            num, den = map(int, rate.split("/"))
            with open(args.annex_b) as f:
                t = parse_address_table(
                    f.read(), n=args.n, k=args.n * num // den
                )
        else:
            t = make_table(rate, n=args.n, seed=args.seed)
        tag = rate.replace("/", "")
        vid, cid = expanded_edges(t)
        p1 = os.path.join(args.out_dir, f"dvbs2_{tag}_exact.csv")
        save_edge_csv(p1, vid, cid)
        base = to_qc_base(t, wrap="full")
        p2 = os.path.join(args.out_dir, f"dvbs2_{tag}_qc.csv")
        save_qc_csv(p2, base, Z)
        print(f"{rate}: N={t.n} K={t.k} q={t.q} rows={len(t.rows)} "
              f"({t.source}) -> {p1}, {p2}")


if __name__ == "__main__":
    main()
