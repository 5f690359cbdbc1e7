"""Analytic (quad) mutual-information sweep CLI.

    python -m qamreconciliation_tpu_torch.sims.sim_mutual_information_base_scheme
        [--out out.csv] [--snr 0 5] [--nsnr 11] [--bps 2] [--resume]
        [--gnuplot] [--display] [--device cuda]

Mirrors the reference (reference: sims/sim_mutual_information_base_scheme.py):
per SNR point computes I(X,N;Xhat) (quad over n), I(X;Xhat), I(X;Y) and the
Eb/N0 rescalings ``esn0db - 10*log10(I)``; CSV columns preserved.  The
estimators run on the host in float64; ``--device`` is where the mapper's
tables live.
"""

import argparse

import numpy as np

from ..models.alphabet import PAMAlphabet
from ..models.mutual_information import (
    P_xhat,
    mutual_information_base_scheme,
    mutual_information_X_Xhat,
    mutual_information_X_Y,
)
from ..models.noisemapper import NoiseMapper
from ..utils.checkpoint import SweepState
from .common import pyplot, write_table

__all__ = ["build_parser", "main", "COLUMNS"]

COLUMNS = ["EsN0dB", "EbN0dB base", "I(N,X;Xhat)", "EbN0dB X;Xhat",
           "I(X;Xhat)", "EbN0dB X;Y", "I(X;Y)"]


def build_parser():
    parser = argparse.ArgumentParser(
        prog="mutual_information_base_scheme",
        description="Evaluate mutual information vs SNR of the base scheme",
    )
    parser.add_argument("--out", default="out.csv")
    parser.add_argument("--snr", type=float, nargs=2, default=[0, 5])
    parser.add_argument("--nsnr", type=int, default=11)
    parser.add_argument("--bps", type=int, default=2)
    parser.add_argument("--display", action="store_true")
    parser.add_argument("--gnuplot", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the mapper's tables (cuda or "
                        "cpu)")
    return parser


def main(argv=None):
    """Run the sweep; returns the CSV's rows."""
    args = build_parser().parse_args(argv)
    EsN0dB = np.linspace(args.snr[0], args.snr[1], args.nsnr)
    state = SweepState(args.out, resume=args.resume)

    rows = []
    for esn0db in EsN0dB:
        prev = state.done(esn0db)
        if prev is not None:
            rows.append(tuple(prev["row"]))
            continue
        pa = PAMAlphabet(args.bps, 2)
        Es = pa.variance
        N0 = Es * (10 ** (-esn0db / 10)) / 2
        nm = NoiseMapper(pa, N0, dtype="float64", device=args.device)
        p_Xhat = P_xhat(nm)

        I_base = mutual_information_base_scheme(nm, p_Xhat)
        I_xxh = mutual_information_X_Xhat(nm, p_Xhat)
        I_xy = mutual_information_X_Y(nm)
        row = (
            float(esn0db),
            float(esn0db - 10 * np.log10(I_base)),
            I_base,
            float(esn0db - 10 * np.log10(I_xxh)),
            I_xxh,
            float(esn0db - 10 * np.log10(I_xy)),
            I_xy,
        )
        state.record(esn0db, dict(row=list(row)))
        rows.append(row)

    write_table(args.out, COLUMNS, rows)
    state.cleanup()

    if args.gnuplot:
        # the script text is an output-artifact spec reproduced verbatim
        # (reference: sims/sim_mutual_information_base_scheme.py:80-94)
        gnuplot_script = f"""
        set datafile separator ","
        set xlabel "E_b/N_0 [dB]"
        set ylabel "I(X, N ; \\hat{{X}}) [bit/c.u.]"
        set grid

        plot '{args.out}' using 3:4 with lines title "I(X,N;Xhat)", \\
             '{args.out}' using 5:6 with lines title "I(X;Xhat)", \\
             '{args.out}' using 7:8 with lines title "I(X;Y)"

        """
        with open(f"{args.out}.gnuplot", "w") as f:
            f.write(gnuplot_script)

    plt = pyplot() if args.display else None
    if plt is not None:
        cols = [list(c) for c in zip(*rows)]
        plt.plot(cols[1], cols[2], label=r"$I(\hat{X} \; ; \; X,\; N)$")
        plt.plot(cols[3], cols[4], label=r"$I(X;\hat{X})$")
        plt.plot(cols[5], cols[6], label="$I(X;Y)$")
        plt.xlabel("$E_b/N_0$ [dB]")
        plt.grid("both")
        plt.legend()
        plt.show()
    return rows


if __name__ == "__main__":
    main()
