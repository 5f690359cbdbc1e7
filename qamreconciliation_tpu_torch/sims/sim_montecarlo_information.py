"""Monte-Carlo mutual-information sweep CLI.

    python -m qamreconciliation_tpu_torch.sims.sim_montecarlo_information
        [--out out.csv] [--snr -20 20] [--nsnr 401] [--bps 2]
        [--niters 256] [--samples-per-iter 4096] [--mc-ginv poly|interp]
        [--dtype float32|float64] [--seed 0] [--resume] [--gnuplot]
        [--display] [--device cuda]

Mirrors the reference (reference: sims/sim_montecarlo_information.py):
columns ``EsN0dB,I(X;Xhat),I(X;Y),I(N,X;Xhat)`` after an unnamed index
column; optional gnuplot script / matplotlib display.  Reference sign
conventions preserved (see models/mutual_information.py).
"""

import argparse

import numpy as np
import torch

from ..models.alphabet import PAMAlphabet
from ..models.mutual_information import P_xhat, montecarlo_information
from ..models.noisemapper import NoiseMapper
from ..utils.checkpoint import SweepState
from .common import pyplot, write_table

__all__ = ["build_parser", "main", "COLUMNS"]

COLUMNS = ["EsN0dB", "I(X;Xhat)", "I(X;Y)", "I(N,X;Xhat)"]


def build_parser():
    parser = argparse.ArgumentParser(
        prog="mutual_information_base_scheme",
        description="Evaluate mutual information vs SNR of the base scheme",
    )
    parser.add_argument("--out", default="out.csv")
    parser.add_argument("--snr", type=float, nargs=2, default=[-20, 20])
    parser.add_argument("--nsnr", type=int, default=401)
    parser.add_argument("--bps", type=int, default=2)
    parser.add_argument("--niters", type=int, default=1 << 8)
    parser.add_argument("--samples-per-iter", type=int, default=1 << 12)
    parser.add_argument("--display", action="store_true")
    parser.add_argument("--gnuplot", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--mc-ginv", choices=["poly", "interp"], default="poly",
        help="Candidate-inverse reconstruction inside the I(X,N;Xhat) "
        "estimator: 'poly' (Chebyshev fit of the inverse CDF, deviation "
        "~3e-4, far below MC noise) or 'interp' (the reference's g_inv "
        "grid interpolation)",
    )
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "float64"])
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the estimator (cuda or cpu)")
    return parser


def main(argv=None):
    """Run the sweep; returns the CSV's rows (point, three estimates)."""
    args = build_parser().parse_args(argv)
    EsN0dB = np.linspace(args.snr[0], args.snr[1], args.nsnr)
    state = SweepState(args.out, resume=args.resume)

    pa = PAMAlphabet(args.bps, 2)
    Es = pa.variance
    rows = []
    for i, esn0db in enumerate(EsN0dB):
        prev = state.done(esn0db)
        if prev is not None:
            rows.append((prev["point"], prev["ixxh"], prev["ixy"],
                         prev["ixnxh"]))
            continue
        N0 = Es * (10 ** (-esn0db / 10)) / 2
        nm = NoiseMapper(pa, N0, dtype=args.dtype, device=args.device)
        if args.mc_ginv == "poly":
            nm._ensure_ginv_poly()
        p_Xhat = P_xhat(nm)
        gen = torch.Generator(device=args.device).manual_seed(
            args.seed + 7919 * i)
        # iterations folded into fewer, larger estimator calls (the same
        # sample-mean estimator), at most 2^21 samples a call
        chunk_iters = max(1, min(args.niters,
                                 (1 << 21) // args.samples_per_iter))
        acc = np.zeros(3)
        done_iters = 0
        while done_iters < args.niters:
            take = min(chunk_iters, args.niters - done_iters)
            acc += take * np.asarray(montecarlo_information(
                gen, pa, nm, p_Xhat, args.samples_per_iter * take,
                ginv_mode=args.mc_ginv))
            done_iters += take
        acc /= args.niters
        state.record(esn0db, dict(ixxh=acc[0], ixy=acc[1], ixnxh=acc[2]))
        rows.append((float(esn0db), acc[0], acc[1], acc[2]))

    write_table(args.out, COLUMNS, rows)
    state.cleanup()

    if args.gnuplot:
        # the script text is an output-artifact spec reproduced verbatim
        # (reference: sims/sim_montecarlo_information.py:80-94)
        gnuplot_script = f"""
        set datafile separator ","
        set xlabel "E_b/N_0 [dB]"
        set ylabel "I(X, N ; \\hat{{X}}) [bit/c.u.]"
        set grid

        plot '{args.out}' using 2:5 with lines title "I(X,N;Xhat)", \\
             '{args.out}' using 2:3 with lines title "I(X;Xhat)", \\
             '{args.out}' using 2:4 with lines title "I(X;Y)"

        """
        with open(f"{args.out}.gnuplot", "w") as f:
            f.write(gnuplot_script)

    plt = pyplot() if args.display else None
    if plt is not None:
        snr, ixxh, ixy, ixnxh = (list(c) for c in zip(*rows))
        plt.plot(snr, ixnxh, label=r"$I(\hat{X} \; ; \; X,\; N)$")
        plt.plot(snr, ixxh, label=r"$I(X;\hat{X})$")
        plt.plot(snr, ixy, label="$I(X;Y)$")
        plt.xlabel("$E_b/N_0$ [dB]")
        plt.grid("both")
        plt.legend()
        plt.show()
    return rows


if __name__ == "__main__":
    main()
