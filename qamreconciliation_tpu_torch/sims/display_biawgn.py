"""BI-AWGN sweep curves vs channel limits.

Capability parity with reference: sims/display_biawgn.py:17-73 — BER vs Es/N0
for one or more sweep CSVs against the uncoded BPSK error rate and the
root-solved Shannon limit from the BI-AWGN symmetric capacity approximation.
Input files are arguments (the reference hardcodes its experiment CSVs).
"""

import argparse

from ._display import (
    add_output_args, binary_entropy, finish, get_pyplot, read_table,
)


def build_parser():
    parser = argparse.ArgumentParser(prog="display_biawgn")
    parser.add_argument("--file", nargs=2, action="append", required=True,
                        metavar=("CSV", "LEGEND"))
    parser.add_argument("--rate", type=float, default=0.5)
    parser.add_argument("--title", default="")
    parser.add_argument("--snr-range", type=float, nargs=2, default=[-10, 10])
    parser.add_argument("--shannon", action="store_true",
                        help="Also draw the Shannon-limit locus")
    parser.add_argument("--shift", type=float, default=0.0,
                        help="Add this many dB to each file's x axis "
                        "(the reference shifts info-bit curves by +3 dB)")
    add_output_args(parser)
    return parser


def biawgn_capacity(snr):
    """Symmetric capacity of BI-AWGN at Es/N0 = snr (linear), in bits.

    Closed-form approximation used by the reference
    (reference: sims/display_biawgn.py:14-24).
    """
    import numpy as np
    from scipy.special import erfc

    snr = np.asarray(snr, np.float64)
    sqsnr = np.sqrt(snr)
    expsnr = np.exp(-snr)
    invsqpi = 1 / np.sqrt(np.pi)
    invlog2 = 1 / np.log(2)
    return (
        1
        - 2 * sqsnr * invlog2 * (expsnr * invsqpi - sqsnr * erfc(sqsnr))
        - expsnr / (1 + 2 * sqsnr * invsqpi * invlog2)
    )


def shannon_limit_biawgn(rate: float, snr_range, n: int = 201):
    """Smallest achievable p_b per SNR: root of h2(p_b) - 1 + C(snr)/R."""
    import numpy as np
    from scipy.optimize import brentq

    def phi_root_locus(p_b, snr, R):
        return float(binary_entropy(p_b) - 1 + biawgn_capacity(snr) / R)

    snr_grid = np.linspace(snr_range[0], snr_range[1], n)
    p_acceptable = np.zeros_like(snr_grid)
    for i, s in enumerate(snr_grid):
        try:
            p_acceptable[i] = brentq(
                phi_root_locus, a=1e-12, b=0.5 - 1e-12,
                args=(10 ** (s / 10), rate),
            )
        except ValueError:
            p_acceptable[i] = 0.0
    return snr_grid, p_acceptable


def main(argv=None):
    import numpy as np
    from scipy.special import erf

    args = build_parser().parse_args(argv)
    plt = get_pyplot(args)

    for path, legend in args.file:
        df = read_table(path)
        xkey = "EsN0dB" if "EsN0dB" in df else "EbN0dB"
        plt.semilogy(df[xkey] + args.shift, df["ber"], marker="x", label=legend)

    snr_grid = np.linspace(args.snr_range[0], args.snr_range[1], 201)
    plt.semilogy(
        snr_grid,
        0.5 * (1 - erf(np.sqrt(10 ** (snr_grid / 10) / 2))),
        label="No code",
    )
    if args.shannon:
        sg, pa = shannon_limit_biawgn(args.rate, args.snr_range)
        plt.semilogy(sg, pa, linestyle=":", label="Shannon limit")

    plt.grid(True, which="both")
    plt.legend()
    plt.xlabel("$E_s/N_0$ [dB]")
    plt.ylabel("Codeword BER $p_b$")
    plt.title(args.title or f"BER vs SNR, rate {args.rate}")
    finish(plt, args)


if __name__ == "__main__":
    main()
