"""BSC sweep curves vs the Shannon-limit locus.

Capability parity with reference: sims/display_bsc.py:17-61 — BER vs raw
flipping probability for one or more sweep CSVs, against the root-solved
Shannon limit ``h2(p_b) = 1 - (1 - h2(f))/R`` and the no-code identity line.
Input files are arguments (the reference hardcodes its experiment CSVs).
"""

import argparse

from ._display import (
    add_output_args, binary_entropy, finish, get_pyplot, read_table,
)


def build_parser():
    parser = argparse.ArgumentParser(prog="display_bsc")
    parser.add_argument("--file", nargs=2, action="append", required=True,
                        metavar=("CSV", "LEGEND"))
    parser.add_argument("--rate", type=float, default=0.75,
                        help="Code rate R for the Shannon-limit curve")
    parser.add_argument("--title", default="")
    parser.add_argument("--ber-range", type=float, nargs=2, default=[0.01, 0.1])
    add_output_args(parser)
    return parser


def shannon_limit_bsc(rate: float, ber_range, n: int = 91):
    """Smallest acceptable residual BER p_b per raw flip probability f.

    For each target p_b, root-solve ``h2(p_b) - 1 + (1 - h2(f))/R = 0`` for f
    (reference: sims/display_bsc.py:13-17, 26-37): a code of rate R can reach
    residual BER p_b only if the channel flip probability is below the root.
    """
    import numpy as np
    from scipy.optimize import brentq

    def phi_root_locus(f, p_b, R):
        return float(binary_entropy(p_b) - 1 + (1 - binary_entropy(f)) / R)

    p_b_grid = np.linspace(ber_range[0], ber_range[1], n)
    f_grid = np.empty_like(p_b_grid)
    for i, p_b in enumerate(p_b_grid):
        try:
            f_grid[i] = brentq(phi_root_locus, a=1e-12, b=0.5, args=(p_b, rate))
        except ValueError:
            f_grid[i] = 0.0
    return f_grid, p_b_grid


def main(argv=None):
    import numpy as np

    args = build_parser().parse_args(argv)
    plt = get_pyplot(args)

    for path, legend in args.file:
        df = read_table(path)
        xkey = "f" if "f" in df else "epsilon"
        plt.semilogy(df[xkey], df["ber"], marker="x", label=legend)

    f_grid, p_b_grid = shannon_limit_bsc(args.rate, args.ber_range)
    plt.semilogy(f_grid, p_b_grid, linestyle="-.", label="Shannon limit")

    identity = 10 ** np.linspace(-5, -1, 41)
    plt.semilogy(identity, identity, label="No code")

    plt.grid(True)
    plt.legend()
    plt.xlabel("$f$")
    plt.ylabel("Codeword BER $p_b$")
    plt.title(args.title or f"BER vs flipping probability, rate {args.rate}")
    finish(plt, args)


if __name__ == "__main__":
    main()
