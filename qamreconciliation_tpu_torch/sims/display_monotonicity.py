"""Compare MI across sign-configurations (monotonicity study).

Capability parity with reference: sims/display_monotonicity.py:17-117 — plots
every data column (from the 3rd on) of a sign-configuration comparison CSV,
optionally against a reference MI file, with per-curve Eb/N0 rescaling.
"""

import argparse

from ._display import add_output_args, finish, get_pyplot, read_table


def build_parser():
    parser = argparse.ArgumentParser(
        prog="display_monotonicity",
        description="Display per-sign-configuration mutual information",
    )
    parser.add_argument("file")
    parser.add_argument("--title", default="")
    parser.add_argument("--rescalex", action="store_true")
    parser.add_argument("--logy", action="store_true")
    parser.add_argument("--reference-file", type=str, required=False)
    parser.add_argument("--extra-file", type=str, required=False)
    add_output_args(parser)
    return parser


def main(argv=None):
    import numpy as np

    args = build_parser().parse_args(argv)
    plt = get_pyplot(args)
    fun = plt.semilogy if args.logy else plt.plot

    def xcol(df, key):
        return (
            df["EsN0dB"] - 10 * np.log10(df[key])
            if args.rescalex
            else df["EsN0dB"]
        )

    def plot_all(df, suffix=""):
        # Skip index + EsN0dB columns: every remaining column is one config.
        for key in list(df)[2:]:
            fun(xcol(df, key), df[key], label=(key + suffix))

    plot_all(read_table(args.file))
    if args.extra_file:
        plot_all(read_table(args.extra_file), suffix=" extra")
    if args.reference_file:
        dfref = read_table(args.reference_file)
        for key, style in [("I(X;Y)", ":"), ("I(X;Xhat)", "-.")]:
            if key in dfref:
                fun(xcol(dfref, key), dfref[key], label=key, linestyle=style)

    plt.xlabel("$E_b/N_0$ [dB]" if args.rescalex else "$E_s/N_0$ [dB]",
               fontsize=18)
    plt.ylabel("Mutual information bits/c.u.", fontsize=18)
    plt.grid(True)
    plt.legend(prop={"size": 10})
    if args.title:
        plt.title(args.title, fontsize=22)
    finish(plt, args)


if __name__ == "__main__":
    main()
