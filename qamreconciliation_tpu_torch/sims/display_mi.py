"""Display mutual-information sweep CSVs.

Capability parity with reference: sims/display_mi.py:17-128 — plots the three
MI estimator columns vs Es/N0 or, with ``--rescalex``, vs the per-curve
rate-rescaled Eb/N0 = EsN0dB - 10*log10(I); optional overlay files.
"""

import argparse

from ._display import add_output_args, finish, get_pyplot, read_table

MI_KEYS = ["I(N,X;Xhat)", "I(X;Xhat)", "I(X;Y)"]
MI_LABELS = {
    "I(N,X;Xhat)": r"$I(\hat{X} \; ; \; X,\; N)$",
    "I(X;Xhat)": r"$I(X;\hat{X})$",
    "I(X;Y)": "$I(X;Y)$",
}


def build_parser():
    parser = argparse.ArgumentParser(
        prog="display_mi", description="Display mutual information file"
    )
    parser.add_argument("file")
    parser.add_argument("--title", default="")
    parser.add_argument("--rescalex", action="store_true",
                        help="x = EsN0dB - 10*log10(I) (Eb/N0 per curve)")
    parser.add_argument("--extra-file", type=str, required=False)
    parser.add_argument("--extra-file-label", type=str, default="extra file")
    add_output_args(parser)
    return parser


def _plot_frame(plt, np, df, rescale, suffix=""):
    for key in MI_KEYS:
        if key not in df:
            continue
        x = df["EsN0dB"]
        if rescale:
            x = x - 10 * np.log10(df[key])
        label = MI_LABELS.get(key, key) + (f" {suffix}" if suffix else "")
        plt.plot(x, df[key], label=label)


def main(argv=None):
    import numpy as np

    args = build_parser().parse_args(argv)
    plt = get_pyplot(args)

    _plot_frame(plt, np, read_table(args.file), args.rescalex)
    if args.extra_file:
        _plot_frame(
            plt, np, read_table(args.extra_file), args.rescalex,
            suffix=args.extra_file_label,
        )

    plt.xlabel("$E_b/N_0$ [dB]" if args.rescalex else "$E_s/N_0$ [dB]")
    plt.ylabel("Mutual information [bit/c.u.]")
    plt.grid(True)
    plt.legend()
    if args.title:
        plt.title(args.title)
    finish(plt, args)


if __name__ == "__main__":
    main()
