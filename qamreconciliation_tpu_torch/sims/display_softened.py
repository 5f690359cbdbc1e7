"""BER-vs-SNR curves with the computed uncoded symbol-error floor.

Capability parity with reference: sims/display_softened.py:17-86 — plots
``--file CSV LEGEND`` pairs (rate/bit-shifted x axis) against the analytic
uncoded bit-error rate computed from the NoiseMapper's forward transition
matrix and the pairwise Gray bit-error-count table (here the *correct* table;
the reference's is zero for rows >= 2, reference: qamreconciliation/bicm.pyx:56).
"""

import argparse

from ._display import add_output_args, finish, get_pyplot, read_table


def build_parser():
    parser = argparse.ArgumentParser(prog="display_softened")
    parser.add_argument("--bps", type=int, default=1)
    parser.add_argument("--file", nargs=2, action="append", required=True,
                        metavar=("CSV", "LEGEND"))
    parser.add_argument("--title", default="")
    parser.add_argument("--rate", type=float, default=1)
    parser.add_argument("--xlabel", type=str, default="$E_b/N_0$ [dB]")
    parser.add_argument("--ylabel", type=str, default="$p_b$")
    parser.add_argument("--snr-range", type=float, nargs=2, default=[-5, 15])
    parser.add_argument("--nsnr", type=int, default=41)
    add_output_args(parser)
    return parser


def uncoded_ber(bps: int, snrdb_range):
    """Analytic uncoded Gray-label BER over an Es/N0 grid.

    sum_{tx, rx} p(tx) P{rx | tx} * hamming(label_rx, label_tx) / bps
    (reference: sims/display_softened.py:56-68, with the corrected
    error-number table).
    """
    import numpy as np

    from ..models.alphabet import PAMAlphabet
    from ..models.bicm import generate_table_s_to_b, generate_error_number_table
    from ..models.noisemapper import NoiseMapper

    al = PAMAlphabet(bps, 2)
    n_err = generate_error_number_table(generate_table_s_to_b(bps))
    snrdb_range = np.asarray(snrdb_range, np.float64)
    N0 = 10 ** (-snrdb_range / 10) * al.variance

    p_b = np.empty_like(N0)
    for i in range(p_b.size):
        nm = NoiseMapper(al, float(N0[i]), device="cpu")   # host tables
        fwd = nm.fwrd_transition_probability           # [tx, rx]
        p_b[i] = np.sum(al.probabilities[:, None] * fwd * n_err.T)
    return p_b / bps


def main(argv=None):
    import numpy as np

    args = build_parser().parse_args(argv)
    plt = get_pyplot(args)

    rate_bit_shift = -10 * np.log10(args.rate * args.bps)
    for path, legend in args.file:
        df = read_table(path)
        plt.semilogy(df["EsN0dB"] + rate_bit_shift, df["ber"], label=legend)

    snr = np.linspace(args.snr_range[0], args.snr_range[1], args.nsnr)
    plt.semilogy(snr, uncoded_ber(args.bps, snr), linestyle=":",
                 label="Uncoded error rate")

    plt.grid(True, which="both")
    plt.legend(fontsize=12)
    plt.xlabel(args.xlabel, fontsize=14)
    plt.ylabel(args.ylabel, fontsize=14)
    if args.title:
        plt.title(args.title, fontsize=16)
    finish(plt, args)


if __name__ == "__main__":
    main()
